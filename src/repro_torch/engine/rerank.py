"""Exact re-ranking stage (counterpart of ``repro.engine.rerank``).

``finalize_candidates`` is stages 3+4 of the pipeline: the top ``r·k``
quantized candidates are refined with true distances by one of
``kernels.ops.RERANK_IMPLS``: 'gathered' (``exact_rerank``: the candidate
rows gathered to a (Q, R, D) copy, norms+GEMM in plain torch), 'stream'
(the re-rank kernel K2, which reads the rows in place) or 'auto' (the
autotuner's verdict between the two).
"""
from __future__ import annotations

import torch

from repro_torch.core import topk as topk_mod
from repro_torch.core.lists import base_norms
from repro_torch.kernels import ops
from repro_torch.kernels.rerank_kernel import norms_gemm_dists


def exact_distances(base: torch.Tensor, q: torch.Tensor,
                    cand_ids: torch.Tensor,
                    norms: torch.Tensor | None = None) -> torch.Tensor:
    """True squared L2 from each query to its candidates, via norms+GEMM:
    base (N, D), q (Q, D), cand_ids (Q, R) i32 (-1 = padding) -> (Q, R) f32
    with +inf at padded slots."""
    if norms is None:
        norms = base_norms(base)
    safe = torch.clamp_min(cand_ids, 0).long()
    d = norms_gemm_dists(q, base[safe], norms[safe])
    return torch.where(cand_ids >= 0, d, torch.inf)


def exact_rerank(base: torch.Tensor, q: torch.Tensor, cand_ids: torch.Tensor,
                 k: int, *, norms: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Re-rank candidates by true distance and keep the best k (gathered):
    (dists (Q, k) f32 ascending, ids (Q, k) i32, -1 past the valid count)."""
    d = exact_distances(base, q, cand_ids, norms)
    vals, pos = topk_mod.masked_topk(d, cand_ids >= 0, k)
    return vals, topk_mod.gather_ids(cand_ids, pos)


def finalize_candidates(flat_d: torch.Tensor, flat_ids: torch.Tensor,
                        base: torch.Tensor | None, q: torch.Tensor, k: int,
                        r: int, *, norms: torch.Tensor | None = None,
                        rerank_impl: str = "gathered"
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Optional exact re-rank of one candidate pool, then the final top-k.

    flat_d/flat_ids: (Q, C) quantized candidate distances/ids (-1 = pad).
    r > 0 refines the top ``rr = min(r*k, C)`` candidates with true
    distances from ``base`` through ``rerank_impl`` ('gathered' | 'stream'
    | 'auto'); r == 0 takes the top k of the pool as is.
    Returns (dists (Q, k), ids (Q, k), reranked (Q,) i32 work counter).
    """
    if r:
        rr = min(r * k, flat_d.shape[1])
        _, pos = topk_mod.masked_topk(flat_d, flat_ids >= 0, rr)
        cand_ids = topk_mod.gather_ids(flat_ids, pos)
        impl, tile_r = ops.resolve_rerank_dispatch(
            rerank_impl, flat_d.shape[0], rr, q.shape[-1], k, base.shape[0],
            device=base.device)
        if norms is None:
            norms = base_norms(base)
        if impl == "stream":
            vals, out_ids = ops.rerank_stream_topk(base, norms, q, cand_ids,
                                                   k=k, tile_r=tile_r)
        else:
            vals, out_ids = exact_rerank(base, q, cand_ids, k, norms=norms)
        reranked = torch.sum(cand_ids >= 0, dim=1, dtype=torch.int32)
    else:
        vals, pos = topk_mod.masked_topk(flat_d, flat_ids >= 0, k)
        out_ids = topk_mod.gather_ids(flat_ids, pos)
        reranked = torch.zeros((flat_d.shape[0],), dtype=torch.int32,
                               device=flat_d.device)
    return vals, out_ids, reranked
