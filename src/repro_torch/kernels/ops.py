"""Dispatch wrappers around the port's kernels (counterpart of
``repro.kernels.ops``): tile choice, padding and the impl registries.

Only the stream impls are ported. ``SCAN_IMPLS`` / ``RERANK_IMPLS`` hold
exactly what exists; any other impl name raises instead of being replaced
by a silent substitute (the gathered impls, 'auto' and the autotuner are
ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import torch

from repro_torch.core import topk as topk_mod
from repro_torch.kernels import fastscan_kernel as fk
from repro_torch.kernels import rerank_kernel as rk

SCAN_IMPLS = ("stream",)
RERANK_IMPLS = ("stream",)


def check_impl(kind: str, impl: str) -> None:
    """Raise ``ValueError`` for an impl the port does not have."""
    known = SCAN_IMPLS if kind == "scan" else RERANK_IMPLS
    if impl not in known:
        raise ValueError(
            f"{kind} impl {impl!r} is not ported; the port has {known} "
            "(the other impls and 'auto' are ROADMAP Queue 1 item 9)")


def _stream_tile(cap: int, tile_n: int = 0) -> int:
    """A cap tile that DIVIDES cap (the store is scanned in place): honour
    ``tile_n`` when it divides cap, else the largest power-of-two divisor
    <= TILE_N (floor 8), else cap itself (one tile per list)."""
    if tile_n and cap % tile_n == 0:
        return tile_n
    t = fk.TILE_N
    while t >= 8:
        if cap % t == 0:
            return t
        t //= 2
    return cap


def _rerank_tile(r: int, tile_r: int = 0) -> int:
    """Candidate-chunk size: an explicit ``tile_r``, else the smallest power
    of two >= min(r, TILE_R) (floor 8); ids are padded with -1."""
    if tile_r:
        return tile_r
    return max(8, min(rk.TILE_R, 1 << max(r - 1, 1).bit_length()))


def _pad_to(x: torch.Tensor, dim: int, mult: int, value: int = 0
            ) -> torch.Tensor:
    pad = (-x.shape[dim]) % mult
    if pad == 0:
        return x
    widths = [0, 0] * (x.ndim - dim % x.ndim)
    widths[-1] = pad
    return torch.nn.functional.pad(x, widths, value=value)


def fastscan_stream_topk(table_q8: torch.Tensor, list_codes: torch.Tensor,
                         probe_ids: torch.Tensor, sizes: torch.Tensor, *,
                         keep: int, tile_n: int = 0,
                         filter_bits: torch.Tensor | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather-free scan + fused candidate reduction over an in-place store.

    Each cap tile keeps its ``kc = max(1, min(keep, tile))`` smallest
    entries, so any final selection of <= ``keep`` candidates per query is
    exact. ``filter_bits`` (nlist, W) u8 masks rows whose bit is 0 before
    selection; the kernel reads it in place by list id. Returns
    (vals (G, n_tiles, kc) i32, slots (G, n_tiles, kc) i32, -1 = absent).
    """
    cap = list_codes.shape[1]
    tn = _stream_tile(cap, tile_n)
    kc = max(1, min(keep, tn))
    fb = None if filter_bits is None else filter_bits.to(torch.uint8).contiguous()
    return fk.fastscan_stream_topk_grouped(
        table_q8.contiguous(), list_codes, probe_ids.to(torch.int32).contiguous(),
        sizes.to(torch.int32).contiguous(), kc=kc, tile_n=tn, filter_bits=fb)


def rerank_stream_topk(base: torch.Tensor, norms: torch.Tensor,
                       q: torch.Tensor, cand_ids: torch.Tensor, *, k: int,
                       tile_r: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather-free exact re-rank over the in-place base.

    base (N, D) f32; norms (N,) f32 = ``core.lists.base_norms(base)``;
    q (Q, D) f32; cand_ids (Q, R) i32, -1 = padding. Returns
    (vals (Q, k) f32 ascending, ids (Q, k) i32, -1 = absent).
    """
    qq, r = cand_ids.shape
    tr = _rerank_tile(r, tile_r)
    cand_p = _pad_to(cand_ids.to(torch.int32), 1, tr, value=-1).contiguous()
    # only the candidates' norms are gathered up front: (Q, Rp) f32
    xn = norms[torch.clamp_min(cand_p, 0).long()].contiguous()
    vals, pos = rk.rerank_stream_topk(base, q.contiguous(), cand_p, xn, k=k,
                                      tile_r=tr)
    return vals, topk_mod.gather_ids(cand_p, pos)
