"""Top-k selection with the reference's tie order
(counterpart of ``repro.core.topk``).

The reference relies on ``jax.lax.top_k`` putting the LOWEST index first
among equal values, and the stream kernels rebuild that order inside their
selections. ``torch.topk`` does not keep it, and quantized ADC sums tie all
the time, so every selection here is a stable ascending sort: equal values
keep their index order.

Conventions: distances float32 ascending on return; ids/positions int32;
-1 = no candidate (distance +inf).
"""
from __future__ import annotations

import torch


def smallest_k(dists: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., N) -> (vals (..., k), ids (..., k) int32) ascending by distance,
    lowest index first among equal values."""
    if k > dists.shape[-1]:
        raise ValueError(f"k={k} exceeds the {dists.shape[-1]} entries")
    vals, idx = torch.sort(dists, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def masked_topk(dists: torch.Tensor, valid: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over entries where valid; invalid slots return inf/-1."""
    d = torch.where(valid, dists, torch.inf)
    vals, idx = smallest_k(d, k)
    return vals, torch.where(torch.isfinite(vals), idx, -1)


def margin_prune_probes(vals: torch.Tensor, probes: torch.Tensor, tau
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Adaptive-nprobe mask: drop probes outside the per-query margin.

    vals: (Q, P) coarse centroid distances aligned with probes (Q, P);
    slots already -1 must carry +inf vals. A probe survives iff its distance
    is within ``(1 + tau) * d0`` of the query's best probed centroid ``d0``.
    ``tau`` is a scalar or (Q,), f32; ``tau = +inf`` keeps every probe
    (guarded explicitly so ``d0 == 0`` never turns ``0 * inf`` into NaN),
    and the best probe always survives whatever tau is.

    Returns (probes with pruned slots set to -1, per-query pruned count).
    """
    tau = torch.as_tensor(tau, dtype=torch.float32, device=vals.device)
    if tau.ndim == 1:
        tau = tau[:, None]
    present = probes >= 0
    d = torch.where(present, vals, torch.inf)
    d0 = torch.amin(d, dim=1, keepdim=True)
    keep = (d <= d0 * (1.0 + tau)) | torch.isposinf(tau) | (d <= d0)
    pruned = torch.sum(present & ~keep, dim=1, dtype=torch.int32)
    return torch.where(keep, probes, -1), pruned


def gather_ids(ids: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Map masked_topk positions back to ids, preserving the -1 sentinel.

    ids: (Q, N); pos: (Q, k) (-1 = no candidate).
    """
    got = torch.gather(ids, -1, torch.clamp_min(pos, 0).long())
    return torch.where(pos >= 0, got, -1)
