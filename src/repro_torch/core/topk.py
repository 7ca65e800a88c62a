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


def gather_ids(ids: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Map masked_topk positions back to ids, preserving the -1 sentinel.

    ids: (Q, N); pos: (Q, k) (-1 = no candidate).
    """
    got = torch.gather(ids, -1, torch.clamp_min(pos, 0).long())
    return torch.where(pos >= 0, got, -1)
