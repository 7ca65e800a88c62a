"""Batched Lloyd's k-means in PyTorch (counterpart of ``repro.core.kmeans``).

Used for PQ codebook training (batched over sub-spaces) and for the IVF
coarse centroids. Fixed iteration count; empty clusters are re-seeded from
random data rows. All randomness comes from a caller-supplied
``torch.Generator`` (a CPU generator; draws are moved to the data's device),
so a build is reproducible from its seed -- but not equal to the JAX
build's, whose ``jax.random`` stream torch cannot reproduce.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class KMeansResult(NamedTuple):
    centroids: torch.Tensor    # (..., k, d)
    assignments: torch.Tensor  # (..., n) int32
    inertia: torch.Tensor      # (...,) float32 -- sum of squared distances


def pairwise_sqdist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances (..., n, k) between rows of x (..., n, d) and
    c (..., k, d), via ``x2 - 2·(x@cᵀ) + c2`` clamped at 0 (the reference's
    expansion and operation order). The product is a plain f32 matmul
    (TF32 is off, see the package docstring)."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    c2 = torch.sum(c * c, dim=-1)
    # clamp: the expansion can go slightly negative in float32
    d = x2 - 2.0 * (x @ c.transpose(-1, -2)) + c2.unsqueeze(-2)
    return torch.clamp_min(d, 0.0)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (b, n, d), idx (b, k) -> (b, k, d)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def kmeans_multi(x: torch.Tensor, k: int, iters: int = 25, *,
                 generator: torch.Generator) -> KMeansResult:
    """Independent k-means per leading batch entry: x (b, n, d) -> (b, k, d).

    The PQ training primitive (one k-means per sub-space), written as one
    batched computation instead of the reference's vmap.
    """
    b, n, d = x.shape
    dev = x.device
    init = torch.stack([torch.randperm(n, generator=generator)[:k]
                        for _ in range(b)]).to(dev)
    c = _gather_rows(x, init)
    offs = (torch.arange(b, device=dev) * k)[:, None]
    ones = torch.ones(b * n, dtype=x.dtype, device=dev)
    flat_x = x.reshape(b * n, d)
    for _ in range(iters):
        a = torch.argmin(pairwise_sqdist(x, c), dim=-1)          # (b, n)
        seg = (a + offs).reshape(-1)
        counts = torch.zeros(b * k, dtype=x.dtype, device=dev).index_add_(
            0, seg, ones).reshape(b, k)
        sums = torch.zeros(b * k, d, dtype=x.dtype, device=dev).index_add_(
            0, seg, flat_x).reshape(b, k, d)
        means = sums / torch.clamp_min(counts, 1.0)[..., None]
        reseed = torch.randint(0, n, (b, k), generator=generator).to(dev)
        c = torch.where(counts[..., None] > 0, means, _gather_rows(x, reseed))
    dist = pairwise_sqdist(x, c)
    a = torch.argmin(dist, dim=-1)
    dmin = torch.gather(dist, -1, a[..., None])[..., 0]
    return KMeansResult(centroids=c, assignments=a.to(torch.int32),
                        inertia=torch.sum(dmin, dim=-1))


def kmeans(x: torch.Tensor, k: int, iters: int = 25, *,
           generator: torch.Generator) -> KMeansResult:
    """Lloyd's algorithm. x: (n, d) float32. Returns KMeansResult."""
    res = kmeans_multi(x[None], k, iters, generator=generator)
    return KMeansResult(res.centroids[0], res.assignments[0], res.inertia[0])
