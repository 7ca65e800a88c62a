"""Synthetic ANN datasets with the paper's dataset geometry
(counterpart of ``repro.data.vectors``).

The generators are the reference's numpy code, kept here as a copy, so the
same seed gives the same base, train and query arrays in both packages.
Exact ground truth is brute force in torch, on the caller's device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.kmeans import pairwise_sqdist
from repro_torch.core.topk import smallest_k
from repro_torch.device import resolve_device


class ANNDataset(NamedTuple):
    base: torch.Tensor     # (N, D)
    train: torch.Tensor    # (Nt, D)
    queries: torch.Tensor  # (Q, D)
    gt_ids: torch.Tensor   # (Q, G) exact nearest neighbour ids (ascending)

    @property
    def d(self) -> int:
        return self.base.shape[1]


def _gmm(rng: np.random.Generator, n: int, d: int, ncl: int, spread: float):
    centers = rng.normal(0.0, 1.0, (ncl, d)).astype(np.float32)
    which = rng.integers(0, ncl, n)
    x = centers[which] + spread * rng.normal(0.0, 1.0, (n, d)).astype(np.float32)
    return x.astype(np.float32)


def _make_queries(rng, base: np.ndarray, nq: int, rel_noise: float) -> np.ndarray:
    """Queries = perturbed base vectors: the true NN is at a controlled
    margin, so recall measures ADC fidelity."""
    idx = rng.choice(base.shape[0], size=nq, replace=False)
    scale = np.std(base) * rel_noise
    return (base[idx] + scale * rng.normal(0, 1, (nq, base.shape[1]))
            ).astype(np.float32)


def exact_ground_truth(base: torch.Tensor, queries: torch.Tensor, g: int = 10,
                       chunk: int = 512) -> torch.Tensor:
    """Brute-force (Q, g) nearest ids, lowest id first among ties."""
    return torch.cat([smallest_k(pairwise_sqdist(queries[s:s + chunk], base),
                                 g)[1]
                      for s in range(0, queries.shape[0], chunk)])


def _dataset(base, train, queries, gt, device) -> ANNDataset:
    dev = resolve_device(device)
    base_t = torch.as_tensor(base, device=dev)
    queries_t = torch.as_tensor(queries, device=dev)
    return ANNDataset(base_t, torch.as_tensor(train, device=dev), queries_t,
                      exact_ground_truth(base_t, queries_t, g=gt))


def make_sift_like(n: int = 100_000, nt: int = 20_000, nq: int = 256,
                   d: int = 128, ncl: int = 256, seed: int = 0,
                   gt: int = 10, query_noise: float = 0.5, *,
                   device: str | torch.device | None = None) -> ANNDataset:
    """128-D SIFT-like: non-negative, heavy cluster structure."""
    rng = np.random.default_rng(seed)
    x = _gmm(rng, n + nt, d, ncl, spread=0.35)
    x = np.abs(x) * 64.0  # SIFT histograms are non-negative, ~[0, 218]
    base, train = x[:n], x[n:]
    queries = _make_queries(rng, base, nq, query_noise)
    return _dataset(base, train, queries, gt, device)


def make_deep_like(n: int = 100_000, nt: int = 20_000, nq: int = 256,
                   d: int = 96, ncl: int = 256, seed: int = 1,
                   gt: int = 10, query_noise: float = 0.5, *,
                   device: str | torch.device | None = None) -> ANNDataset:
    """96-D Deep1B-like: L2-normalized CNN-ish features."""
    rng = np.random.default_rng(seed)
    x = _gmm(rng, n + nt, d, ncl, spread=0.25)
    x /= np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-9)
    base, train = x[:n], x[n:]
    queries = _make_queries(rng, base, nq, query_noise)
    queries /= np.maximum(np.linalg.norm(queries, axis=1, keepdims=True), 1e-9)
    return _dataset(base, train, queries, gt, device)
