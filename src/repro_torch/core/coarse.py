"""Coarse quantizer zoo over the IVF centroids (counterpart of
``repro.core.coarse``).

Three interchangeable quantizers, each with ``search(q, nprobe)`` ->
(dists (Q, nprobe) f32 ascending, list ids (Q, nprobe) i32, -1 = none):
  - flat: the full (Q, nlist) distance matrix and a top-nprobe;
  - HNSW: a graph search over the centroids (the paper's Table 1 choice);
  - k-means tree: the nearest ``nroots`` of sqrt(nlist) super-clusters,
    then only their children.

``tensors()`` names every tensor a quantizer's search reads, so a captured
graph can be keyed to them.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import hnsw as hnsw_mod
from repro_torch.core import topk as topk_mod
from repro_torch.core.kmeans import kmeans, pairwise_sqdist


class FlatCoarse(NamedTuple):
    centroids: torch.Tensor  # (nlist, D)

    def search(self, q: torch.Tensor, nprobe: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
        d = pairwise_sqdist(q, self.centroids)
        return topk_mod.smallest_k(d, nprobe)

    def tensors(self) -> tuple:
        return (self.centroids,)


class HNSWCoarse(NamedTuple):
    graph: hnsw_mod.HNSWGraph

    def search(self, q: torch.Tensor, nprobe: int, ef: int = 64
               ) -> tuple[torch.Tensor, torch.Tensor]:
        return hnsw_mod.search_hnsw(self.graph, q, ef=max(ef, nprobe),
                                    topk=nprobe)

    def tensors(self) -> tuple:
        return self.graph.tensors()


class TreeCoarse(NamedTuple):
    roots: torch.Tensor      # (R, D) super-cluster centres
    children: torch.Tensor   # (R, C) int32 child centroid ids, -1 padded
    centroids: torch.Tensor  # (nlist, D)

    def search(self, q: torch.Tensor, nprobe: int, nroots: int = 4
               ) -> tuple[torch.Tensor, torch.Tensor]:
        dr = pairwise_sqdist(q, self.roots)
        # at most every root (the reference's top_k raises past R)
        _, rid = topk_mod.smallest_k(dr, min(nroots, dr.shape[-1]))
        cand = self.children[rid.long()].reshape(q.shape[0], -1)
        cvec = self.centroids[torch.clamp_min(cand, 0).long()]
        diff = cvec - q[:, None, :]
        dc = torch.where(cand >= 0, torch.sum(diff * diff, dim=-1),
                         torch.inf)
        vals, pos = topk_mod.smallest_k(dc, nprobe)
        return vals, torch.gather(cand, 1, pos.long())

    def tensors(self) -> tuple:
        return (self.roots, self.children, self.centroids)


def build_flat(centroids: torch.Tensor) -> FlatCoarse:
    return FlatCoarse(centroids=centroids)


def build_hnsw_coarse(centroids: torch.Tensor, m: int = 16,
                      ef_construction: int = 64, seed: int = 0
                      ) -> HNSWCoarse:
    """The HNSW graph over the centroids, built on the host and placed on
    the centroids' device."""
    return HNSWCoarse(graph=hnsw_mod.build_hnsw(
        centroids, m=m, ef_construction=ef_construction, seed=seed,
        device=centroids.device))


def build_tree(centroids: torch.Tensor, *, nroots: int | None = None,
               iters: int = 15, seed: int = 0) -> TreeCoarse:
    """Two-level k-means tree: sqrt(nlist) roots (at least 2) from a k-means
    of the centroids, seeded with a ``torch.Generator`` (the reference seeds
    with ``jax.random``, so the two trees differ); each centroid is a child
    of its root, in id order, rows padded with -1."""
    nlist = centroids.shape[0]
    r = int(nroots or max(2, int(np.sqrt(nlist))))
    res = kmeans(centroids, k=r, iters=iters,
                 generator=torch.Generator().manual_seed(seed))
    assign = res.assignments.cpu().numpy().astype(np.int64)
    counts = np.bincount(assign, minlength=r)
    order = np.argsort(assign, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    children = np.full((r, int(counts.max())), -1, np.int32)
    children[assign[order], np.arange(nlist) - starts[assign[order]]] = order
    return TreeCoarse(roots=res.centroids,
                      children=torch.from_numpy(children).to(
                          centroids.device),
                      centroids=centroids)
