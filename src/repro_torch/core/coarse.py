"""Coarse quantizer over the IVF centroids (counterpart of
``repro.core.coarse``). Only the flat quantizer is ported; HNSW and the
k-means tree are ROADMAP Queue 1 item 5."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import topk as topk_mod
from repro_torch.core.kmeans import pairwise_sqdist


class FlatCoarse(NamedTuple):
    centroids: torch.Tensor  # (nlist, D)

    def search(self, q: torch.Tensor, nprobe: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
        d = pairwise_sqdist(q, self.centroids)
        return topk_mod.smallest_k(d, nprobe)


def build_flat(centroids: torch.Tensor) -> FlatCoarse:
    return FlatCoarse(centroids=centroids)
