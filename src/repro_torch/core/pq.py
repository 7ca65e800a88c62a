"""Product quantization: codebook training, encoding and float-LUT ADC
tables (counterpart of ``repro.core.pq``)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.kmeans import kmeans_multi, pairwise_sqdist


class PQCodebook(NamedTuple):
    """M sub-space codebooks. codewords: (M, K, dsub) with M*dsub == D."""

    codewords: torch.Tensor

    @property
    def m(self) -> int:
        return self.codewords.shape[0]

    @property
    def k(self) -> int:
        return self.codewords.shape[1]

    @property
    def dsub(self) -> int:
        return self.codewords.shape[2]

    @property
    def d(self) -> int:
        return self.m * self.dsub


def split_subvectors(x: torch.Tensor, m: int) -> torch.Tensor:
    """(n, D) -> (m, n, D/m)."""
    n, d = x.shape
    if d % m:
        raise ValueError(f"D={d} not divisible by M={m}")
    return x.reshape(n, m, d // m).transpose(0, 1)


def train_pq(x: torch.Tensor, m: int, k: int = 16, iters: int = 25, *,
             generator: torch.Generator) -> PQCodebook:
    """Train M independent K-entry codebooks on training vectors x (n, D)."""
    sub = split_subvectors(x, m).contiguous()   # (m, n, dsub)
    res = kmeans_multi(sub, k, iters, generator=generator)
    return PQCodebook(codewords=res.centroids)


def encode(cb: PQCodebook, x: torch.Tensor) -> torch.Tensor:
    """Quantize x (n, D) -> codes (n, M) int32 in [0, K)."""
    sub = split_subvectors(x, cb.m)                        # (m, n, dsub)
    codes = torch.argmin(pairwise_sqdist(sub, cb.codewords), dim=-1)
    return codes.T.to(torch.int32)


def adc_table(cb: PQCodebook, q: torch.Tensor, metric: str = "l2"
              ) -> torch.Tensor:
    """Per-query lookup table T (..., M, K).

    q: (D,) or (Q, D). metric 'l2' -> squared L2 per sub-space; 'ip' ->
    negated inner product (smaller is better for both metrics).
    """
    squeeze = q.ndim == 1
    if squeeze:
        q = q[None]
    qsub = split_subvectors(q, cb.m)                       # (m, Q, dsub)
    if metric == "l2":
        t = pairwise_sqdist(qsub, cb.codewords)            # (m, Q, K)
    elif metric == "ip":
        t = -(qsub @ cb.codewords.transpose(-1, -2))
    else:
        raise ValueError(metric)
    t = t.transpose(0, 1)                                  # (Q, m, K)
    return t[0] if squeeze else t
