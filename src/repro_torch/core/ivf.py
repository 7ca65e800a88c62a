"""Inverted-file index with 4-bit PQ fast-scan (counterpart of
``repro.core.ivf``).

Lists are padded to a fixed ``cap`` (``core.lists.ListStore``); encoding is
by residual (codes quantize ``x - centroid``). Ported here: the index
pytree, its build, the per-(query, probe) residual LUTs and the gather-free
``scan_probes_stream`` over the CUDA stream-scan kernel. The gathered
``scan_probes`` impls and the early-exit variant are ROADMAP Queue 1
items 8-9.

Conventions: queries/centroids/distances float32; packed codes uint8; ids
and probe ids int32; -1 = no probe / no candidate (distance +inf).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import fastscan as fs
from repro_torch.core import pq as pq_mod
from repro_torch.core.kmeans import kmeans, pairwise_sqdist
from repro_torch.core.lists import ListStore, build_lists
from repro_torch.core.pq import PQCodebook

# rows per assignment / encode batch at build time (bounds the (chunk,
# nlist) distance matrix)
_BUILD_CHUNK = 65536


class IVFIndex(NamedTuple):
    centroids: torch.Tensor  # (nlist, D) coarse quantizer
    codebook: PQCodebook     # residual PQ codebooks, K=16
    lists: ListStore         # padded posting lists

    @property
    def nlist(self) -> int:
        return self.centroids.shape[0]

    @property
    def cap(self) -> int:
        return self.lists.cap


def _nearest(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest centroid per row, in chunks: (n, D) -> (n,) int64."""
    return torch.cat([torch.argmin(pairwise_sqdist(x[s:s + _BUILD_CHUNK],
                                                   centroids), dim=-1)
                      for s in range(0, x.shape[0], _BUILD_CHUNK)])


def build_ivf(train_x: torch.Tensor, base_x: torch.Tensor, *, m: int,
              nlist: int, cap: int | None = None, coarse_iters: int = 20,
              pq_iters: int = 25, generator: torch.Generator) -> IVFIndex:
    """Train coarse centroids + residual PQ, bucket the base into padded
    lists. Runs on the device of ``train_x``/``base_x``; the bucketing is
    host-side numpy."""
    centroids = kmeans(train_x, nlist, coarse_iters,
                       generator=generator).centroids
    assign = _nearest(base_x, centroids)
    train_res = train_x - centroids[_nearest(train_x, centroids)]
    cb = pq_mod.train_pq(train_res, m, 16, pq_iters, generator=generator)
    packed = torch.cat([
        fs.pack_codes(pq_mod.encode(
            cb, base_x[s:s + _BUILD_CHUNK]
            - centroids[assign[s:s + _BUILD_CHUNK]]))
        for s in range(0, base_x.shape[0], _BUILD_CHUNK)])
    lists = build_lists(assign.cpu().numpy(), packed.cpu().numpy(),
                        nlist=nlist, cap=cap, device=base_x.device)
    return IVFIndex(centroids=centroids, codebook=cb, lists=lists)


def _probe_tables(index: IVFIndex, q: torch.Tensor, probe_ids: torch.Tensor
                  ) -> fs.QuantizedLUT:
    """Residual ADC LUTs for each (query, probe): (Q, P, M, 16) u8."""
    mu = index.centroids[torch.clamp_min(probe_ids, 0).long()]   # (Q, P, D)
    resid = q[:, None, :] - mu
    qq, p, d = resid.shape
    t = pq_mod.adc_table(index.codebook, resid.reshape(qq * p, d))
    qlut = fs.quantize_lut(t)
    return fs.QuantizedLUT(
        table_q8=qlut.table_q8.reshape(qq, p, *qlut.table_q8.shape[1:]),
        scale=qlut.scale.reshape(qq, p),
        bias=qlut.bias.reshape(qq, p, -1))


def scan_probes_stream(index: IVFIndex, q: torch.Tensor,
                       probe_ids: torch.Tensor, *, keep: int,
                       tile_n: int = 0,
                       filter_bits: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather-free fine scan with fused candidate reduction (+ filtering).

    The stream kernel reads ``index.lists.codes`` in place and keeps each
    cap tile's ``kc = min(keep, tile)`` best (quantized dist, slot) pairs;
    ``filter_bits`` (nlist, W) u8 excludes rows whose bit is 0 before that
    selection. Returns the reduced pool (dists (Q, C') f32, ids (Q, C') i32,
    -1 = absent) with C' = P * n_tiles * kc, in (probe, tile, rank) order,
    so any final selection of <= ``keep`` candidates equals the same
    selection over the full scan.
    """
    from repro_torch.kernels import ops

    qlut = _probe_tables(index, q, probe_ids)
    qq, p = probe_ids.shape
    bias_sum = torch.sum(qlut.bias, dim=-1)                   # (Q, P)
    vals, slots = ops.fastscan_stream_topk(
        qlut.table_q8.reshape(qq * p, *qlut.table_q8.shape[2:]),
        index.lists.codes, probe_ids.reshape(-1), index.lists.sizes,
        keep=keep, tile_n=tile_n, filter_bits=filter_bits)
    n_tiles, kc = vals.shape[1], vals.shape[2]
    vals = vals.reshape(qq, p, n_tiles * kc)
    slots = slots.reshape(qq, p, n_tiles * kc)
    valid = slots >= 0
    # the reference's dequantization expression and operation order
    dists = qlut.scale[..., None] * vals.float() + bias_sum[..., None]
    dists = torch.where(valid, dists, torch.inf)
    # ids only for the kept candidates
    lids = torch.clamp_min(probe_ids, 0).long()[..., None]
    ids = index.lists.ids[lids, torch.clamp_min(slots, 0).long()]
    ids = torch.where(valid & (probe_ids >= 0)[..., None], ids, -1)
    return dists.reshape(qq, -1), ids.reshape(qq, -1)
