"""Inverted-file index with 4-bit PQ fast-scan (counterpart of
``repro.core.ivf``).

Lists are padded to a fixed ``cap`` (``core.lists.ListStore``); encoding is
by residual (codes quantize ``x - centroid``). Here: the index, its build,
the fixed-shape encoder the build and the engine's upserts share
(``encode_rows``), the per-(query, probe) residual LUTs, the full-pool
``scan_probes`` (every impl of ``kernels.ops.SCAN_IMPLS``), the
gather-free reduced-pool ``scan_probes_stream`` (K1, or K4 with early
exit), and ``search_ivf``.

Conventions: queries/centroids/distances float32; packed codes uint8; ids
and probe ids int32; -1 = no probe / no candidate (distance +inf).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import fastscan as fs
from repro_torch.core import pq as pq_mod
from repro_torch.core import topk as topk_mod
from repro_torch.core.kmeans import kmeans, pairwise_sqdist
from repro_torch.core.lists import ListStore, build_lists
from repro_torch.core.pq import PQCodebook

# rows per assignment batch of the training rows (bounds the (chunk, nlist)
# distance matrix)
_BUILD_CHUNK = 65536
# rows per encode call: every encode, at build time and on upsert, runs at
# this zero-padded shape, so a row's assignment and code bytes do not
# depend on the batch that carries it (the mutation contract)
_ENCODE_CHUNK = 256
# elements of one (rows, centroids, D) product in the encoder's distances;
# bounds its memory, the centroids are cut into blocks of one fixed size
_ENCODE_BLOCK = 1 << 25


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
    lists. Runs on the device of ``train_x``/``base_x``; the base is encoded
    by the same fixed-shape encoder as an upsert (``encode_rows``), the
    bucketing is host-side numpy."""
    centroids = kmeans(train_x, nlist, coarse_iters,
                       generator=generator).centroids
    train_res = train_x - centroids[_nearest(train_x, centroids)]
    cb = pq_mod.train_pq(train_res, m, 16, pq_iters, generator=generator)
    assign, packed = _encode(centroids, cb, base_x)
    lists = build_lists(assign.cpu().numpy(), packed.cpu().numpy(),
                        nlist=nlist, cap=cap, device=base_x.device)
    return IVFIndex(centroids=centroids, codebook=cb, lists=lists)


def _sqdist_rowwise(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``pairwise_sqdist``'s expansion ``x2 - 2·x·c + c2`` (clamped at 0),
    with every dot product an elementwise product summed over D rather than
    a GEMM: (..., n, D) x (..., k, D) -> (..., n, k). Each entry is reduced
    by the same code whatever its position, at a given shape."""
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    c2 = torch.sum(c * c, dim=-1)
    xc = torch.sum(x[..., :, None, :] * c[..., None, :, :], dim=-1)
    return torch.clamp_min(x2 - 2.0 * xc + c2[..., None, :], 0.0)


def _encode_chunk(centroids: torch.Tensor, cb: PQCodebook,
                  chunk: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest centroid + packed residual PQ codes of one (_ENCODE_CHUNK, D)
    chunk: (assign (n,) i32, packed (n, M//2) u8). The centroids go in
    zero-padded blocks of one fixed size, so every distance is computed at
    one shape."""
    nlist, d = centroids.shape
    nb = max(1, _ENCODE_BLOCK // (_ENCODE_CHUNK * d))
    if nb >= nlist:
        dist = _sqdist_rowwise(chunk, centroids)
    else:
        cen = torch.nn.functional.pad(centroids, (0, 0, 0, (-nlist) % nb))
        dist = torch.cat([_sqdist_rowwise(chunk, cen[s:s + nb])
                          for s in range(0, cen.shape[0], nb)], dim=1)
        dist = dist[:, :nlist]
    assign = torch.argmin(dist, dim=-1)
    sub = pq_mod.split_subvectors(chunk - centroids[assign], cb.m)
    codes = torch.argmin(_sqdist_rowwise(sub, cb.codewords), dim=-1).T
    return assign.to(torch.int32), fs.pack_codes(codes)


def _encode(centroids: torch.Tensor, cb: PQCodebook, x: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """``encode_rows`` on the device of the centroids, as tensors."""
    n, d = x.shape
    assign = torch.empty((n,), dtype=torch.int32, device=x.device)
    packed = torch.empty((n, cb.m // 2), dtype=torch.uint8, device=x.device)
    for s in range(0, n, _ENCODE_CHUNK):
        chunk = x[s:s + _ENCODE_CHUNK]
        c = chunk.shape[0]
        if c < _ENCODE_CHUNK:
            chunk = torch.nn.functional.pad(chunk, (0, 0, 0,
                                                    _ENCODE_CHUNK - c))
        a, p = _encode_chunk(centroids, cb, chunk)
        assign[s:s + c] = a[:c]
        packed[s:s + c] = p[:c]
    return assign, packed


def as_rows(vecs, device: torch.device) -> torch.Tensor:
    """Rows (numpy, read-only too, or a tensor) as an f32 tensor on
    ``device``; host arrays are copied."""
    if not isinstance(vecs, torch.Tensor):
        vecs = np.array(vecs, np.float32)
    return torch.as_tensor(vecs, dtype=torch.float32, device=device)


def encode_rows(centroids: torch.Tensor, cb: PQCodebook, vecs
                ) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic list assignment + residual PQ encode of raw rows.

    vecs: (B, D) f32 (numpy or a tensor, moved to the centroids' device).
    Returns (assign (B,) i32, packed (B, M//2) u8) as host arrays: each
    row's nearest centroid and the nibble-packed 4-bit codes of its
    residual, what ``build_ivf`` stores for a row of the base.

    Every chunk runs at the zero-padded shape ``_ENCODE_CHUNK`` and every
    distance is a per-row reduction (``_sqdist_rowwise``), not a GEMM: a
    GEMM library promises the same bits for the same problem, not for a
    row at another position of the batch. So a row encodes to the same
    bytes whatever batch carries it, and an upserted row's codes equal
    those a rebuild over the same centroids and codebook gives it.
    """
    x = as_rows(vecs, centroids.device)
    with torch.no_grad():
        assign, packed = _encode(centroids, cb, x.reshape(-1,
                                                          centroids.shape[1]))
    return assign.cpu().numpy(), packed.cpu().numpy()


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


def scan_probes(index: IVFIndex, q: torch.Tensor, probe_ids: torch.Tensor,
                *, impl: str = "ref") -> tuple[torch.Tensor, torch.Tensor]:
    """Quantized fine scan, full pool: 4-bit ADC over the probed lists.

    q (Q, D); probe_ids (Q, P) (-1 = no probe). Returns (dists (Q, P, cap)
    f32, ids (Q, P, cap) i32, -1 = padding). ``impl`` is any of
    ``kernels.ops.SCAN_IMPLS``: 'ref' (plain torch), 'select' (K5), 'mxu'
    (K6) over a gathered copy of the probed lists, 'stream' (K3) over the
    store in place, or 'auto' (the autotuner's verdict, which may be
    'stream'). All equal on every real candidate; an invalid probe's
    distances are unmasked garbage under any impl (consumers mask on
    ``ids >= 0``).
    """
    from repro_torch.kernels import ops

    qlut = _probe_tables(index, q, probe_ids)          # (Q, P, M, 16)
    qq, p = probe_ids.shape
    cap = index.lists.cap
    m = qlut.table_q8.shape[-2]
    impl, tile_n = ops.resolve_scan_impl(impl, qq * p, cap, m,
                                         nlist=index.lists.nlist,
                                         device=index.lists.codes.device)
    tables = qlut.table_q8.reshape(qq * p, m, 16)
    if impl == "stream":
        # in place: only the ids of the probed lists are gathered
        acc = ops.fastscan_stream_grouped(
            tables, index.lists.codes, probe_ids.reshape(-1),
            tile_n=tile_n).reshape(qq, p, cap)
        ids = index.lists.gather_ids(probe_ids)
    else:
        codes, ids = index.lists.gather(probe_ids)     # (Q,P,cap,Mh), (Q,P,cap)
        acc = ops.fastscan_grouped(
            tables, codes.reshape(qq * p, cap, -1), impl=impl,
            tile_n=tile_n).reshape(qq, p, cap)
    dists = (qlut.scale[..., None] * acc.float()
             + torch.sum(qlut.bias, dim=-1)[..., None])
    return dists, ids


def scan_probes_stream(index: IVFIndex, q: torch.Tensor,
                       probe_ids: torch.Tensor, *, keep: int,
                       tile_n: int = 0,
                       filter_bits: torch.Tensor | None = None,
                       early_exit: bool = False
                       ) -> tuple[torch.Tensor, ...]:
    """Gather-free fine scan with fused candidate reduction (+ filtering).

    The stream kernel reads ``index.lists.codes`` in place and keeps each
    cap tile's ``kc = min(keep, tile)`` best (quantized dist, slot) pairs;
    ``filter_bits`` (nlist, W) u8 excludes rows whose bit is 0 before that
    selection. Returns the reduced pool (dists (Q, C') f32, ids (Q, C') i32,
    -1 = absent) with C' = P * n_tiles * kc, in (probe, tile, rank) order,
    so any final selection of <= ``keep`` candidates equals the same
    selection over the full scan.

    ``early_exit`` runs the anytime tile pruning (K4) and returns a third
    tensor, tiles_skipped (Q,) i32: the valid-probe tiles the bound proved
    irrelevant. The final selection stays bit-identical; the raw pool does
    not (pruned tiles come back as absent candidates).
    """
    from repro_torch.kernels import ops

    qlut = _probe_tables(index, q, probe_ids)
    qq, p = probe_ids.shape
    bias_sum = torch.sum(qlut.bias, dim=-1)                   # (Q, P)
    out = ops.fastscan_stream_topk(
        qlut.table_q8.reshape(qq * p, *qlut.table_q8.shape[2:]),
        index.lists.codes, probe_ids.reshape(-1), index.lists.sizes,
        keep=keep, tile_n=tile_n, filter_bits=filter_bits,
        early_exit=early_exit, groups_per_query=p,
        scales=qlut.scale.reshape(-1), biases=bias_sum.reshape(-1))
    vals, slots = out[0], out[1]
    n_tiles, kc = vals.shape[1], vals.shape[2]
    vals = vals.reshape(qq, p, n_tiles * kc)
    slots = slots.reshape(qq, p, n_tiles * kc)
    valid = slots >= 0
    # the reference's dequantization expression and operation order (the
    # one K4 thresholds with)
    dists = qlut.scale[..., None] * vals.float() + bias_sum[..., None]
    dists = torch.where(valid, dists, torch.inf)
    # ids only for the kept candidates
    lids = torch.clamp_min(probe_ids, 0).long()[..., None]
    ids = index.lists.ids[lids, torch.clamp_min(slots, 0).long()]
    ids = torch.where(valid & (probe_ids >= 0)[..., None], ids, -1)
    if early_exit:
        tiles_skipped = torch.sum(out[2].reshape(qq, -1), dim=1,
                                  dtype=torch.int32)
        return dists.reshape(qq, -1), ids.reshape(qq, -1), tiles_skipped
    return dists.reshape(qq, -1), ids.reshape(qq, -1)


def _final_topk(dists: torch.Tensor, ids: torch.Tensor, topk: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    qq = dists.shape[0]
    flat_d = dists.reshape(qq, -1)
    flat_ids = ids.reshape(qq, -1)
    vals, pos = topk_mod.masked_topk(flat_d, flat_ids >= 0, topk)
    return vals, topk_mod.gather_ids(flat_ids, pos)


def search_ivf(index: IVFIndex, q: torch.Tensor, *, nprobe: int = 8,
               topk: int = 10) -> tuple[torch.Tensor, torch.Tensor]:
    """IVF + 4-bit fast-scan search ('ref' scan, no re-rank).

    q (Q, D) or (D,). Returns (dists (Q, topk) f32, ids (Q, topk) i32,
    -1 padding).
    """
    if q.ndim == 1:
        q = q[None]
    coarse_d = pairwise_sqdist(q, index.centroids)            # (Q, nlist)
    _, probe_ids = topk_mod.smallest_k(coarse_d, nprobe)      # (Q, P)
    return _final_topk(*scan_probes(index, q, probe_ids), topk)


def search_ivf_precomputed_probes(index: IVFIndex, q: torch.Tensor,
                                  probe_ids: torch.Tensor, *, nprobe: int = 8,
                                  topk: int = 10
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fine stage only: the probes come from an external coarse quantizer
    (the paper's Table 1 pipeline: HNSW for coarse, fast-scan for fine)."""
    if q.ndim == 1:
        q = q[None]
    return _final_topk(*scan_probes(index, q, probe_ids[:, :nprobe]), topk)
