"""KV caches for decode: exact and 4-bit-PQ-compressed (the paper's
technique), the port of ``repro/models/kvcache.py``.

The PQ cache is the LM-serving home of the paper's kernel: decode attention
scores q . k_i by ADC against PQ-encoded keys with a 16-entry inner-product
LUT a sub-space, u8-quantized and summed in int32 as the ANN fast-scan
does, and reconstructs the PQ-encoded values on the fly. On the card that
is K8 (``kernels/pq_decode_kernel.py``), which reads only the live
positions' 4-bit codes; this module builds its LUTs.

Codebooks are per (layer, KV head, sub-space) serving-time constants,
calibrated on activation samples (``calibrate_kv_codebooks``).

The caches are updated in place: ``update_exact`` and ``update_pq`` write
the new token's row into the given tensors (the reference returns new
arrays) and return them; ``write_prompt`` writes a prefill's rows.

Over a mesh of several ranks the caches are DTensors sharded on "batch"
and "kv_seq" (the rules' ``PQ_CODE_AXES`` and ``EXACT_KV_AXES``: "model"
goes to the context first, so the heads and sub-spaces stay whole). Each
write runs on the local shards (``launch.sharding.local_map``): only the
rank whose positions hold the row writes it, in place, and nothing is
gathered but the new rows over the heads. ``pq_decode_attention`` runs
K8's sharded mode there (``_pq_decode_over_ranks``).

Where the heads do not divide the model axis, the serving rules shard
the PQ cache on its sub-spaces ("pq_m") instead, and the positions stay
whole: each rank holds the codes and codebooks of M / n sub-spaces and
the matching slice of every K/V row's head_dim, encodes and writes its
own sub-spaces, and scores and decodes over them with K8's sub-space mode
(``_pq_decode_over_subspaces``: one i32 all-reduce of the partial sums,
the paper's ADC spread over ranks).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.fastscan import quantize_lut
from repro_torch.core.kmeans import kmeans_multi
from repro_torch.kernels import pq_decode_kernel as pqk
from repro_torch.kernels.pq_decode_kernel import decode_kv  # noqa: F401
from repro_torch.launch import sharding as shd
from repro_torch.models.config import ModelConfig

# logical axes of the cache trees (for launch.sharding.tree_shardings); the
# caches stack their layers on a leading axis, as the reference's do
EXACT_KV_AXES = ("stack", "batch", "kv_seq", "kv_heads", "head_dim")
PQ_CODE_AXES = ("stack", "batch", "kv_seq", "kv_heads", "pq_m")
PQ_CB_AXES = ("stack", "kv_heads", "pq_m", None, None)


class ExactKVCache(NamedTuple):
    k: torch.Tensor  # (L, B, Smax, KV, hd)
    v: torch.Tensor


class PQKVCache(NamedTuple):
    k_codes: torch.Tensor    # (L, B, Smax, KV, M//2) u8 (nibble-packed)
    v_codes: torch.Tensor
    k_cb: torch.Tensor       # (L, KV, M, 16, dsub) codebooks
    v_cb: torch.Tensor


def init_exact(cfg: ModelConfig, batch: int, max_seq: int,
               dtype: torch.dtype, device: torch.device) -> ExactKVCache:
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    shape = (cfg.n_layers, batch, max_seq, kv, hd)
    return ExactKVCache(torch.zeros(shape, dtype=dtype, device=device),
                        torch.zeros(shape, dtype=dtype, device=device))


def init_pq(cfg: ModelConfig, batch: int, max_seq: int,
            device: torch.device) -> PQKVCache:
    """Zero codes and zero bf16 codebooks (``calibrate_pq_cache`` fills
    the codebooks)."""
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    m = cfg.resolved_kv_pq_m
    lshape = (cfg.n_layers, batch, max_seq, kv, m // 2)
    cbshape = (cfg.n_layers, kv, m, 16, hd // m)
    return PQKVCache(torch.zeros(lshape, dtype=torch.uint8, device=device),
                     torch.zeros(lshape, dtype=torch.uint8, device=device),
                     torch.zeros(cbshape, dtype=torch.bfloat16, device=device),
                     torch.zeros(cbshape, dtype=torch.bfloat16, device=device))


def exact_cache_axes() -> ExactKVCache:
    return ExactKVCache(EXACT_KV_AXES, EXACT_KV_AXES)


def pq_cache_axes() -> PQKVCache:
    return PQKVCache(PQ_CODE_AXES, PQ_CODE_AXES, PQ_CB_AXES, PQ_CB_AXES)


# ---------------------------------------------------------------------------
# PQ encode/decode of K/V rows
# ---------------------------------------------------------------------------

def encode_kv(x: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """x: (..., KV, hd); cb: (KV, M, 16, dsub) -> packed codes (..., KV,
    M//2): the nearest centroid a sub-space (squared distance in f32, the
    lowest index among equal distances), packed lo | hi << 4."""
    kv, m, _, dsub = cb.shape
    xs = x.reshape(*x.shape[:-1], m, 1, dsub)
    d = torch.sum((xs.float() - cb.float()) ** 2, dim=-1)     # (..., KV, M, 16)
    codes = torch.argmin(d, dim=-1).to(torch.uint8)           # (..., KV, M)
    return codes[..., 0::2] | (codes[..., 1::2] << 4)


def calibrate_kv_codebooks(generator: torch.Generator, samples: torch.Tensor,
                           m: int, iters: int = 15) -> torch.Tensor:
    """k-means codebooks from activation samples (N, KV, hd) -> (KV, M, 16,
    dsub) f32; ``generator`` (a CPU one) seeds the k-means."""
    n, kv, hd = samples.shape
    dsub = hd // m
    sub = samples.reshape(n, kv, m, dsub).permute(1, 2, 0, 3).reshape(
        kv * m, n, dsub)
    res = kmeans_multi(sub.float().contiguous(), 16, iters,
                       generator=generator)
    return res.centroids.reshape(kv, m, 16, dsub)


# ---------------------------------------------------------------------------
# PQ decode attention (one new token vs a PQ-compressed context)
# ---------------------------------------------------------------------------

def _build_ip_lut(q: torch.Tensor, k_cb: torch.Tensor) -> torch.Tensor:
    """Inner-product LUTs. q: (B, KV, g, hd); k_cb: (KV, M, 16, dsub).

    Returns (B, KV, g, M, 16) float32: T[m][c] = q_m . cb[m][c].
    """
    b, kv, g, _ = q.shape
    m, dsub = k_cb.shape[1], k_cb.shape[3]
    qs = q.reshape(b, kv, g, m, dsub)
    return torch.einsum("bkgmd,kmcd->bkgmc", qs.float(), k_cb.float())


def _quantize(lut: torch.Tensor):
    """(B, KV, g, M, 16) f32 -> (table_q8 (B, KV, g, M, 16) u8, scale
    (B, KV, g), summed bias (B, KV, g)), one quantized LUT a query row."""
    qlut = quantize_lut(lut.reshape(-1, *lut.shape[-2:]))     # rows = B*KV*g
    table = qlut.table_q8.reshape(lut.shape).contiguous()
    scale = qlut.scale.reshape(*lut.shape[:3]).contiguous()
    bias = qlut.bias.reshape(*lut.shape[:4]).sum(-1)
    return table, scale, bias


def _adc_scores(lut: torch.Tensor, packed: torch.Tensor, quantize_q8: bool,
                table_q8: torch.Tensor | None = None) -> torch.Tensor:
    """lut: (B, KV, g, M, 16); packed: (B, C, KV, M//2) -> scores (B, KV,
    g, C).

    With quantize_q8 (paper-faithful) the LUT is affine-quantized to u8 and
    accumulated in int32, as the ANN fast-scan does; scores are then
    dequantized for the softmax. ``table_q8``, when given, replaces the u8
    table quantized here (its integer stage fed a given table).
    """
    if not quantize_q8:
        return pqk.adc_scores(lut, None, None, packed)
    table, scale, bias = _quantize(lut)
    if table_q8 is not None:
        table = table_q8
    return pqk.adc_scores(table, scale, bias, packed)


def pq_decode_attention(q: torch.Tensor, k_codes: torch.Tensor,
                        v_codes: torch.Tensor, k_cb: torch.Tensor,
                        v_cb: torch.Tensor, position: torch.Tensor, *,
                        chunk: int = 2048, quantize_q8: bool = True
                        ) -> torch.Tensor:
    """One-token attention against the PQ cache.

    q: (B, H, hd); k_codes/v_codes: (B, Smax, KV, M//2) u8; k_cb/v_cb:
    (KV, M, 16, dsub); position: (B,) current positions. Returns (B, H, hd)
    in q's dtype. CUDA tensors go to K8, CPU tensors to its plain version
    (the reference's online softmax over ``chunk``-position chunks).
    DTensors (a mesh) go to ``_pq_decode_over_ranks``.
    """
    if shd.is_placed(k_codes):
        return _pq_decode_over_ranks(q, k_codes, v_codes, k_cb, v_cb,
                                     position, chunk, quantize_q8)
    b, h, hd = q.shape
    kv = k_codes.shape[2]
    g = h // kv
    smax = k_codes.shape[1]
    chunk = min(chunk, smax)
    assert smax % chunk == 0, (smax, chunk)
    table, scale, bias = _luts(q.reshape(b, kv, g, hd), k_cb, quantize_q8)
    return pqk.pq_decode(table, scale, bias, k_codes.contiguous(),
                         v_codes.contiguous(), v_cb.contiguous(),
                         position.to(torch.int32), chunk=chunk,
                         out_dtype=q.dtype)


def _luts(qg: torch.Tensor, k_cb: torch.Tensor, quantize_q8: bool):
    """K8's (table, scale, bias) of the (B, KV, g, hd) queries: the
    inner-product LUTs over sqrt(hd), u8-quantized or f32."""
    lut = _build_ip_lut(qg, k_cb) / math.sqrt(qg.shape[-1])
    if quantize_q8:
        return _quantize(lut)
    return lut.contiguous(), None, None


def rows_whole(cache: torch.Tensor, subspaces: bool = False) -> None:
    """A placed (B, Smax, KV, ·) cache must be sharded on its batch and
    positions only; with ``subspaces`` (PQ codes), on its batch and either
    its positions or its sub-spaces ("pq_m"), not both."""
    dims = {p.dim for i, p in enumerate(cache.placements)
            if p.is_shard() and cache.device_mesh.size(i) > 1}
    bad = dims - ({0, 1, 3} if subspaces else {0, 1})
    if bad or {1, 3} <= dims:
        raise NotImplementedError(
            f"a cache at {cache.placements}: sharded on its dims "
            f"{sorted(dims)}; K8 takes its batch with its positions or its "
            f"sub-spaces")


def _subspace_dim(codes: torch.Tensor, cb) -> int | None:
    """The mesh dimension that shards the placed codes' sub-spaces ("pq_m",
    their last axis), or None; the codebooks ``cb`` (KV, M, 16, dsub), when
    given, must hold the same sub-spaces (two a byte of the codes)."""
    rows_whole(codes, subspaces=True)
    offset, mdim = shd.shard_offset(codes, 3)
    if mdim is None or cb is None:
        return mdim
    cb_offset, cb_dim = shd.shard_offset(cb, 1)
    if cb_dim != mdim or cb_offset != 2 * offset:
        raise ValueError(f"codes at {codes.placements} and codebooks at "
                         f"{cb.placements} hold other sub-spaces")
    return mdim


def _pq_decode_over_ranks(q, k_codes, v_codes, k_cb, v_cb, position,
                          chunk: int, quantize_q8: bool) -> torch.Tensor:
    """K8 over a PQ cache sharded on "kv_seq": the queries (sharded on
    heads) and codebooks (on KV heads) are all-gathered over "model", so
    each rank builds the same LUTs; each runs K8's split pass over its
    own positions at its offset (``pq_decode_split``); the partials are
    all-gathered over "model" in rank order (the collective this step
    adds) and each rank runs the combine pass over them. Where the
    positions are not sharded (one rank, or "kv_seq" replicated) it is
    the one-rank call on the local rows; where the sub-spaces are, K8's
    sub-space mode (``_pq_decode_over_subspaces``)."""
    sdim = _subspace_dim(k_codes, k_cb)
    if sdim is not None:
        _subspace_dim(v_codes, v_cb)
        return _pq_decode_over_subspaces(q, k_codes, v_codes, k_cb, v_cb,
                                         position, sdim, quantize_q8)
    offset, mdim = shd.shard_offset(k_codes, 1)
    rows = shd.keep_shard(k_codes.placements, 0)
    whole = shd.replicate(k_codes)
    dm = k_codes.device_mesh

    def body(ql, kc, vc, kcb, vcb, pos):
        if mdim is None:
            return pq_decode_attention(ql, kc, vc, kcb, vcb, pos,
                                       chunk=chunk, quantize_q8=quantize_q8)
        b, h, hd = ql.shape
        kv = kc.shape[2]
        table, scale, bias = _luts(ql.reshape(b, kv, h // kv, hd), kcb,
                                   quantize_q8)
        work = pqk.pq_decode_split(table, scale, bias, kc.contiguous(),
                                   vc.contiguous(), vcb.contiguous(),
                                   pos.to(torch.int32), pos_offset=offset)
        return pqk.pq_decode_combine(shd.all_gather(work, 3, dm, mdim),
                                     out_dtype=ql.dtype)

    return shd.local_map(body, rows, (rows, k_codes.placements,
                                      v_codes.placements, whole, whole, rows),
                         q, k_codes, v_codes, k_cb, v_cb, position)


def _quantize_over_ranks(lut: torch.Tensor):
    """``_quantize`` of a LUT whose sub-spaces are sharded over ranks, on a
    rank's (B, KV, g, M_r, 16) slice: the same u8 entries, the scale of
    the whole LUT (its largest range, an all-reduce MAX, exact) and the
    summed bias of all M sub-spaces (the ranks' biases gathered and
    summed as the one-rank sum is). A generator of ``subspace_rank``'s
    kind: it yields its collectives."""
    bias = torch.amin(lut, dim=-1)                           # (B, KV, g, M_r)
    shifted = lut - bias[..., None]
    maxval = yield "max", torch.amax(shifted, dim=(-2, -1))
    scale = torch.clamp_min(maxval, 1e-20) / 255.0
    table = torch.clamp(torch.round(shifted / scale[..., None, None]), 0,
                        255).to(torch.uint8)
    bias_sum = (yield "gather", bias.contiguous()).sum(-1)
    return table.contiguous(), scale.float().contiguous(), \
        bias_sum.float().contiguous()


def subspace_rank(ql, kc, vc, kcb, vcb, pos, hd: int):
    """One rank's part of K8's sub-space mode: ``ql`` (B, H, hd_r) its
    head_dim slice of the queries, ``kc``/``vc`` (B, Smax, KV, M_r/2) and
    ``kcb``/``vcb`` (KV, M_r, 16, dsub) its sub-spaces' codes and
    codebooks, ``pos`` (B,) the positions, ``hd`` the whole head_dim. It
    builds its sub-spaces' LUTs (over sqrt(hd)) and quantizes them with
    the whole LUT's scale (``_quantize_over_ranks``), sums its LUT entries
    a live position (``pq_decode_scores``), and runs the value pass over
    the whole sums and its codebooks (``pq_decode_values``,
    ``pq_decode_combine``): its (B, H, hd_r) slice of the output.

    A generator: each collective it needs it yields as ``(op, tensor)``,
    ``op`` one of "max" (an all-reduce MAX), "gather" (the ranks' tensors
    concatenated along the last dim in rank order) and "sum" (an
    all-reduce sum, of the i32 sums: exact), and is sent the result; it
    returns the slice. ``_pq_decode_over_subspaces`` runs it with the
    mesh's collectives (``_with_collectives``); the shards of one device
    run in lockstep are the same computation."""
    b, h, hdl = ql.shape
    kv = kc.shape[2]
    lut = _build_ip_lut(ql.reshape(b, kv, h // kv, hdl), kcb) / math.sqrt(hd)
    table, scale, bias = yield from _quantize_over_ranks(lut)
    pos = pos.to(torch.int32)
    sums = yield "sum", pqk.pq_decode_scores(table, kc.contiguous(), pos)
    work = pqk.pq_decode_values(sums, scale, bias, vc.contiguous(),
                                vcb.contiguous(), pos)
    return pqk.pq_decode_combine(work, out_dtype=ql.dtype)


def _with_collectives(rank, collectives: dict):
    """Run ``rank``, a generator of ``subspace_rank``'s kind, answering each
    collective it yields with ``collectives[op](tensor)``; its result."""
    try:
        op, x = next(rank)
        while True:
            op, x = rank.send(collectives[op](x))
    except StopIteration as done:
        return done.value


def _pq_decode_over_subspaces(q, k_codes, v_codes, k_cb, v_cb, position,
                              sdim: int, quantize_q8: bool) -> torch.Tensor:
    """K8's sub-space mode over a PQ cache sharded on "pq_m" along mesh
    dimension ``sdim`` (the positions whole): each rank runs
    ``subspace_rank`` on its head_dim slice of q and its sub-spaces, its
    collectives over ``sdim``."""
    if not quantize_q8:
        raise NotImplementedError("K8's sub-space mode sums u8 LUTs; f32 "
                                  "LUTs would sum in another order a rank")
    hd = q.shape[-1]
    dm = k_codes.device_mesh
    rows = shd.keep_shard(k_codes.placements, 0)
    sub = shd.shard_on(rows, 2, sdim)          # (B, H, hd): a head_dim slice
    collectives = {
        "max": lambda x: shd.all_reduce(x, dm, sdim, op="max"),
        "gather": lambda x: shd.all_gather(x, x.dim() - 1, dm, sdim),
        "sum": lambda x: shd.all_reduce(x, dm, sdim)}

    def body(*local):
        return _with_collectives(subspace_rank(*local, hd), collectives)

    return shd.local_map(body, sub, (sub, k_codes.placements,
                                     v_codes.placements, k_cb.placements,
                                     v_cb.placements, rows),
                         q, k_codes, v_codes, k_cb, v_cb, position)


def _at(pos, like: torch.Tensor) -> torch.Tensor:
    """The scalar position as a 1-element index on the cache's device (a
    device tensor stays there: no host sync)."""
    return torch.as_tensor(pos, device=like.device).reshape(1).long()


def _write_row(cache: torch.Tensor, row: torch.Tensor, pos, cb=None):
    """Write the (B, KV, ·) ``row`` (``cb``: K/V rows to encode first) at
    scalar position ``pos`` of the placed (B, Smax, KV, ·) ``cache``, in
    place on the local shards: each rank takes the new rows whole over
    the heads (an all-gather over "model" where they are sharded on KV
    heads, the codebooks likewise) and the rank whose positions hold
    ``pos`` writes them; the others rewrite their own row there (no host
    sync, no branch on a value). Codes sharded on their sub-spaces: each
    rank encodes its head_dim slice of the rows under its own codebooks,
    its sub-spaces' codes."""
    sdim = _subspace_dim(cache, cb) if cb is not None else None
    if sdim is None:
        rows_whole(cache)
    offset, mdim = shd.shard_offset(cache, 1)
    rows = shd.keep_shard(cache.placements, 0)
    whole = shd.replicate(cache)

    def body(c, r, p, *cbl):
        if cbl:
            r = encode_kv(r, cbl[0])
        r = r[:, None].to(c.dtype)
        j = p.reshape(1).long() - offset
        if mdim is not None:
            inside = (j >= 0) & (j < c.shape[1])
            j = j.clamp(0, c.shape[1] - 1)
            r = torch.where(inside, r, c.index_select(1, j))
        return c.index_copy_(1, j, r)

    extra = () if cb is None else (cb,)
    rowp, cbp = rows, whole
    if sdim is not None:
        rowp, cbp = shd.shard_on(rows, 2, sdim), cb.placements
    shd.local_map(body, cache.placements,
                  (cache.placements, rowp,
                   whole if shd.is_placed(pos) else None)
                  + (cbp,) * len(extra), cache, row, pos, *extra)
    return cache


def write_prompt(cache: torch.Tensor, x: torch.Tensor, cb=None):
    """Write a prompt's (B, S, KV, hd) rows ``x`` into positions [0, S) of
    the (B, Smax, KV, ·) ``cache`` in place: as they are, or as 4-bit
    codes under the (KV, M, 16, dsub) codebooks ``cb``. Placed: each rank
    takes ``x`` whole over the heads (an all-gather over "model" where
    they are sharded) and writes (encodes) only the positions of its own
    shard; codes sharded on their sub-spaces: each rank encodes its
    head_dim slice of ``x`` under its own codebooks."""
    s = x.shape[1]
    if not shd.is_placed(cache):
        cache[:, :s] = x if cb is None else encode_kv(x, cb)
        return cache
    sdim = _subspace_dim(cache, cb) if cb is not None else None
    if sdim is None:
        rows_whole(cache)
    offset, _ = shd.shard_offset(cache, 1)
    rows = shd.keep_shard(cache.placements, 0)
    whole = shd.replicate(cache)

    def body(c, xl, *cbl):
        hi = min(offset + c.shape[1], s)
        if hi > offset:
            part = xl[:, offset:hi]
            c[:, :hi - offset] = part if not cbl else encode_kv(part, cbl[0])
        return c

    extra = () if cb is None else (cb,)
    xp, cbp = rows, whole
    if sdim is not None:
        xp, cbp = shd.shard_on(rows, 3, sdim), cb.placements
    shd.local_map(body, cache.placements,
                  (cache.placements, xp) + (cbp,) * len(extra),
                  cache, x, *extra)
    return cache


def update_exact(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor, pos):
    """Write one token at scalar position ``pos`` (an int or a 0-d tensor)
    for the whole batch, in place. caches: (B, Smax, KV, hd)."""
    if shd.is_placed(k_cache):
        return (_write_row(k_cache, k_new, pos),
                _write_row(v_cache, v_new, pos))
    idx = _at(pos, k_cache)
    k_cache.index_copy_(1, idx, k_new[:, None].to(k_cache.dtype))
    v_cache.index_copy_(1, idx, v_new[:, None].to(v_cache.dtype))
    return k_cache, v_cache


def update_pq(k_codes: torch.Tensor, v_codes: torch.Tensor,
              k_new: torch.Tensor, v_new: torch.Tensor, k_cb: torch.Tensor,
              v_cb: torch.Tensor, pos):
    """Encode one token's K/V to 4-bit codes and write them at ``pos`` for
    the whole batch, in place."""
    if shd.is_placed(k_codes):
        return (_write_row(k_codes, k_new, pos, k_cb),
                _write_row(v_codes, v_new, pos, v_cb))
    idx = _at(pos, k_codes)
    k_codes.index_copy_(1, idx, encode_kv(k_new, k_cb)[:, None])
    v_codes.index_copy_(1, idx, encode_kv(v_new, v_cb)[:, None])
    return k_codes, v_codes
