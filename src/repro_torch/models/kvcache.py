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
arrays) and return them.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.fastscan import quantize_lut
from repro_torch.core.kmeans import kmeans_multi
from repro_torch.kernels import pq_decode_kernel as pqk
from repro_torch.kernels.pq_decode_kernel import decode_kv  # noqa: F401
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
    """
    b, h, hd = q.shape
    kv = k_codes.shape[2]
    g = h // kv
    smax = k_codes.shape[1]
    chunk = min(chunk, smax)
    assert smax % chunk == 0, (smax, chunk)
    lut = _build_ip_lut(q.reshape(b, kv, g, hd), k_cb) / math.sqrt(hd)
    if quantize_q8:
        table, scale, bias = _quantize(lut)
    else:
        table, scale, bias = lut.contiguous(), None, None
    return pqk.pq_decode(table, scale, bias, k_codes.contiguous(),
                         v_codes.contiguous(), v_cb.contiguous(),
                         position.to(torch.int32), chunk=chunk,
                         out_dtype=q.dtype)


def _at(pos, like: torch.Tensor) -> torch.Tensor:
    """The scalar position as a 1-element index on the cache's device (a
    device tensor stays there: no host sync)."""
    return torch.as_tensor(pos, device=like.device).reshape(1).long()


def update_exact(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor, pos):
    """Write one token at scalar position ``pos`` (an int or a 0-d tensor)
    for the whole batch, in place. caches: (B, Smax, KV, hd)."""
    idx = _at(pos, k_cache)
    k_cache.index_copy_(1, idx, k_new[:, None].to(k_cache.dtype))
    v_cache.index_copy_(1, idx, v_new[:, None].to(v_cache.dtype))
    return k_cache, v_cache


def update_pq(k_codes: torch.Tensor, v_codes: torch.Tensor,
              k_new: torch.Tensor, v_new: torch.Tensor, k_cb: torch.Tensor,
              v_cb: torch.Tensor, pos):
    """Encode one token's K/V to 4-bit codes and write them at ``pos`` for
    the whole batch, in place."""
    idx = _at(pos, k_codes)
    k_codes.index_copy_(1, idx, encode_kv(k_new, k_cb)[:, None])
    v_codes.index_copy_(1, idx, encode_kv(v_new, v_cb)[:, None])
    return k_codes, v_codes
