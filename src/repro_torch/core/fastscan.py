"""4-bit PQ fast-scan: u8-quantized LUTs and nibble-packed codes
(counterpart of ``repro.core.fastscan``; the flat-index search API is not
ported yet).

Conventions: tables float32 (Q, M, 16) -> u8 entries; packed codes
(N, M//2) u8 with the low nibble holding the even sub-space; integer
accumulations int32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class QuantizedLUT(NamedTuple):
    """Affine-quantized ADC tables for a batch of queries.

    table_q8: (Q, M, 16) uint8   quantized entries
    scale:    (Q,)       float32 global scale per query
    bias:     (Q, M)     float32 per-sub-space bias (the per-row minimum)

    Reconstruction: dist(q, n) ~= scale[q] * acc[q, n] + sum_m bias[q, m].
    """

    table_q8: torch.Tensor
    scale: torch.Tensor
    bias: torch.Tensor


def quantize_lut(table: torch.Tensor) -> QuantizedLUT:
    """Scalar-quantize float LUTs (Q, M, K) -> u8, faiss PQFastScan style.

    Per-row bias = row min; one global scale per query so the largest single
    entry maps to 255. ``torch.round`` rounds half to even, as ``jnp.round``
    does, and ``max(maxval, 1e-20) / 255`` is kept exactly as the reference
    writes it, so the u8 tables agree with the reference's wherever the f32
    inputs do.
    """
    squeeze = table.ndim == 2
    if squeeze:
        table = table[None]
    bias = torch.amin(table, dim=-1)                       # (Q, M)
    shifted = table - bias[..., None]
    maxval = torch.amax(shifted, dim=(-2, -1))             # (Q,)
    scale = torch.clamp_min(maxval, 1e-20) / 255.0
    q8 = torch.clamp(torch.round(shifted / scale[..., None, None]), 0, 255
                     ).to(torch.uint8)
    out = QuantizedLUT(q8, scale.float(), bias.float())
    if squeeze:
        out = QuantizedLUT(out.table_q8[0], out.scale[0], out.bias[0])
    return out


def dequantize_acc(qlut: QuantizedLUT, acc: torch.Tensor) -> torch.Tensor:
    """int32 accumulations (Q, N) -> approximate float distances (Q, N)."""
    if qlut.table_q8.ndim == 3:
        return (qlut.scale[:, None] * acc.float()
                + torch.sum(qlut.bias, dim=-1)[:, None])
    return qlut.scale * acc.float() + torch.sum(qlut.bias)


def pack_codes(codes: torch.Tensor) -> torch.Tensor:
    """(N, M) int codes in [0,16) -> (N, M//2) uint8, lo nibble = even m."""
    n, m = codes.shape
    if m % 2:
        raise ValueError(f"M={m} must be even for nibble packing")
    c = codes.to(torch.uint8)
    return c[:, 0::2] | (c[:, 1::2] << 4)


def unpack_codes(packed: torch.Tensor) -> torch.Tensor:
    """(N, M//2) uint8 -> (N, M) int32."""
    lo = (packed & 0xF).to(torch.int32)
    hi = ((packed >> 4) & 0xF).to(torch.int32)
    return torch.stack([lo, hi], dim=-1).reshape(packed.shape[0], -1)
