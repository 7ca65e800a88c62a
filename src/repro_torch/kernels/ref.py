"""Plain PyTorch oracle of the fast-scan ADC (counterpart of
``repro.kernels.ref``).

The semantic ground truth: int32 sums of u8 LUT entries gathered by 4-bit
codes. It is the ``'ref'`` scan impl and the function the K3/K5/K6 kernels
are held to bit for bit (integer arithmetic, no tolerance).

On the card the gather's int64 indices would cost several GB at serving
shapes (G=4096 groups x cap 4096 x M 16), so the grouped sums run in chunks
of groups of at most ``_CHUNK_ELEMS`` looked-up entries.
"""
from __future__ import annotations

import torch

# looked-up LUT entries per chunk: bounds the int64 index to 128 MiB
_CHUNK_ELEMS = 1 << 24


def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """(..., M//2) uint8 -> (..., M) int32, lo nibble = even m."""
    lo = (packed & 0xF).to(torch.int32)
    hi = ((packed >> 4) & 0xF).to(torch.int32)
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], -1)


def _lut_sums(table: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """table (B, M, 16) u8 x codes (B or 1, N, M//2) u8 -> (B, N) i32."""
    b, m, _ = table.shape
    n = codes.shape[1]
    idx = unpack_nibbles(codes).long() + 16 * torch.arange(m,
                                                           device=codes.device)
    idx = idx.expand(b, n, m).reshape(b, n * m)
    got = torch.gather(table.reshape(b, m * 16), 1, idx)
    return got.reshape(b, n, m).sum(dim=-1, dtype=torch.int32)


def _chunked(table: torch.Tensor, codes: torch.Tensor, shared: bool
             ) -> torch.Tensor:
    g, m, _ = table.shape
    n = codes.shape[-2]
    out = torch.empty((g, n), dtype=torch.int32, device=table.device)
    step = max(1, _CHUNK_ELEMS // max(1, n * m))
    for s in range(0, g, step):
        c = codes[None] if shared else codes[s:s + step]
        out[s:s + step] = _lut_sums(table[s:s + step], c)
    return out


def fastscan_distances_ref(table_q8: torch.Tensor,
                           packed_codes: torch.Tensor) -> torch.Tensor:
    """ADC oracle: (Q, M, 16) u8 x (N, M//2) u8 -> (Q, N) i32,
    acc[q, n] = sum_m table_q8[q, m, codes[n, m]]."""
    return _chunked(table_q8, packed_codes, shared=True)


def fastscan_grouped_ref(table_q8: torch.Tensor,
                         packed_codes: torch.Tensor) -> torch.Tensor:
    """Grouped ADC oracle, each group with its own LUT and its own codes:
    (G, M, 16) u8 x (G, N, M//2) u8 -> (G, N) i32."""
    return _chunked(table_q8, packed_codes, shared=False)


def fastscan_block_min_ref(table_q8: torch.Tensor, packed_codes: torch.Tensor,
                           block: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused scan + per-block argmin oracle: (min (Q, N//block) i32, argmin
    (Q, N//block) i32 global ids, first occurrence among equal sums)."""
    q, n = table_q8.shape[0], packed_codes.shape[0]
    if n % block:
        raise ValueError(f"N={n} must be a multiple of block={block}")
    d = fastscan_distances_ref(table_q8, packed_codes).reshape(q, n // block,
                                                               block)
    mins, amin = torch.min(d, dim=-1)
    base = torch.arange(n // block, dtype=torch.int32,
                        device=d.device) * block
    return mins, amin.to(torch.int32) + base
