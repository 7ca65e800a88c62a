"""PQ gradient compression with error feedback: the paper's 4-bit encode
and decode reused as a distributed-optimization trick (the port of
``repro/train/grad_compress.py``).

For slow cross-pod links, gradients are 4-bit-PQ encoded before the
exchange: each gradient tensor is cut into (N, dsub) rows and quantized
against a per-tensor 16-entry codebook (k-means on a sample of rows), and
only the 4-bit codes and the small codebook cross the wire (7.9x smaller
than f32 at dsub = 4). The residual ``g - decode(encode(g))`` is carried
into the next step's gradient (error feedback), which keeps SGD
converging.

This module is the codec and the error-feedback state. The row sample and
the k-means draw from a ``torch.Generator`` (the port's
``core.kmeans.kmeans``); the reference draws from ``jax.random``, so the
two packages train different codebooks and agree in reconstruction error,
not in bits. Packing, unpacking and the error-feedback arithmetic are the
reference's, exactly. A gradient tree is a dict of tensors (a training
state's gradients are keyed by the parameters' dotted names, one leaf a
layer where the reference has one stacked leaf a parameter).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.kmeans import kmeans

# rows whose distances to the 16 codewords are formed at once in
# ``compress`` (bounds the (rows, 16) f32 buffer at 256 MB)
ASSIGN_ROWS = 1 << 22


class PQGradCodec(NamedTuple):
    dsub: int = 4          # gradient sub-vector length
    k: int = 16            # 4-bit codebooks
    iters: int = 5         # k-means refinement per step (cheap, on samples)
    sample: int = 4096     # rows sampled for codebook training


class CompressedGrad(NamedTuple):
    codes: torch.Tensor     # (ceil(N / 2),) uint8: two 4-bit codes a byte
    codebook: torch.Tensor  # (16, dsub) f32
    shape: tuple            # original shape
    nrows: int


def _rows(g: torch.Tensor, dsub: int) -> torch.Tensor:
    flat = g.reshape(-1).float()
    pad = (-flat.shape[0]) % dsub
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, dsub)


def compress(generator: torch.Generator, g: torch.Tensor,
             codec: PQGradCodec) -> CompressedGrad:
    """Encode ``g`` against a codebook trained on ``codec.sample`` rows
    drawn (with replacement) from ``generator``, a CPU one."""
    rows = _rows(g, codec.dsub)
    n = rows.shape[0]
    idx = torch.randint(0, n, (min(codec.sample, n),),
                        generator=generator).to(rows.device)
    cb = kmeans(rows[idx], codec.k, codec.iters,
                generator=generator).centroids              # (16, dsub)
    c2 = torch.sum(cb * cb, dim=-1)[None]
    codes = torch.empty(n + n % 2, dtype=torch.uint8, device=rows.device)
    codes[n:] = 0
    for s in range(0, n, ASSIGN_ROWS):
        r = rows[s:s + ASSIGN_ROWS]
        d = torch.sum(r * r, dim=-1, keepdim=True) - 2.0 * r @ cb.T + c2
        codes[s:s + r.shape[0]] = torch.argmin(d, dim=-1).to(torch.uint8)
    packed = codes[0::2] | (codes[1::2] << 4)
    return CompressedGrad(packed, cb, tuple(g.shape), n)


def decompress(c: CompressedGrad) -> torch.Tensor:
    lo = (c.codes & 0xF).long()
    hi = ((c.codes >> 4) & 0xF).long()
    codes = torch.stack([lo, hi], dim=-1).reshape(-1)[:c.nrows]
    flat = c.codebook[codes].reshape(-1)                  # (N * dsub,)
    size = 1
    for s in c.shape:
        size *= s
    return flat[:size].reshape(c.shape)


def compressed_bytes(c: CompressedGrad) -> int:
    return int(c.codes.numel()) + int(c.codebook.numel()) * 4


def ef_step(generator: torch.Generator, grads: dict[str, torch.Tensor],
            error: dict[str, torch.Tensor], codec: PQGradCodec
            ) -> tuple[dict, dict, dict]:
    """Error-feedback compression of a gradient tree.

    Returns (decoded grads to feed the optimizer, the new error state,
    stats). Semantics: send = compress(g + e); e' = (g + e) - decode(send).
    """
    out, new_err = {}, {}
    raw_bytes = comp_bytes = 0
    for name, g in grads.items():
        target = g.float() + error[name]
        c = compress(generator, target, codec)
        dec = decompress(c).float()
        out[name] = dec.to(g.dtype)
        new_err[name] = target - dec
        raw_bytes += g.numel() * 4
        comp_bytes += compressed_bytes(c)
    stats = {"raw_bytes": raw_bytes, "compressed_bytes": comp_bytes,
             "ratio": raw_bytes / max(comp_bytes, 1)}
    return out, new_err, stats


def init_error(params) -> dict[str, torch.Tensor]:
    """Zero f32 error state keyed like ``params`` (a module's parameters
    or a dict of tensors)."""
    named = (params.items() if isinstance(params, dict)
             else params.named_parameters())
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in named}
