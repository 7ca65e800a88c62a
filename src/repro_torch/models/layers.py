"""Shared NN layers: parameter declarations, norms, RoPE, GQA attention,
FFNs (the port of ``repro/models/layers.py``).

Parameters are declared once as ``ParamSpec`` trees (shape, initializer);
``Params`` materializes a tree as nested ``nn.Module``s that hold the
reference's tensors in the reference's layouts (``wq`` (d, H, hd), ``wo``
(H, hd, d), ...), a list of trees (the reference's stacked layer axis) as an
``nn.ModuleList``, and ``init_params`` fills them by the reference's rule.
The layer functions take such a module and read its tensors by name.

Attention is plain torch matmul and softmax transcribed from the reference,
in its casts (scores rounded to the working type before the f32 softmax,
weights cast back before the value product); f32 products stay in full
f32 (the package turns TF32 off on import). The reference's sharding
constraints have no counterpart here.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig


class ParamSpec(NamedTuple):
    shape: tuple
    init: str = "normal"   # normal | zeros | ones
    scale: float = 1.0     # stddev multiplier for "normal"


class Params(nn.Module):
    """A spec tree as modules: a dict is a ``Params`` whose attributes are
    its keys, a list an ``nn.ModuleList``, a ``ParamSpec`` a parameter
    (uninitialized until ``init_params``)."""

    def __init__(self, specs: dict, *, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        for name, s in specs.items():
            if isinstance(s, ParamSpec):
                self.register_parameter(name, nn.Parameter(
                    torch.empty(s.shape, dtype=dtype, device=device),
                    requires_grad=False))
            elif isinstance(s, list):
                self.add_module(name, nn.ModuleList(
                    Params(x, dtype=dtype, device=device) for x in s))
            else:
                self.add_module(name, Params(s, dtype=dtype, device=device))


def spec_items(specs, prefix: str = ""):
    """(dotted name, spec) of every leaf, in declaration order."""
    items = specs.items() if isinstance(specs, dict) else enumerate(specs)
    for name, s in items:
        path = f"{prefix}{name}"
        if isinstance(s, ParamSpec):
            yield path, s
        else:
            yield from spec_items(s, path + ".")


@torch.no_grad()
def init_params(module: Params, specs, generator: torch.Generator) -> None:
    """Fill ``module`` by the reference's rule: zeros, ones, or a standard
    normal (drawn in f32 on the generator's device) times ``scale /
    sqrt(fan_in)``, fan_in the second-to-last dim (the last for 1-D)."""
    params = dict(module.named_parameters())
    for name, s in spec_items(specs):
        p = params[name]
        if s.init == "zeros":
            p.zero_()
        elif s.init == "ones":
            p.fill_(1.0)
        else:
            fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
            std = s.scale / math.sqrt(max(fan_in, 1))
            x = torch.randn(s.shape, generator=generator,
                            device=generator.device, dtype=torch.float32)
            p.copy_((x * std).to(p.dtype))


def stacked(specs: dict, n: int) -> list:
    """The reference's stacked layer axis: one spec tree a layer."""
    return [specs for _ in range(n)]


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
            ) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * w


def rmsnorm_spec(dim: int) -> ParamSpec:
    return ParamSpec((dim,), "ones")


# ---------------------------------------------------------------------------
# RoPE (from positions, no precomputed tables)
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int. Rotates the two halves."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions.float()[:, :, None] * freq[None, None, :]   # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA, qk-norm, qkv-bias, chunked-causal / decode)
# ---------------------------------------------------------------------------

def attn_specs(cfg: ModelConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    p = {
        "wq": ParamSpec((d, h, hd)),
        "wk": ParamSpec((d, kv, hd)),
        "wv": ParamSpec((d, kv, hd)),
        "wo": ParamSpec((h, hd, d)),
    }
    if cfg.qkv_bias:
        p["bq"] = ParamSpec((h, hd), "zeros")
        p["bk"] = ParamSpec((kv, hd), "zeros")
        p["bv"] = ParamSpec((kv, hd), "zeros")
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_spec(hd)
        p["k_norm"] = rmsnorm_spec(hd)
    return p


def qkv_project(p: Params, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> q (B,S,H,hd), k/v (B,S,KV,hd) with rope/norm applied."""
    q = torch.einsum("bsd,dhk->bshk", x, p.wq)
    k = torch.einsum("bsd,dhk->bshk", x, p.wk)
    v = torch.einsum("bsd,dhk->bshk", x, p.wv)
    if cfg.qkv_bias:
        q = q + p.bq
        k = k + p.bk
        v = v + p.bv
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm, cfg.norm_eps)
        k = rmsnorm(k, p.k_norm, cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _softcap(s: torch.Tensor, cap: float) -> torch.Tensor:
    if cap > 0:
        return cap * torch.tanh(s / cap)
    return s


def full_causal_attention(q, k, v, cfg: ModelConfig) -> torch.Tensor:
    """Reference O(S^2)-memory path for short or ragged sequences."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, s, kvh, g, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k).float()
    scores = _softcap(scores / math.sqrt(hd), cfg.attn_logit_softcap)
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
    scores = scores.masked_fill_(~mask, float("-inf"))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    del scores
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v)
    return out.reshape(b, s, h, hd)


def chunked_causal_attention(q, k, v, cfg: ModelConfig) -> torch.Tensor:
    """Flash-style online-softmax attention over q and kv chunks.

    For each query chunk, the kv chunks up to the causal frontier are
    visited in order and the blocks past it skipped, as the reference's
    ``lax.cond`` does; no O(S^2) buffer. Falls back to the full path under
    the reference's own condition.
    """
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    cq, ckv = cfg.attn_q_chunk, cfg.attn_kv_chunk
    if s % cq or s % ckv or s <= cq:
        return full_causal_attention(q, k, v, cfg)
    nq, nkv = s // cq, s // ckv
    qg = q.reshape(b, nq, cq, kvh, g, hd)
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    outs = []
    for i in range(nq):
        qi = qg[:, i]
        m = torch.full((b, kvh, g, cq), float("-inf"), device=dev)
        l = torch.zeros((b, kvh, g, cq), device=dev)
        acc = torch.zeros((b, kvh, g, cq, hd), device=dev)
        qpos = i * cq + torch.arange(cq, device=dev)
        for j in range(nkv):
            # causal frontier: block j is live iff its first key position
            # is <= the last query position of this q chunk
            if not j * ckv < (i + 1) * cq:
                break
            kj = k[:, j * ckv:(j + 1) * ckv]
            vj = v[:, j * ckv:(j + 1) * ckv]
            sij = torch.einsum("bqkgh,bskh->bkgqs", qi, kj).float()
            sij = _softcap(sij * scale, cfg.attn_logit_softcap)
            kpos = j * ckv + torch.arange(ckv, device=dev)
            causal = qpos[:, None] >= kpos[None, :]
            sij = torch.where(causal, sij, float("-inf"))
            mj = torch.maximum(m, sij.amax(-1))
            # guard fully-masked rows: mj could still be -inf
            mj_safe = torch.where(torch.isfinite(mj), mj, 0.0)
            pij = torch.exp(sij - mj_safe[..., None])
            del sij
            corr = torch.exp(torch.where(torch.isfinite(m), m - mj_safe,
                                         float("-inf")))
            l = l * corr + pij.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskh->bkgqh", pij.to(v.dtype), vj).float()
            m = mj
        out = acc / torch.clamp_min(l, 1e-20)[..., None]   # (B, KV, g, cq, hd)
        outs.append(out.permute(0, 3, 1, 2, 4).to(q.dtype))  # (B, cq, KV, g, hd)
    return torch.stack(outs, dim=1).reshape(b, s, h, hd)


def attention(p: Params, x: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor) -> torch.Tensor:
    """Prefill self-attention over a full sequence."""
    q, k, v = qkv_project(p, x, cfg, positions)
    out = chunked_causal_attention(q, k, v, cfg)
    return torch.einsum("bshk,hkd->bsd", out, p.wo)


def decode_attention_scores(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, cfg: ModelConfig,
                            position: torch.Tensor) -> torch.Tensor:
    """One-token attention vs an ALREADY-UPDATED (B, Skv, KV, hd) cache.

    q: (B, H, hd); position: (B,) int -- the current token's position
    (inclusive: the token attends to itself, so the caller writes the new
    K/V into the cache before scoring). Returns (B, H, hd).
    """
    b, h, hd = q.shape
    kvh = k_cache.shape[2]
    g = h // kvh
    qg = q.reshape(b, 1, kvh, g, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k_cache).float()
    scores = _softcap(scores / math.sqrt(hd), cfg.attn_logit_softcap)
    skv = k_cache.shape[1]
    valid = (torch.arange(skv, device=q.device)[None, :]
             <= position[:, None].long())                     # (B, Skv)
    scores = torch.where(valid[:, None, None, None, :], scores, float("-inf"))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v_cache)
    return out.reshape(b, h, hd)


# ---------------------------------------------------------------------------
# FFN variants
# ---------------------------------------------------------------------------

def ffn_specs(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_type == "swiglu":
        return {"wi_gate": ParamSpec((d, f)), "wi_up": ParamSpec((d, f)),
                "wo": ParamSpec((f, d))}
    return {"wi": ParamSpec((d, f)), "wo": ParamSpec((f, d))}


def ffn(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.mlp_type == "swiglu":
        h = F.silu(x @ p.wi_gate) * (x @ p.wi_up)
    elif cfg.mlp_type == "gelu":   # jax.nn.gelu's default: the tanh form
        h = F.gelu(x @ p.wi, approximate="tanh")
    elif cfg.mlp_type == "relu2":  # nemotron-4 squared ReLU
        h = torch.square(F.relu(x @ p.wi))
    else:
        raise ValueError(cfg.mlp_type)
    return h @ p.wo
