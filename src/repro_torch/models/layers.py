"""Shared NN layers: parameter declarations, norms, RoPE, GQA attention,
FFNs (the port of ``repro/models/layers.py``).

Parameters are declared once as ``ParamSpec`` trees (shape, initializer);
``Params`` materializes a tree as nested ``nn.Module``s that hold the
reference's tensors in the reference's layouts (``wq`` (d, H, hd), ``wo``
(H, hd, d), ...), a list of trees (the reference's stacked layer axis) as an
``nn.ModuleList``, and ``init_params`` fills them by the reference's rule.
Parameters are registered frozen, as serving wants them;
``set_trainable`` turns autograd on for training, and ``checkpointed``
is the remat primitive of the stacks and the loss.
The layer functions take such a module and read its tensors by name.

Attention is plain torch matmul and softmax transcribed from the reference,
in its casts (scores rounded to the working type before the f32 softmax,
weights cast back before the value product); f32 products stay in full
f32 (the package turns TF32 off on import).

Each spec names its dimensions' logical sharding axes (``axes``, the
reference's), and the layers pin their activations with
``launch.sharding.constrain`` where the reference does. A stacked layer
is a list entry here, not a leading axis, so its axes omit the
reference's "stack" (replicated by every rules table) and ``tree_key``
maps its name to the reference's path.

Over a mesh of several ranks the parameters and activations are
DTensors and the GEMM glue runs on DTensor's own rules: a projection onto
sharded heads or FFN columns needs no collective, and the product that
contracts them (``wo``, the FFN's second matrix) is a partial sum that
the next ``constrain`` all-reduces over "model". The attention itself
runs on each rank's heads (``_over_heads``: the keys and values taken
whole over the heads first, an all-gather over "model" where the KV heads
are sharded and the query heads are not), and the decode step over a
cache sharded on its positions combines per-rank softmax partials
(``_decode_over_ranks``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.launch import sharding as shd
from repro_torch.launch.sharding import constrain
from repro_torch.models import kvcache as kvc
from repro_torch.models.config import ModelConfig


class ParamSpec(NamedTuple):
    shape: tuple
    axes: tuple | None = None  # logical axis names, len == ndim (or None)
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


def set_trainable(module: Params, on: bool = True) -> Params:
    """Turn autograd on for every parameter of ``module`` (training), or
    back off. ``Params`` registers them frozen, as serving wants them."""
    for p in module.parameters():
        p.requires_grad_(on)
    return module


def tree_key(name: str) -> tuple[str, int | None]:
    """A module's dotted parameter name -> (the reference's ``/``-joined
    path key, its index on a stacked list's leading axis or None)."""
    parts = name.split(".")
    for i, part in enumerate(parts):
        if part.isdigit():
            return "/".join(parts[:i] + parts[i + 1:]), int(part)
    return "/".join(parts), None


def checkpointed(fn, *args):
    """``fn(*args)`` with its activations recomputed in backward
    (``torch.utils.checkpoint``, non-reentrant) while autograd records;
    a plain call otherwise (serving, inference mode). The recompute runs
    under the mesh and rules active at the call (``sharding.use_mesh``
    is a thread's, and the card's autograd engine recomputes on a thread
    of its own)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=shd.recompute_context)
    return fn(*args)


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


def param_axes(specs) -> dict:
    """{dotted parameter name: its logical axes} of a spec tree, the keys
    of ``Params(specs).named_parameters()``."""
    return {name: s.axes for name, s in spec_items(specs)}


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


def rmsnorm_spec(dim: int, axis: str | None = "embed") -> ParamSpec:
    return ParamSpec((dim,), (axis,), "ones")


# ---------------------------------------------------------------------------
# RoPE (from positions, no precomputed tables)
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int. Rotates the two halves.
    A placed x sharded on its head_dim over an even number of ranks is
    rotated on each rank's slice (``_rope_over_head_dim``)."""
    mdim = _head_dim_shard(x, 3)
    if mdim is not None and x.device_mesh.size(mdim) % 2 == 0:
        return _rope_over_head_dim(x, positions, theta, mdim)
    hd = x.shape[-1]
    half = hd // 2
    freq = shd.lift(theta ** (-torch.arange(0, half, dtype=torch.float32,
                                            device=x.device) / half),
                    positions)
    ang = positions.float()[:, :, None] * freq[None, None, :]   # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _rope_over_head_dim(x, positions, theta: float, mdim: int):
    """``rope`` of x sharded on its head_dim over the n (even) ranks of
    mesh dimension ``mdim``: rank r holds dims [r hd/n, (r + 1) hd/n), so
    the rotation's partner of each of its dims (i and i + hd/2) lies on
    rank r + n/2 (mod n). The two swap their slices (one collective
    permute) and each rotates its own: the same products, element for
    element, as the one-rank rotation."""
    from torch.distributed.tensor import Replicate
    dm = x.device_mesh
    n, r = dm.size(mdim), dm.get_coordinate()[mdim]
    hd = x.shape[-1]
    half, hl = hd // 2, hd // n
    xp = tuple(p if p.is_shard() and p.dim < 3 and i != mdim else
               Replicate() for i, p in enumerate(x.placements))
    xp = shd.shard_on(xp, 3, mdim)
    pp = shd.keep_shard(xp, 0)
    lo = (r % (n // 2)) * hl

    def body(xl, pos):
        freq = theta ** (-(lo + torch.arange(0, hl, dtype=torch.float32,
                                             device=xl.device)) / half)
        ang = pos.float()[:, :, None] * freq[None, None, :]
        cos = torch.cos(ang)[:, :, None, :]
        sin = torch.sin(ang)[:, :, None, :]
        own = xl.float()
        other = shd.permute(own.contiguous(), dm, mdim,
                            [(i + n // 2) % n for i in range(n)])
        if r < n // 2:      # the first half's dims: x1 here, x2 the other's
            out = own * cos - other * sin
        else:
            out = other * sin + own * cos
        return out.to(xl.dtype)

    return shd.local_map(body, xp, (xp, pp), x, positions)


# ---------------------------------------------------------------------------
# attention (GQA, qk-norm, qkv-bias, chunked-causal / decode)
# ---------------------------------------------------------------------------

def attn_specs(cfg: ModelConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    p = {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        p["bq"] = ParamSpec((h, hd), ("heads", "head_dim"), "zeros")
        p["bk"] = ParamSpec((kv, hd), ("kv_heads", "head_dim"), "zeros")
        p["bv"] = ParamSpec((kv, hd), ("kv_heads", "head_dim"), "zeros")
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_spec(hd, "head_dim")
        p["k_norm"] = rmsnorm_spec(hd, "head_dim")
    return p


def project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., D) times w (D, H, hd) -> (..., H, hd), the reference's
    ``einsum("bsd,dhk->bshk")``, as one matmul over w's trailing dims
    flattened (over a mesh, DTensor takes a matmul's rule from its cache;
    an einsum it derives anew through its decomposition at every call).
    A placed w sharded on its head_dim (heads that do not divide the
    model axis) is multiplied on each rank's slice (``_on_head_dim``):
    the flattened trailing dims would not keep that sharding, and DTensor
    would gather the weight."""
    mdim = _head_dim_shard(w, 2)
    if mdim is not None:
        return _on_head_dim(project, x, w, mdim, 2, False)
    out = x @ w.reshape(w.shape[0], -1)
    if shd.is_placed(out):
        # DTensor may shard the flattened (H, hd) columns over a mesh dim
        # whose size does not divide the heads (the KV projection of 8
        # heads on a 16-wide axis), which the view to (H, hd) cannot
        # keep: there they are taken whole
        dm, last = out.device_mesh, out.ndim - 1
        split = [i for i, p in enumerate(out.placements)
                 if p.is_shard(last) and w.shape[1] % dm.size(i)]
        if split:
            from torch.distributed.tensor import Replicate
            out = out.redistribute(placements=tuple(
                Replicate() if i in split else p
                for i, p in enumerate(out.placements)))
    return out.view(*out.shape[:-1], *w.shape[1:])


def unproject(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y (..., H, hd) times w (H, hd, D) -> (..., D), the reference's
    ``einsum("bshk,hkd->bsd")``, as one matmul (``project``'s reason). A
    placed w sharded on its head_dim contracts each rank's slice: a
    partial sum over that mesh dimension, which the caller's
    ``constrain`` all-reduces."""
    mdim = _head_dim_shard(w, 1)
    if mdim is not None:
        return _on_head_dim(unproject, y, w, mdim, 1, True)
    return y.reshape(*y.shape[:-2], -1) @ w.reshape(-1, w.shape[-1])


def _head_dim_shard(w, dim: int) -> int | None:
    """The mesh dimension of more than one rank that shards the placed
    ``w``'s head_dim (its dim ``dim``), or None."""
    if not shd.is_placed(w):
        return None
    return shd.shard_offset(w, dim)[1]


def _on_head_dim(fn, x, w, mdim: int, wdim: int, contracts: bool):
    """``fn(x, w)`` on each rank's head_dim slice along mesh dimension
    ``mdim``: w whole but for its head_dim (``wdim``); x keeps its batch
    shards and is whole elsewhere, or, where ``fn`` ``contracts`` x's
    (..., H, hd), sliced on its head_dim. The output is sharded on its
    head_dim (the last dim) or, where ``contracts``, a partial sum over
    ``mdim``."""
    from torch.distributed.tensor import Partial, Replicate
    lead = x.ndim - (2 if contracts else 1)   # the dims fn does not read
    xp = tuple(p if p.is_shard() and p.dim < lead and i != mdim
               else Replicate() for i, p in enumerate(x.placements))
    wp = shd.shard_on((Replicate(),) * w.device_mesh.ndim, wdim, mdim)
    if contracts:
        xp = shd.shard_on(xp, x.ndim - 1, mdim)
        out = tuple(Partial() if i == mdim else p for i, p in enumerate(xp))
    else:
        out = shd.shard_on(xp, x.ndim, mdim)
    return shd.local_map(fn, out, (xp, wp), x, w)


def qkv_project(p: Params, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> q (B,S,H,hd), k/v (B,S,KV,hd) with rope/norm applied."""
    q = project(x, p.wq)
    k = project(x, p.wk)
    v = project(x, p.wv)
    if cfg.qkv_bias:
        q = q + p.bq
        k = k + p.bk
        v = v + p.bv
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm, cfg.norm_eps)
        k = rmsnorm(k, p.k_norm, cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    q = constrain(q, "batch", None, "heads", "head_dim")
    k = constrain(k, "batch", None, "kv_heads", "head_dim")
    v = constrain(v, "batch", None, "kv_heads", "head_dim")
    return q, k, v


def _softcap(s: torch.Tensor, cap: float) -> torch.Tensor:
    if cap > 0:
        return cap * torch.tanh(s / cap)
    return s


def _whole(s: torch.Tensor) -> torch.Tensor:
    return s


def full_causal_attention(q, k, v, cfg: ModelConfig, *,
                          head_dim: int | None = None,
                          psum=_whole) -> torch.Tensor:
    """Reference O(S^2)-memory path for short or ragged sequences.
    ``head_dim`` and ``psum``: a rank's slice of head_dim
    (``_over_head_dim``), the whole head_dim and the sum of the ranks'
    partial scores."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, s, kvh, g, hd)
    scores = psum(torch.einsum("bqkgh,bskh->bkgqs", qg, k)).float()
    scores = _softcap(scores / math.sqrt(head_dim or hd),
                      cfg.attn_logit_softcap)
    mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=q.device))
    scores = scores.masked_fill_(~mask, float("-inf"))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    del scores
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v)
    return out.reshape(b, s, h, hd)


def chunked_causal_attention(q, k, v, cfg: ModelConfig, *,
                             head_dim: int | None = None,
                             psum=_whole) -> torch.Tensor:
    """Flash-style online-softmax attention over q and kv chunks.

    For each query chunk, the kv chunks up to the causal frontier are
    visited in order and the blocks past it skipped, as the reference's
    ``lax.cond`` does; no O(S^2) buffer. Falls back to the full path under
    the reference's own condition. Placed q, k, v run on each rank's
    heads (``_over_heads``) or, sharded on head_dim, on each rank's slice
    of it (``_over_head_dim``: ``head_dim`` the whole, ``psum`` the sum
    of the ranks' partial scores of a block).
    """
    if shd.is_placed(q):
        mdim = _head_dim_shard(q, 3)
        if mdim is not None and not any(p.is_shard(2)
                                        for p in q.placements):
            return _over_head_dim(chunked_causal_attention, q, k, v, cfg,
                                  mdim)
        return _over_heads(chunked_causal_attention, q, k, v, cfg)
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    cq, ckv = cfg.attn_q_chunk, cfg.attn_kv_chunk
    if s % cq or s % ckv or s <= cq:
        return full_causal_attention(q, k, v, cfg, head_dim=head_dim,
                                     psum=psum)
    nq, nkv = s // cq, s // ckv
    qg = q.reshape(b, nq, cq, kvh, g, hd)
    scale = 1.0 / math.sqrt(head_dim or hd)
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
            sij = psum(torch.einsum("bqkgh,bskh->bkgqs", qi, kj)).float()
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


def _over_head_dim(fn, q, k, v, cfg: ModelConfig, mdim: int
                   ) -> torch.Tensor:
    """``fn(q, k, v, cfg)`` (an attention over whole sequences) on each
    rank's slice of head_dim along mesh dimension ``mdim`` (the rules'
    branch for heads that do not divide the model axis): q, k and v keep
    their batch placements and are sharded on head_dim over ``mdim``,
    whole elsewhere. Each rank contracts its slice of every head, and the
    partial scores of each block are summed over ``mdim`` before the cast
    to f32, the softcap, the mask and the softmax: an all-reduce in q's
    dtype, where the reference's partitioner puts it (on the dot's output,
    before its ``astype``). The values are weighted on the rank's slice.
    The output is sharded on head_dim as q is, which ``unproject``
    contracts."""
    from torch.distributed.tensor import Replicate
    dm = q.device_mesh
    qp = shd.shard_on(tuple(p if p.is_shard(0) and i != mdim else
                            Replicate() for i, p in enumerate(q.placements)),
                      3, mdim)
    hd = q.shape[-1]

    def body(ql, kl, vl):
        return fn(ql, kl, vl, cfg, head_dim=hd,
                  psum=lambda s: shd.all_reduce(s, dm, mdim, whole=False))

    return shd.local_map(body, qp, (qp, qp, qp), q, k, v)


def _over_heads(fn, q, k, v, cfg: ModelConfig) -> torch.Tensor:
    """``fn(q, k, v, cfg)`` (an attention over whole sequences) on each
    rank's query heads: q (B, S, H, hd) keeps its batch and heads
    placements; k and v are sharded on their KV heads alike where those
    divide as the query heads do, else taken whole over the heads (an
    all-gather over "model") and sliced to the rank's KV heads; all else
    is whole. The output is placed as q."""
    rep = shd.replicate(q)
    qp = tuple(p if p.is_shard(0) or p.is_shard(2) else rep[i]
               for i, p in enumerate(q.placements))
    heads = [i for i, p in enumerate(qp) if p.is_shard(2)]
    if len(heads) > 1:
        raise NotImplementedError(f"heads sharded over the mesh dims {heads}")
    n = q.device_mesh.size(heads[0]) if heads else 1
    h, kvh = q.shape[2], k.shape[2]
    g, hl = h // kvh, h // n
    kv_split = kvh % n == 0
    kp = tuple(p if p.is_shard(0) or (kv_split and p.is_shard(2)) else rep[i]
               for i, p in enumerate(qp))
    if not kv_split and hl % g and g % hl:
        raise NotImplementedError(f"{h} query heads over {n} ranks split "
                                  f"their groups of {g}")
    r = q.device_mesh.get_coordinate()[heads[0]] if heads else 0

    def body(ql, kl, vl):
        if not kv_split:
            lo, hi = r * hl // g, ((r + 1) * hl - 1) // g + 1
            kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
        return fn(ql, kl, vl, cfg)

    # keys and values whole over the heads' mesh dim, each rank reading
    # its heads' groups: their gradients partial sums there
    kg = kp if kv_split else shd.partial_on(kp, heads)
    return shd.local_map(body, qp, (qp, kp, kp), q, k, v,
                         grads=(qp, kg, kg))


def attention(p: Params, x: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor) -> torch.Tensor:
    """Prefill self-attention over a full sequence."""
    q, k, v = qkv_project(p, x, cfg, positions)
    out = chunked_causal_attention(q, k, v, cfg)
    return constrain(unproject(out, p.wo), "batch", "seq", "embed")


def decode_attention_scores(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, cfg: ModelConfig,
                            position: torch.Tensor) -> torch.Tensor:
    """One-token attention vs an ALREADY-UPDATED (B, Skv, KV, hd) cache.

    q: (B, H, hd); position: (B,) int -- the current token's position
    (inclusive: the token attends to itself, so the caller writes the new
    K/V into the cache before scoring). Returns (B, H, hd).
    """
    if shd.is_placed(k_cache):
        return _decode_over_ranks(q, k_cache, v_cache, cfg, position)
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


def _decode_over_ranks(q, k_cache, v_cache, cfg: ModelConfig, position
                       ) -> torch.Tensor:
    """``decode_attention_scores`` over a placed cache (sharded on its
    batch and positions, the heads whole). q is taken whole over the
    heads (an all-gather over "model"). Where the positions are sharded,
    each rank takes the softmax's partials over its own positions, their
    max m_r, sum l_r and value sum acc_r (f32, p rounded to q's type for
    the product); one all-gather over the positions' mesh axis brings
    every rank's, and each rank combines them in rank order, ``sum
    e^(m_r - m*) acc_r / sum e^(m_r - m*) l_r``. Unsharded positions
    (one rank) run the one-rank function on the local rows."""
    kvc.rows_whole(k_cache)
    offset, mdim = shd.shard_offset(k_cache, 1)
    rows = shd.keep_shard(k_cache.placements, 0)
    dm = k_cache.device_mesh

    def body(ql, kl, vl, pos):
        if mdim is None:
            return decode_attention_scores(ql, kl, vl, cfg, pos)
        b, h, hd = ql.shape
        kvh = kl.shape[2]
        qg = ql.reshape(b, 1, kvh, h // kvh, hd)
        s = torch.einsum("bqkgh,bskh->bkgqs", qg, kl).float()
        s = _softcap(s / math.sqrt(hd), cfg.attn_logit_softcap)
        valid = (offset + torch.arange(kl.shape[1], device=ql.device)[None]
                 <= pos[:, None].long())
        s = torch.where(valid[:, None, None, None, :], s, float("-inf"))
        m = s.amax(-1)                             # (B, KV, g, 1)
        p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0)[..., None])
        acc = torch.einsum("bkgqs,bskh->bkgqh", p.to(ql.dtype), vl).float()
        part = torch.cat([m[..., None], p.sum(-1)[..., None], acc], -1)
        parts = shd.all_gather(part[None], 0, dm, mdim)
        top = parts[..., 0].amax(0)
        w = torch.exp(parts[..., 0] - torch.where(torch.isfinite(top), top,
                                                  0.0))
        den = (w * parts[..., 1]).sum(0).clamp_min(1e-20)
        out = (w[..., None] * parts[..., 2:]).sum(0) / den[..., None]
        return out.to(ql.dtype).reshape(b, h, hd)

    return shd.local_map(body, rows, (rows, k_cache.placements,
                                      v_cache.placements, rows),
                         q, k_cache, v_cache, position)


# ---------------------------------------------------------------------------
# FFN variants
# ---------------------------------------------------------------------------

def ffn_specs(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_type == "swiglu":
        return {"wi_gate": ParamSpec((d, f), ("embed", "mlp")),
                "wi_up": ParamSpec((d, f), ("embed", "mlp")),
                "wo": ParamSpec((f, d), ("mlp", "embed"))}
    return {"wi": ParamSpec((d, f), ("embed", "mlp")),
            "wo": ParamSpec((f, d), ("mlp", "embed"))}


def ffn(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.mlp_type == "swiglu":
        h = F.silu(x @ p.wi_gate) * (x @ p.wi_up)
    elif cfg.mlp_type == "gelu":   # jax.nn.gelu's default: the tanh form
        h = F.gelu(x @ p.wi, approximate="tanh")
    elif cfg.mlp_type == "relu2":  # nemotron-4 squared ReLU
        h = torch.square(F.relu(x @ p.wi))
    else:
        raise ValueError(cfg.mlp_type)
    h = constrain(h, "batch", None, "mlp")
    return constrain(h @ p.wo, "batch", "seq", "embed")
