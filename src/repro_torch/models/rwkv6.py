"""RWKV-6 "Finch" block: linear attention with data-dependent decay (the
port of ``repro/models/rwkv6.py``).

Attention-free: the per-head state is a fixed (hd x hd) matrix, so decode
is O(1) a token; prefill uses the same chunked decay-product scheme as
SSD, intra-chunk L x L matrices and an f32 state carried over chunks.

Recurrence (per head, key channel i, value channel j):
    o_t = r_t . S_{t-1} + (r_t . (u * k_t)) v_t
    S_t = diag(w_t) S_{t-1} + k_t (x) v_t
with w_t = exp(-exp(dd_t)) per channel, and r/k/v/g from a data-dependent
token shift (DDLerp with a small LoRA). Plain torch ops in the reference's
casts.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.launch import sharding as shd
from repro_torch.launch.sharding import constrain
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params, ParamSpec, rmsnorm

MIXES = ("w", "k", "v", "r", "g")


def rwkv_specs(cfg: ModelConfig) -> dict:
    d, r = cfg.d_model, cfg.rwkv_lora
    nh, hd = cfg.rwkv_nheads, cfg.rwkv_head_dim
    f = cfg.d_ff
    return {
        # time mix (the attention analogue)
        "mu_base": ParamSpec((d,), ("embed",), "zeros"),
        "mu": ParamSpec((5, d), (None, "embed"), "zeros"),
        "lora_a": ParamSpec((d, 5 * r), ("embed", "lora"), scale=0.1),
        "lora_b": ParamSpec((5, r, d), (None, "lora", "embed"), scale=0.1),
        "decay_base": ParamSpec((d,), ("embed",), "zeros"),
        "decay_a": ParamSpec((d, r), ("embed", "lora"), scale=0.1),
        "decay_b": ParamSpec((r, d), ("lora", "embed"), scale=0.1),
        "wr": ParamSpec((d, d), ("embed", "heads")),
        "wk": ParamSpec((d, d), ("embed", "heads")),
        "wv": ParamSpec((d, d), ("embed", "heads")),
        "wg": ParamSpec((d, d), ("embed", "heads")),
        "wo": ParamSpec((d, d), ("heads", "embed")),
        "u": ParamSpec((nh, hd), ("ssm_heads", None), scale=0.5),
        "ln_x": ParamSpec((d,), ("embed",), "ones"),
        # channel mix (the FFN analogue)
        "cm_mu_k": ParamSpec((d,), ("embed",), "zeros"),
        "cm_mu_r": ParamSpec((d,), ("embed",), "zeros"),
        "cm_wk": ParamSpec((d, f), ("embed", "mlp")),
        "cm_wv": ParamSpec((f, d), ("mlp", "embed")),
        "cm_wr": ParamSpec((d, d), ("embed", None)),
    }


def _shift(x: torch.Tensor, prev: torch.Tensor | None = None) -> torch.Tensor:
    """Token shift: x_{t-1}, zero- or carry-padded. x: (B, S, D)."""
    first = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None, :]
    return torch.cat([first, x[:, :-1]], dim=1)


def _ddlerp(p: Params, x: torch.Tensor, sx: torch.Tensor) -> dict:
    """The data-dependent token-shift mixes for w/k/v/r/g: (B, S, D) each."""
    base = x + sx * p.mu_base
    r = p.lora_a.shape[1] // 5
    lora = torch.tanh(_lora_in(base, p.lora_a))                 # (B, S, 5r)
    lora = lora.reshape(*lora.shape[:-1], 5, r)
    adj = _lora_out(lora, p.lora_b)                             # (B, S, 5, D)
    return {name: x + sx * (p.mu[i] + adj[:, :, i])
            for i, name in enumerate(MIXES)}


def _lora_in(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, D) x (D, 5r) -> (B, S, 5r). Placed, on each rank's rows with
    the weight whole (gathered over "data" where the training rules shard
    its embed dim): DTensor would otherwise shard the 5r columns over
    "model", which the split into the 5 mixes cannot keep where the ranks
    do not divide 5."""
    if not shd.is_placed(w):
        return x @ w
    return _on_rows(lambda a, t: a @ t, x, w)


def _lora_out(lora: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, 5, r) x (5, r, D) -> (B, S, 5, D). Placed, on each rank's
    rows with the weight whole: DTensor derives an einsum's rule anew at
    every call."""
    if not shd.is_placed(w):
        return torch.einsum("bsmr,mrd->bsmd", lora, w)
    return _on_rows(lambda x, t: torch.einsum("bsmr,mrd->bsmd", x, t), lora,
                    w)


def _on_rows(fn, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``fn(x, w)`` on each rank's rows of x (its batch shards, whole
    elsewhere) with w whole; the output on x's rows. Each rank's rows give
    their share of w's gradient: a partial sum over the batch's mesh
    dims."""
    rows = shd.keep_shard(x.placements, 0)
    whole = shd.replicate(w)
    batch = [i for i, p in enumerate(rows) if p.is_shard(0)]
    return shd.local_map(fn, rows, (rows, whole), x, w,
                         grads=(rows, shd.partial_on(whole, batch)))


def wkv6_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 log_w: torch.Tensor, u: torch.Tensor, chunk: int,
                 s0: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV6.

    r/k/v (B, S, nh, hd); log_w (B, S, nh, hd) (<= 0); u (nh, hd). Returns
    (o (B, S, nh, hd), final state (B, nh, hd, hd) [key, value] f32).

    ``k * exp(-a)`` (a the in-chunk cumulative log decay) is formed as the
    reference forms it: at a decay near exp(-1) a step and a chunk of 128
    it overflows f32, and the output is not finite (ROADMAP Queue 3).

    Placed (a mesh), it runs on each rank's heads ("ssm_heads"; whole on
    every rank where they do not divide the model axis) as plain local
    tensors: the heads are independent.
    """
    if shd.is_placed(r):
        args = (r, k, v, log_w, u) + (() if s0 is None else (s0,))
        return shd.over_heads(
            lambda lo, *local: _wkv6(*local, chunk=chunk), (2, 1),
            (2, 2, 2, 2, (None, 0), 1)[:len(args)], *args,
            heads=r.shape[2])
    return _wkv6(r, k, v, log_w, u, s0, chunk=chunk)


def _wkv6(r, k, v, log_w, u, s0=None, *, chunk: int):
    """``wkv6_chunked`` on plain tensors."""
    b, s, nh, hd = r.shape
    pad = (-s) % chunk
    if pad:  # identity steps: decay 1, zero k/v -> state-neutral
        r, k, v, log_w = (F.pad(t, (0, 0, 0, 0, 0, pad))
                          for t in (r, k, v, log_w))
    s_orig, s = s, s + pad
    nc, l = s // chunk, chunk
    dt = r.dtype

    def rs(t):
        return t.reshape(b, nc, l, nh, hd)

    rc, kc, vc = rs(r), rs(k), rs(v)
    lw = rs(log_w).float()
    a = torch.cumsum(lw, dim=2)                 # inclusive
    bexp = a - lw                               # exclusive (a_{t-1})

    # intra-chunk: M[t, s] = (r_t * exp(b_t - a_s)) . k_s for s < t; the
    # diagonal through u
    ri = rc.float() * torch.exp(bexp)
    ki = kc.float() * torch.exp(-a)
    m = torch.einsum("bclhi,bcshi->bchls", ri, ki)              # (B,nc,nh,L,L)
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=r.device),
                      diagonal=-1)
    m = torch.where(mask, m, 0.0)
    diag = torch.einsum("bclhi,bclhi->bclh", rc.float() * u.float(),
                        kc.float())
    y_intra = (torch.einsum("bchls,bcshj->bclhj", m.to(dt), vc)
               + diag[..., None].to(dt) * vc)
    del m, ki

    # chunk states: S_c = sum_s exp(a_L - a_s)[i] k_s[i] v_s[j]
    seg = torch.exp(a[:, :, -1:] - a)
    states = torch.einsum("bclhi,bclhj->bchij", kc.float() * seg, vc.float())
    total = torch.exp(a[:, :, -1])                              # (B,nc,nh,hd)

    h = (torch.zeros((b, nh, hd, hd), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * total[:, c, :, :, None] + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                       # (B,nc,nh,hd,hd)
    y_inter = torch.einsum("bclhi,bchij->bclhj", ri.to(dt), h_prevs.to(dt))
    y = (y_intra + y_inter).reshape(b, s, nh, hd)
    return y[:, :s_orig], h


def _decay_dd(p: Params, xw: torch.Tensor, nh: int) -> torch.Tensor:
    """The data-dependent decay's log-log (..., D), D = nh heads x hd.
    Placed, the LoRA's output columns are taken as the heads are sharded
    ("ssm_heads"), so each rank forms the decay of its own heads alone."""
    wb = p.decay_b
    if shd.is_placed(wb):
        r, d = wb.shape
        wb = wb.redistribute(placements=shd.placements(
            (r, nh, d // nh), ("lora", "ssm_heads", None)))
    return p.decay_base + torch.tanh(xw @ p.decay_a) @ wb


def _split_heads(t: torch.Tensor, nh: int, hd: int) -> torch.Tensor:
    """(B, S, nh hd) -> (B, S, nh, hd). Placed with its columns sharded
    over a mesh dim whose ranks do not divide the nh heads (where the
    rules keep such heads whole), those columns are taken whole first: a
    view cannot split a head, and DTensor gathers them so only for a
    reshape that autograd does not decompose (inference mode)."""
    if shd.is_placed(t):
        from torch.distributed.tensor import Replicate
        last = t.ndim - 1
        t = t.redistribute(placements=tuple(
            Replicate() if p.is_shard(last) and nh % t.device_mesh.size(i)
            else p for i, p in enumerate(t.placements)))
    return t.reshape(*t.shape[:-1], nh, hd)


def _merge_heads(y: torch.Tensor) -> torch.Tensor:
    """(B, S, nh, hd) -> (B, S, nh hd). Placed, its gradient is pinned to
    the merged tensor's placements, so that the backward's split into
    heads meets them (whole where the heads are; ``wo``'s backward would
    leave it sharded on its columns)."""
    return shd.pin_grad(y.reshape(*y.shape[:-2], -1))


def rwkv_time_mix(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  prev_tok: torch.Tensor | None = None,
                  s0: torch.Tensor | None = None):
    """(B, S, D) -> (out, final state). The prefill path."""
    b, s, d = x.shape
    nh, hd = cfg.rwkv_nheads, cfg.rwkv_head_dim
    sx = _shift(x, prev_tok) - x
    mixes = _ddlerp(p, x, sx)
    r = _split_heads(mixes["r"] @ p.wr, nh, hd)
    k = _split_heads(mixes["k"] @ p.wk, nh, hd)
    v = _split_heads(mixes["v"] @ p.wv, nh, hd)
    g = mixes["g"] @ p.wg
    r = constrain(r, "batch", None, "ssm_heads", None)
    k = constrain(k, "batch", None, "ssm_heads", None)
    v = constrain(v, "batch", None, "ssm_heads", None)
    # data-dependent decay (Finch): w = exp(-exp(dd)) in (0, 1)
    log_w = -torch.exp(_decay_dd(p, mixes["w"], nh).float()).reshape(b, s, nh, hd)
    y, hs = wkv6_chunked(r, k, v, log_w, p.u, cfg.rwkv_chunk, s0)
    y = rmsnorm(_merge_heads(y), p.ln_x, cfg.norm_eps) * F.silu(g)
    return constrain(y @ p.wo, "batch", "seq", "embed"), hs


def rwkv_channel_mix(p: Params, x: torch.Tensor,
                     prev_tok: torch.Tensor | None = None) -> torch.Tensor:
    return _channel_mix(p, x, _shift(x, prev_tok) - x)


def _channel_mix(p: Params, x: torch.Tensor, sx: torch.Tensor
                 ) -> torch.Tensor:
    xk = x + sx * p.cm_mu_k
    xr = x + sx * p.cm_mu_r
    # (B, S, F) over a sequence; the decode step's (B, F) is left as it is,
    # as the reference's step constrains nothing
    k = constrain(torch.square(F.relu(xk @ p.cm_wk)), "batch", None, "mlp")
    return torch.sigmoid(xr @ p.cm_wr) * _summed(k @ p.cm_wv)


# ---------------------------------------------------------------------------
# decode path: O(1) per token
# ---------------------------------------------------------------------------

def rwkv_state_init(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                    device: torch.device) -> dict:
    nh, hd = cfg.rwkv_nheads, cfg.rwkv_head_dim
    return {
        "s": torch.zeros((batch, nh, hd, hd), dtype=torch.float32,
                         device=device),
        "tm_prev": torch.zeros((batch, cfg.d_model), dtype=dtype,
                               device=device),
        "cm_prev": torch.zeros((batch, cfg.d_model), dtype=dtype,
                               device=device),
    }


def rwkv_decode_step(p: Params, x: torch.Tensor, state: dict,
                     cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """One token's time mix. x (B, D) -> (out (B, D), new state); the
    channel mix is ``rwkv_channel_mix_step`` (the block wrapper applies it
    to the post-time-mix residual stream)."""
    b, d = x.shape
    nh, hd = cfg.rwkv_nheads, cfg.rwkv_head_dim
    sx = (state["tm_prev"] - x)[:, None, :]
    mixes = {k: t[:, 0] for k, t in _ddlerp(p, x[:, None, :], sx).items()}
    r = (mixes["r"] @ p.wr).reshape(b, nh, hd)
    k = (mixes["k"] @ p.wk).reshape(b, nh, hd)
    v = (mixes["v"] @ p.wv).reshape(b, nh, hd)
    g = mixes["g"] @ p.wg
    w = torch.exp(-torch.exp(_decay_dd(p, mixes["w"], nh).float())).reshape(
        b, nh, hd)

    args = (state["s"], r, k, v, w, p.u)
    if shd.is_placed(r):
        o, s_new = shd.over_heads(lambda lo, *local: _wkv_step(*local),
                                  (1, 1), (1, 1, 1, 1, 1, (None, 0)), *args,
                                  heads=nh)
    else:
        o, s_new = _wkv_step(*args)
    y = rmsnorm(o.reshape(b, d).to(x.dtype), p.ln_x, cfg.norm_eps) * F.silu(g)
    return _summed(y @ p.wo), {"s": s_new, "tm_prev": x,
                               "cm_prev": state["cm_prev"]}


def _wkv_step(s, r, k, v, w, u):
    """One token's WKV readout and state update on plain tensors: s (B,
    nh, hd, hd) f32, r/k/v (B, nh, hd), w (B, nh, hd) f32, u (nh, hd) ->
    (o (B, nh, hd) f32, new s)."""
    kv = torch.einsum("bhi,bhj->bhij", k.float(), v.float())
    o = torch.einsum("bhi,bhij->bhj", r.float(),
                     s + u.float()[None, :, :, None] * kv)
    return o, w[..., None] * s + kv


def _summed(x: torch.Tensor) -> torch.Tensor:
    """A branch's (B, [S,] D) output pinned to the residual stream's axes:
    over a mesh, the partial sums of a product that contracts a sharded
    dim are summed here, before the residual add."""
    return constrain(x, "batch", *("seq",) * (x.ndim - 2), "embed")


def rwkv_channel_mix_step(p: Params, x: torch.Tensor, prev: torch.Tensor
                          ) -> torch.Tensor:
    return _channel_mix(p, x, prev - x)
