"""Mamba2 (SSD) block: the chunked state-space scan for prefill and the
O(1) recurrence for decode (the port of ``repro/models/ssm.py``).

Within a chunk of L steps the recurrence h_t = a_t h_{t-1} + B_t (dt_t x_t)
is unrolled into an L x L decay-weighted product; across chunks a loop
carries the (nh, hd, ds) state in f32. Plain torch ops transcribed from the
reference, in its casts: the decays in f32, the products in the working
type, the carried state in f32. One departure, in backward only: the
intra-chunk decay is masked before its exponential, where the reference
masks the product after it, so an upper entry whose exp overflows (a
chunk's decay past e^88, as zamba2-2.7b's init reaches at chunk 128)
gives no 0 x inf: the reference's gradient is NaN there (ROADMAP Queue
3), the forward is the same bit for bit.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.launch import sharding as shd
from repro_torch.launch.sharding import constrain
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params, ParamSpec, rmsnorm


def mamba_specs(cfg: ModelConfig) -> dict:
    d, di = cfg.d_model, cfg.d_inner
    g, ds, nh, w = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_conv
    conv_dim = di + 2 * g * ds
    return {
        "in_proj": ParamSpec((d, 2 * di + 2 * g * ds + nh), ("embed", "mlp")),
        "conv_w": ParamSpec((w, conv_dim), ("conv", "mlp"), scale=0.5),
        "conv_b": ParamSpec((conv_dim,), ("mlp",), "zeros"),
        "a_log": ParamSpec((nh,), ("ssm_heads",), "ones"),
        "d_skip": ParamSpec((nh,), ("ssm_heads",), "ones"),
        "dt_bias": ParamSpec((nh,), ("ssm_heads",), "zeros"),
        "norm": ParamSpec((di,), ("mlp",), "ones"),
        "out_proj": ParamSpec((di, d), ("mlp", "embed")),
    }


def _split_in_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    """(..., 2 di + 2 g ds + nh) -> z, x, B, C, dt."""
    di, g, ds, nh = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_nheads
    return torch.split(zxbcdt, [di, di, g * ds, g * ds, nh], dim=-1)


def _causal_conv(xin: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv1d: xin (B, S, C), w (W, C) -> (B, S, C)."""
    width, s = w.shape[0], xin.shape[1]
    pad = F.pad(xin, (0, 0, width - 1, 0))
    out = torch.zeros_like(xin)
    for i in range(width):   # the reference's unrolled sum, in its order
        out = out + pad[:, i:i + s, :] * w[i]
    return out + b


def _head_maps(maps: torch.Tensor, nh: int, lo: int, nhl: int
               ) -> torch.Tensor:
    """(..., g, ds) group maps -> (..., nhl, ds): each of the heads [lo, lo
    + nhl) of ``nh`` its group's map (the reference's repeat of each group
    over its nh / g heads)."""
    g = maps.shape[-2]
    if nhl == nh:
        return torch.repeat_interleave(maps, nh // g, dim=-2)
    idx = torch.div(lo + torch.arange(nhl, device=maps.device), nh // g,
                    rounding_mode="floor")
    return maps.index_select(maps.ndim - 2, idx)


def ssd_chunked(xh: torch.Tensor, log_a: torch.Tensor, bmat: torch.Tensor,
                cmat: torch.Tensor, chunk: int, h0: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    xh (B, S, nh, hd) dt-weighted inputs; log_a (B, S, nh) per-step log
    decay (<= 0); bmat / cmat (B, S, g, ds) input and output maps (groups
    broadcast over heads). Returns (y (B, S, nh, hd), final state (B, nh,
    hd, ds) f32).

    Placed (a mesh), the scan runs on each rank's heads ("ssm_heads") as
    plain local tensors, the maps whole over the heads: the heads are
    independent, so its masks, zero state and chunk loop need no
    collective.
    """
    if shd.is_placed(xh):
        nh = xh.shape[2]

        def body(lo, *local):
            return _ssd(*local, chunk=chunk, nh=nh, lo=lo)

        args = (xh, log_a, bmat, cmat) + (() if h0 is None else (h0,))
        return shd.over_heads(body, (2, 1), (2, 2, None, None, 1)[:len(args)],
                              *args, heads=nh)
    return _ssd(xh, log_a, bmat, cmat, h0, chunk=chunk, nh=xh.shape[2], lo=0)


def _ssd(xh, log_a, bmat, cmat, h0=None, *, chunk: int, nh: int, lo: int):
    """``ssd_chunked`` on plain tensors holding the heads [lo, lo + nhl) of
    ``nh`` (xh's (B, S, nhl, hd)); bmat / cmat whole over the groups."""
    b, s, nhl, hd = xh.shape
    g, ds = bmat.shape[2], bmat.shape[3]
    pad = (-s) % chunk
    if pad:  # identity steps (decay 1, zero input): state-neutral
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        log_a = F.pad(log_a, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, 0, 0, pad))
    s_orig, s = s, s + pad
    nc, l = s // chunk, chunk
    dt = xh.dtype

    xh_c = xh.reshape(b, nc, l, nhl, hd)
    la_c = torch.cumsum(log_a.reshape(b, nc, l, nhl).float(), dim=2)
    bh = _head_maps(bmat.reshape(b, nc, l, g, ds), nh, lo, nhl)
    ch = _head_maps(cmat.reshape(b, nc, l, g, ds), nh, lo, nhl)

    # intra-chunk: an L x L product per (chunk, head)
    gmat = torch.einsum("bclhn,bcshn->bchls", ch, bh)            # (B,nc,nh,L,L)
    diff = la_c[:, :, :, None, :] - la_c[:, :, None, :, :]       # (B,nc,L,L,nh)
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=xh.device))
    # masked before the exponential (the reference masks only the
    # product): the same forward, and no 0 x inf in backward where an
    # upper entry's exp(diff) overflows
    decay = torch.exp(torch.where(mask, diff.permute(0, 1, 4, 2, 3),
                                  float("-inf")))
    del diff
    m = torch.where(mask, gmat * decay, 0.0).to(dt)
    del gmat, decay
    y_intra = torch.einsum("bchls,bcshp->bclhp", m, xh_c)
    del m

    # chunk states: S_c = sum_s exp(la_last - la_s) B_s x_s
    seg = torch.exp(la_c[:, :, -1:, :] - la_c).to(dt)            # (B,nc,L,nh)
    states = torch.einsum("bclhn,bclhp->bchpn", bh, seg[..., None] * xh_c)

    # inter-chunk: the carried state, in f32
    total = torch.exp(la_c[:, :, -1, :])                         # (B,nc,nh)
    h = (torch.zeros((b, nhl, hd, ds), dtype=torch.float32, device=xh.device)
         if h0 is None else h0.float())
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * total[:, c, :, None, None] + states[:, c].float()
    h_prevs = torch.stack(h_prevs, dim=1)                        # (B,nc,nh,hd,ds)

    # C_t . (decay_t * H_prev)
    cdec = ch * torch.exp(la_c).to(dt)[..., None]
    y_inter = torch.einsum("bclhn,bchpn->bclhp", cdec, h_prevs.to(dt))
    y = (y_intra + y_inter).reshape(b, s, nhl, hd)
    return y[:, :s_orig], h


def mamba_block(p: Params, x: torch.Tensor, cfg: ModelConfig,
                return_state: bool = False):
    """Prefill forward. x (B, S, D) -> (B, S, D) [, final state {h, conv}]."""
    b, s, _ = x.shape
    nh, hd = cfg.ssm_nheads, cfg.ssm_head_dim
    g, ds = cfg.ssm_groups, cfg.ssm_state

    # the product's gradient pinned to its forward placement (its columns
    # on each rank's shard), as the split's backward would leave it
    # otherwise: over a 3-D mesh DTensor then formed the weight's
    # gradient whole on every model rank
    z, xc, bm, cm, dt = _split_in_proj(cfg, shd.pin_grad(x @ p.in_proj))
    conv_in = torch.cat([xc, bm, cm], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, p.conv_w, p.conv_b))
    xc, bm, cm = torch.split(conv_out, [cfg.d_inner, g * ds, g * ds], dim=-1)

    dt = F.softplus(dt.float() + p.dt_bias.float())
    a = -torch.exp(p.a_log.float())                   # (nh,) negative
    log_a = a[None, None, :] * dt                     # (B, S, nh) <= 0
    xh = xc.reshape(b, s, nh, hd) * dt[..., None].to(x.dtype)
    y, h_final = ssd_chunked(xh, log_a, bm.reshape(b, s, g, ds),
                             cm.reshape(b, s, g, ds), cfg.ssm_chunk)
    y = y + xc.reshape(b, s, nh, hd) * p.d_skip[None, None, :, None]
    y = y.reshape(b, s, cfg.d_inner)
    y = constrain(rmsnorm(y * F.silu(z), p.norm, cfg.norm_eps),
                  "batch", None, "mlp")
    out = constrain(y @ p.out_proj, "batch", "seq", "embed")
    if return_state:
        w = p.conv_w.shape[0]
        return out, {"h": h_final, "conv": conv_in[:, s - (w - 1):, :]}
    return out


# ---------------------------------------------------------------------------
# decode path: O(1) per token
# ---------------------------------------------------------------------------

def mamba_state_init(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device: torch.device) -> dict:
    nh, hd, ds = cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * ds
    return {
        "h": torch.zeros((batch, nh, hd, ds), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                            device=device),
    }


def mamba_decode_step(p: Params, x: torch.Tensor, state: dict,
                      cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """x (B, D), one token -> (out (B, D), new state). The new state's
    tensors are fresh (``conv`` is a view of a new window), so a caller may
    copy them into the state it passed."""
    b, _ = x.shape
    nh, hd = cfg.ssm_nheads, cfg.ssm_head_dim
    g, ds = cfg.ssm_groups, cfg.ssm_state

    z, xc, bm, cm, dt = _split_in_proj(cfg, (x @ p.in_proj)[:, None, :])
    conv_in = torch.cat([xc, bm, cm], dim=-1)                    # (B, 1, C)
    window = torch.cat([state["conv"], conv_in], dim=1)          # (B, W, C)
    conv_out = F.silu(_conv_step(window, p.conv_w) + p.conv_b)
    xc, bm, cm = torch.split(conv_out, [cfg.d_inner, g * ds, g * ds], dim=-1)

    dt = F.softplus(dt[:, 0].float() + p.dt_bias)                # (B, nh)
    a = -torch.exp(p.a_log.float())
    decay = torch.exp(a[None] * dt)                              # (B, nh)
    xh = xc.reshape(b, nh, hd) * dt[..., None].to(x.dtype)
    args = (state["h"], xh, bm.reshape(b, g, ds), cm.reshape(b, g, ds),
            decay)
    if shd.is_placed(xh):
        h, y = shd.over_heads(
            lambda lo, *local: _state_step(*local, nh=nh, lo=lo), (1, 1),
            (1, 1, None, None, 1), *args, heads=nh)
    else:
        h, y = _state_step(*args, nh=nh, lo=0)
    y = y + xc.reshape(b, nh, hd) * p.d_skip[None, :, None]
    y = y.reshape(b, cfg.d_inner)
    y = rmsnorm(y * F.silu(z[:, 0]), p.norm, cfg.norm_eps)
    # over a mesh the product contracts the sharded inner dim: its partial
    # sums are summed here, before the residual add
    out = constrain(y @ p.out_proj, "batch", "embed")
    return out, {"h": h, "conv": window[:, 1:]}


def _conv_step(window: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The depthwise conv's one output (B, C) of the (B, W, C) window and
    the (W, C) taps. Placed, on each rank's channels (as the taps are
    sharded): DTensor derives an einsum's rule anew at every call."""
    if not shd.is_placed(w):
        return torch.einsum("bwc,wc->bc", window, w)
    from torch.distributed.tensor import Replicate, Shard
    chans = [i for i, p in enumerate(w.placements) if p.is_shard(1)]
    rows = [i for i, p in enumerate(window.placements)
            if p.is_shard(0) and i not in chans]

    def at(c_dim):
        return tuple(Shard(c_dim) if i in chans else Shard(0) if i in rows
                     else Replicate() for i in range(w.device_mesh.ndim))

    return shd.local_map(lambda x, t: torch.einsum("bwc,wc->bc", x, t),
                         at(1), (at(2), w.placements), window, w)


def _state_step(h, xh, bm, cm, decay, *, nh: int, lo: int):
    """One token's state update and readout on the heads [lo, lo + nhl)
    of ``nh``: h (B, nhl, hd, ds) f32, xh (B, nhl, hd), the group maps bm /
    cm (B, g, ds), decay (B, nhl) -> (new h, y (B, nhl, hd))."""
    nhl = xh.shape[1]
    bmat = _head_maps(bm, nh, lo, nhl)
    cmat = _head_maps(cm, nh, lo, nhl)
    h = h * decay[:, :, None, None] + torch.einsum(
        "bhp,bhn->bhpn", xh, bmat).float()
    return h, torch.einsum("bhpn,bhn->bhp", h.to(xh.dtype), cmat)
