"""Mamba2 (SSD) block: the chunked state-space scan for prefill and the
O(1) recurrence for decode (the port of ``repro/models/ssm.py``).

Within a chunk of L steps the recurrence h_t = a_t h_{t-1} + B_t (dt_t x_t)
is unrolled into an L x L decay-weighted product; across chunks a loop
carries the (nh, hd, ds) state in f32. Plain torch ops transcribed from the
reference, in its casts: the decays in f32, the products in the working
type, the carried state in f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params, ParamSpec, rmsnorm


def mamba_specs(cfg: ModelConfig) -> dict:
    d, di = cfg.d_model, cfg.d_inner
    g, ds, nh, w = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_conv
    conv_dim = di + 2 * g * ds
    return {
        "in_proj": ParamSpec((d, 2 * di + 2 * g * ds + nh)),
        "conv_w": ParamSpec((w, conv_dim), scale=0.5),
        "conv_b": ParamSpec((conv_dim,), "zeros"),
        "a_log": ParamSpec((nh,), "ones"),
        "d_skip": ParamSpec((nh,), "ones"),
        "dt_bias": ParamSpec((nh,), "zeros"),
        "norm": ParamSpec((di,), "ones"),
        "out_proj": ParamSpec((di, d)),
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


def ssd_chunked(xh: torch.Tensor, log_a: torch.Tensor, bmat: torch.Tensor,
                cmat: torch.Tensor, chunk: int, h0: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    xh (B, S, nh, hd) dt-weighted inputs; log_a (B, S, nh) per-step log
    decay (<= 0); bmat / cmat (B, S, g, ds) input and output maps (groups
    broadcast over heads). Returns (y (B, S, nh, hd), final state (B, nh,
    hd, ds) f32).
    """
    b, s, nh, hd = xh.shape
    g, ds = bmat.shape[2], bmat.shape[3]
    pad = (-s) % chunk
    if pad:  # identity steps (decay 1, zero input): state-neutral
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        log_a = F.pad(log_a, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, 0, 0, pad))
    s_orig, s = s, s + pad
    nc, l = s // chunk, chunk
    hpg = nh // g
    dt = xh.dtype

    xh_c = xh.reshape(b, nc, l, nh, hd)
    la_c = torch.cumsum(log_a.reshape(b, nc, l, nh).float(), dim=2)
    bh = torch.repeat_interleave(bmat.reshape(b, nc, l, g, ds), hpg, dim=3)
    ch = torch.repeat_interleave(cmat.reshape(b, nc, l, g, ds), hpg, dim=3)

    # intra-chunk: an L x L product per (chunk, head)
    gmat = torch.einsum("bclhn,bcshn->bchls", ch, bh)            # (B,nc,nh,L,L)
    diff = la_c[:, :, :, None, :] - la_c[:, :, None, :, :]       # (B,nc,L,L,nh)
    decay = torch.exp(diff.permute(0, 1, 4, 2, 3))
    del diff
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=xh.device))
    m = torch.where(mask, gmat * decay, 0.0).to(dt)
    del gmat, decay
    y_intra = torch.einsum("bchls,bcshp->bclhp", m, xh_c)
    del m

    # chunk states: S_c = sum_s exp(la_last - la_s) B_s x_s
    seg = torch.exp(la_c[:, :, -1:, :] - la_c).to(dt)            # (B,nc,L,nh)
    states = torch.einsum("bclhn,bclhp->bchpn", bh, seg[..., None] * xh_c)

    # inter-chunk: the carried state, in f32
    total = torch.exp(la_c[:, :, -1, :])                         # (B,nc,nh)
    h = (torch.zeros((b, nh, hd, ds), dtype=torch.float32, device=xh.device)
         if h0 is None else h0.float())
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * total[:, c, :, None, None] + states[:, c].float()
    h_prevs = torch.stack(h_prevs, dim=1)                        # (B,nc,nh,hd,ds)

    # C_t . (decay_t * H_prev)
    cdec = ch * torch.exp(la_c).to(dt)[..., None]
    y_inter = torch.einsum("bclhn,bchpn->bclhp", cdec, h_prevs.to(dt))
    y = (y_intra + y_inter).reshape(b, s, nh, hd)
    return y[:, :s_orig], h


def mamba_block(p: Params, x: torch.Tensor, cfg: ModelConfig,
                return_state: bool = False):
    """Prefill forward. x (B, S, D) -> (B, S, D) [, final state {h, conv}]."""
    b, s, _ = x.shape
    nh, hd = cfg.ssm_nheads, cfg.ssm_head_dim
    g, ds = cfg.ssm_groups, cfg.ssm_state

    z, xc, bm, cm, dt = _split_in_proj(cfg, x @ p.in_proj)
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
    y = rmsnorm(y * F.silu(z), p.norm, cfg.norm_eps)
    out = y @ p.out_proj
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
    conv_out = torch.einsum("bwc,wc->bc", window, p.conv_w) + p.conv_b
    conv_out = F.silu(conv_out)
    xc, bm, cm = torch.split(conv_out, [cfg.d_inner, g * ds, g * ds], dim=-1)

    dt = F.softplus(dt[:, 0].float() + p.dt_bias)                # (B, nh)
    a = -torch.exp(p.a_log.float())
    decay = torch.exp(a[None] * dt)                              # (B, nh)
    xh = xc.reshape(b, nh, hd) * dt[..., None].to(x.dtype)
    bmat = torch.repeat_interleave(bm.reshape(b, g, ds), nh // g, dim=1)
    cmat = torch.repeat_interleave(cm.reshape(b, g, ds), nh // g, dim=1)

    h = state["h"] * decay[:, :, None, None] + torch.einsum(
        "bhp,bhn->bhpn", xh, bmat).float()
    y = torch.einsum("bhpn,bhn->bhp", h.to(x.dtype), cmat)
    y = y + xc.reshape(b, nh, hd) * p.d_skip[None, :, None]
    y = y.reshape(b, cfg.d_inner)
    y = rmsnorm(y * F.silu(z[:, 0]), p.norm, cfg.norm_eps)
    return y @ p.out_proj, {"h": h, "conv": window[:, 1:]}
