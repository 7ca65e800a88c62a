"""Stack assembly for the attention family (the port of the attention part
of ``repro/models/transformer.py``).

The reference scans over layer-stacked parameters (and remats them for
training); here the stack is an ``nn.ModuleList`` of per-layer blocks and a
Python loop visits them. Remat has no meaning at inference and is not
ported; the MoE, Mamba2 and RWKV6 stacks wait (ROADMAP Queue 1).
"""
from __future__ import annotations

import torch

from repro_torch.models import kvcache as kvc
from repro_torch.models import layers as ll
from repro_torch.models.config import ModelConfig


def _dense_only(cfg: ModelConfig) -> None:
    if cfg.n_experts or cfg.block_type != "attn":
        raise NotImplementedError(
            f"{cfg.name}: only the dense attention family is ported "
            "(MoE, Mamba2 and RWKV6 wait in ROADMAP Queue 1)")


def attn_block_specs(cfg: ModelConfig) -> dict:
    _dense_only(cfg)
    return {
        "ln1": ll.rmsnorm_spec(cfg.d_model),
        "ln2": ll.rmsnorm_spec(cfg.d_model),
        "attn": ll.attn_specs(cfg),
        "ffn": ll.ffn_specs(cfg),
    }


def attn_block(p: ll.Params, h: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm transformer block. Returns (h, aux_loss)."""
    h = h + ll.attention(p.attn, ll.rmsnorm(h, p.ln1, cfg.norm_eps), cfg,
                         positions)
    hn = ll.rmsnorm(h, p.ln2, cfg.norm_eps)
    h = h + ll.ffn(p.ffn, hn, cfg)
    return h, torch.zeros((), device=h.device)


def attn_stack_specs(cfg: ModelConfig) -> dict:
    return {"blocks": ll.stacked(attn_block_specs(cfg), cfg.n_layers)}


def attn_stack(p: ll.Params, h: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    aux = torch.zeros((), device=h.device)
    for lp in p.blocks:
        h, a = attn_block(lp, h, cfg, positions)
        aux = aux + a
    return h, aux


def attn_stack_decode(p: ll.Params, h: torch.Tensor, cfg: ModelConfig,
                      cache, position: torch.Tensor):
    """One-token decode through the stack; cache is Exact or PQ (the
    paper's technique), updated in place at ``position[0]`` before each
    layer scores (the current token attends to itself)."""
    pq = isinstance(cache, kvc.PQKVCache)
    for i, lp in enumerate(p.blocks):
        x = ll.rmsnorm(h, lp.ln1, cfg.norm_eps)
        q, k_new, v_new = ll.qkv_project(lp.attn, x[:, None], cfg,
                                         position[:, None])
        if pq:
            kcod, vcod = kvc.update_pq(cache.k_codes[i], cache.v_codes[i],
                                       k_new[:, 0], v_new[:, 0],
                                       cache.k_cb[i], cache.v_cb[i],
                                       position[0])
            out = kvc.pq_decode_attention(q[:, 0], kcod, vcod, cache.k_cb[i],
                                          cache.v_cb[i], position,
                                          quantize_q8=True)
        else:
            kc, vc = kvc.update_exact(cache.k[i], cache.v[i], k_new[:, 0],
                                      v_new[:, 0], position[0])
            out = ll.decode_attention_scores(q[:, 0], kc, vc, cfg, position)
        h = h + torch.einsum("bhk,hkd->bd", out, lp.attn.wo)
        hn = ll.rmsnorm(h, lp.ln2, cfg.norm_eps)
        h = h + ll.ffn(lp.ffn, hn[:, None], cfg)[:, 0]
    return h, cache
