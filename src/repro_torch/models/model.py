"""Public model API: specs, init, forward, prefill and the decode step for
the dense attention, Mamba2 / zamba2-hybrid and RWKV6 families (the port
of ``repro/models/model.py``).

The model is a ``layers.Params`` tree of modules holding the reference's
tensors by the reference's names (``embedding``, ``ln_f``, ``lm_head``,
``stack.blocks[i].attn.wq``, ``stack.blocks[i].mamba.in_proj``, ...).
Entry points run under ``torch.inference_mode``; ``loss_fn`` waits for the
training slice, MoE for its own (ROADMAP Queue 1).

Caches: the attention family's ``ExactKVCache`` / ``PQKVCache``; the
recurrent families' dicts of the reference's keys (``h``, ``conv`` and the
hybrid's ``attn_*`` entries; ``s``, ``tm_prev``, ``cm_prev``). A decode
step updates its cache in place and returns it.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import kvcache as kvc
from repro_torch.models import layers as ll
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamSpec

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# specs / init
# ---------------------------------------------------------------------------

STACK_SPECS = {"attn": tf.attn_stack_specs, "mamba2": tf.mamba_stack_specs,
               "rwkv6": tf.rwkv_stack_specs}


def lm_specs(cfg: ModelConfig) -> dict:
    d, v = cfg.d_model, cfg.padded_vocab
    if cfg.block_type not in STACK_SPECS:
        raise ValueError(cfg.block_type)
    return {
        "embedding": ParamSpec((v, d), scale=1.0),
        "ln_f": ll.rmsnorm_spec(d),
        "lm_head": ParamSpec((d, v)),
        "stack": STACK_SPECS[cfg.block_type](cfg),
    }


def init_lm(cfg: ModelConfig, *, generator: torch.Generator,
            device: str | torch.device | None = None,
            dtype: torch.dtype | None = None) -> ll.Params:
    """The model on ``device`` (None = the CUDA card) in ``dtype`` (None =
    the config's), drawn from ``generator`` by the reference's rule."""
    specs = lm_specs(cfg)
    model = ll.Params(specs, dtype=dtype or model_dtype(cfg),
                      device=resolve_device(device))
    ll.init_params(model, specs, generator)
    return model


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(b, s)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

@torch.inference_mode()
def forward(params: ll.Params, tokens: torch.Tensor, cfg: ModelConfig
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) -> (logits (B, S, Vpad), aux_loss scalar)."""
    h, aux = _hidden_states(params, tokens, cfg)
    return h @ params.lm_head, aux


def _hidden_states(params: ll.Params, tokens: torch.Tensor, cfg: ModelConfig
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """forward() minus the lm_head: final-norm hidden states (B, S, D)."""
    b, s = tokens.shape
    h = params.embedding[tokens.long()]
    stack = {"attn": tf.attn_stack, "mamba2": tf.mamba_stack,
             "rwkv6": tf.rwkv_stack}[cfg.block_type]
    h, aux = stack(params.stack, h, cfg, _positions(b, s, tokens.device))
    return ll.rmsnorm(h, params.ln_f, cfg.norm_eps), aux


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device: str | torch.device | None = None):
    """An empty cache on ``device`` (None = the card), its activations in
    ``dtype`` (default the config's): for the attention family an exact
    cache or, with ``cfg.kv_pq``, a PQ one; for Mamba2 the states and the
    hybrid's shared-attention cache (exact, or PQ with ``cfg.kv_pq``); for
    RWKV6 the states."""
    dev = resolve_device(device)
    dtype = dtype or model_dtype(cfg)
    if cfg.block_type == "mamba2":
        return tf.mamba_cache_init(cfg, batch, max_seq, dtype, dev)
    if cfg.block_type == "rwkv6":
        return tf.rwkv_cache_init(cfg, batch, dtype, dev)
    if cfg.kv_pq:
        return kvc.init_pq(cfg, batch, max_seq, dev)
    return kvc.init_exact(cfg, batch, max_seq, dtype, dev)


@torch.inference_mode()
def decode_step(params: ll.Params, cache, tokens: torch.Tensor,
                position: torch.Tensor, cfg: ModelConfig):
    """One decode step. tokens: (B,) int; position: (B,) int32.

    Returns (logits (B, Vpad), cache), the cache updated in place.
    """
    h = params.embedding[tokens.long()]                       # (B, D)
    if cfg.block_type == "attn":
        h, cache = tf.attn_stack_decode(params.stack, h, cfg, cache, position)
    elif cfg.block_type == "mamba2":
        h, cache = tf.mamba_stack_decode(params.stack, h, cfg, cache,
                                         position, h)
    else:
        h, cache = tf.rwkv_stack_decode(params.stack, h, cfg, cache, position)
    h = ll.rmsnorm(h, params.ln_f, cfg.norm_eps)
    return h @ params.lm_head, cache


@torch.inference_mode()
def prefill(params: ll.Params, tokens: torch.Tensor, cfg: ModelConfig,
            max_seq: int | None = None, pq_cache=None):
    """Prefill a prompt, returning (last-position logits, filled cache).

    Attention family: one pass through the stack that also captures each
    layer's K/V into an exact cache of ``max_seq`` positions (zero past the
    prompt), or their 4-bit PQ codes when ``cfg.kv_pq`` (``pq_cache``, a
    ``PQKVCache``, carries calibrated codebooks). Mamba2 / RWKV6: the
    chunked scans emit their O(1) states; the hybrid's shared attention
    fills an exact cache, or with ``cfg.kv_pq`` PQ codes under
    ``pq_cache["attn_k_cb"]`` / ``["attn_v_cb"]`` (G, KV, M, 16, dsub).
    """
    b, s = tokens.shape
    max_seq = max_seq or s
    if cfg.block_type != "attn":
        h = params.embedding[tokens.long()]
        if cfg.block_type == "mamba2":
            positions = _positions(b, s, tokens.device)
            if cfg.kv_pq and cfg.shared_attn_every:
                assert pq_cache is not None, \
                    "PQ prefill needs calibrated codebooks"
                h, cache = tf.mamba_stack_prefill_pq(
                    params.stack, h, cfg, positions, max_seq,
                    pq_cache["attn_k_cb"], pq_cache["attn_v_cb"])
            else:
                h, cache = tf.mamba_stack_prefill(params.stack, h, cfg,
                                                  positions, max_seq)
        else:
            h, cache = tf.rwkv_stack_prefill(params.stack, h, cfg)
        h = ll.rmsnorm(h, params.ln_f, cfg.norm_eps)
        return h[:, -1] @ params.lm_head, cache
    if cfg.kv_pq:  # the paper's technique: K/V straight to 4-bit codes
        assert pq_cache is not None, "PQ prefill needs calibrated codebooks"
        return encode_pq_cache(params, tokens, cfg, pq_cache)

    h = params.embedding[tokens.long()]
    positions = _positions(b, s, tokens.device)
    cache = kvc.init_exact(cfg, b, max_seq, h.dtype, h.device)
    for i, lp in enumerate(params.stack.blocks):
        h, k, v = _prefill_layer(lp, h, cfg, positions)
        cache.k[i, :, :s] = k
        cache.v[i, :, :s] = v
    h = ll.rmsnorm(h, params.ln_f, cfg.norm_eps)
    return h[:, -1] @ params.lm_head, cache


def _prefill_layer(lp: ll.Params, h: torch.Tensor, cfg: ModelConfig,
                   positions: torch.Tensor):
    """One block over the prompt: (h, k, v), k and v (B, S, KV, hd)."""
    x = ll.rmsnorm(h, lp.ln1, cfg.norm_eps)
    q, k, v = ll.qkv_project(lp.attn, x, cfg, positions)
    out = ll.chunked_causal_attention(q, k, v, cfg)
    h = h + torch.einsum("bshk,hkd->bsd", out, lp.attn.wo)
    hn = ll.rmsnorm(h, lp.ln2, cfg.norm_eps)
    h = h + ll.ffn(lp.ffn, hn, cfg)
    return h, k, v


@torch.inference_mode()
def encode_pq_cache(params: ll.Params, tokens: torch.Tensor, cfg: ModelConfig,
                    cache: kvc.PQKVCache):
    """Prefill into a PQ cache whose codebooks are already calibrated: its
    code tensors are filled in place (zero past the prompt)."""
    b, s = tokens.shape
    h = params.embedding[tokens.long()]
    positions = _positions(b, s, tokens.device)
    cache.k_codes.zero_()
    cache.v_codes.zero_()
    for i, lp in enumerate(params.stack.blocks):
        h, k, v = _prefill_layer(lp, h, cfg, positions)
        cache.k_codes[i, :, :s] = kvc.encode_kv(k, cache.k_cb[i])
        cache.v_codes[i, :, :s] = kvc.encode_kv(v, cache.v_cb[i])
    h = ll.rmsnorm(h, params.ln_f, cfg.norm_eps)
    return h[:, -1] @ params.lm_head, cache
