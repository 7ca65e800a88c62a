"""Public model API: specs, init, forward, the training loss, prefill and
the decode step for the attention (dense, MoE, and the vlm / audio
frontend stubs), Mamba2 / zamba2-hybrid and RWKV6 families (the port of
``repro/models/model.py``).

The model is a ``layers.Params`` tree of modules holding the reference's
tensors by the reference's names (``embedding``, ``ln_f``, ``lm_head``,
``stack.blocks[i].attn.wq``, ``stack.blocks[i].mamba.in_proj``, ...).
The serving entry points (``forward``, ``prefill``, ``decode_step``) run
under ``torch.inference_mode``. ``loss_fn`` is the training entry point:
it goes through ``_hidden_states``, which autograd records (turn the
parameters on with ``layers.set_trainable``), and the stacks remat as the
config says (``transformer._remat``).

The modality frontends are stubs, as in the reference: precomputed patch
or frame embeddings ``frontend_embeds`` (B, F, D) overwrite the token
embeddings of the first F positions in ``forward`` and in the attention
family's exact ``prefill``. The reference's PQ prefill, its recurrent
prefills and its decode step take none, so those drop them here too.

Caches: the attention family's ``ExactKVCache`` / ``PQKVCache``; the
recurrent families' dicts of the reference's keys (``h``, ``conv`` and the
hybrid's ``attn_*`` entries; ``s``, ``tm_prev``, ``cm_prev``). A decode
step updates its cache in place and returns it.

``lm_axes`` and ``cache_axes`` give the logical sharding axes of the
parameters (keyed by their dotted names) and of each cache kind, as the
reference's do, for ``launch.sharding.tree_shardings``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.launch import sharding as shd
from repro_torch.launch.sharding import constrain
from repro_torch.models import kvcache as kvc
from repro_torch.models import layers as ll
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamSpec

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
AUX_LOSS_WEIGHT = 0.01


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
        "embedding": ParamSpec((v, d), ("vocab", "embed"), scale=1.0),
        "ln_f": ll.rmsnorm_spec(d),
        "lm_head": ParamSpec((d, v), ("embed", "vocab")),
        "stack": STACK_SPECS[cfg.block_type](cfg),
    }


def lm_axes(cfg: ModelConfig) -> dict:
    """{dotted parameter name: logical axes}; a layer's omit "stack"."""
    return ll.param_axes(lm_specs(cfg))


def lm_shapes(cfg: ModelConfig, dtype: torch.dtype | None = None
              ) -> ll.Params:
    """The model's parameters as meta-device stand-ins (shapes and dtypes,
    no data) for the dry-run."""
    return ll.Params(lm_specs(cfg), dtype=dtype or model_dtype(cfg),
                     device=torch.device("meta"))


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


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    """(B, S) int32 positions 0 .. S - 1 a row, placed as the (B, S)
    ``tokens`` are where those are a DTensor."""
    b, s = tokens.shape
    pos = torch.arange(s, dtype=torch.int32, device=tokens.device)
    return shd.placed_like(pos[None].expand(b, s).contiguous(), tokens)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

@torch.inference_mode()
def forward(params: ll.Params, tokens: torch.Tensor, cfg: ModelConfig,
            frontend_embeds: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) -> (logits (B, S, Vpad), aux_loss scalar)."""
    h, aux = _hidden_states(params, tokens, cfg, frontend_embeds)
    return constrain(h @ params.lm_head, "batch", "seq", "vocab"), aux


def _ce_from_logits(logits: torch.Tensor, targets: torch.Tensor,
                    mask: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Masked summed NLL for one (B, s, Vpad) logits block, in f32, the
    padded vocab columns masked to -1e30. Placed logits run on each
    rank's vocab shard (``_ce_over_vocab``)."""
    if shd.is_placed(logits):
        return _ce_over_vocab(logits, targets, mask, cfg)
    return _nll(logits, targets, mask, cfg.vocab)


def _nll(logits, targets, mask, vocab: int, lo: int = 0, combine=None
         ) -> torch.Tensor:
    """``_ce_from_logits`` of the vocab columns [lo, lo + V) that
    ``logits`` (..., V) holds: the columns past ``vocab`` masked, and
    ``combine(lse, gold)`` (the whole vocab's log-sum-exp and gold logit
    from each rank's; None: these columns are the whole vocab)."""
    logits = logits.float()
    v = logits.shape[-1]
    if lo + v > vocab:
        pad = lo + torch.arange(v, device=logits.device) >= vocab
        logits = logits.masked_fill(pad, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    t = targets[..., None].long()
    if combine is None:
        gold = torch.gather(logits, -1, t)[..., 0]
    else:
        own = (t >= lo) & (t < lo + v)
        gold = torch.where(own, torch.gather(
            logits, -1, (t - lo).clamp(0, v - 1)), 0.0)[..., 0]
        lse, gold = combine(lse, gold)
    return torch.sum((lse - gold) * mask)


def _ce_over_vocab(logits, targets, mask, cfg: ModelConfig) -> torch.Tensor:
    """``_ce_from_logits`` of placed logits on each rank's vocab shard,
    the (B, s) rows on the targets' batch shards; no rank gathers the
    logits. Each rank masks its own padded columns (at its column offset)
    and takes its shard's log-sum-exp and the gold logit where it owns
    the target (zero elsewhere); one all-gather of the (B, s) log-sum-exps
    over the vocab's mesh dimension, then a log-sum-exp over the ranks,
    and one all-reduce of the gold logits. The rank's (B, s) sum is a
    partial sum over the batch's mesh dimensions. Where no mesh dimension
    of more than one rank shards the vocab, the one-rank function runs on
    the local rows."""
    lo, mdim = shd.shard_offset(logits, 2)
    rows = shd.keep_shard(targets.placements, 0)
    lp = rows if mdim is None else shd.shard_on(rows, 2, mdim)
    out = shd.partial_on(shd.replicate(logits),
                         [i for i, p in enumerate(rows) if p.is_shard(0)])
    dm = logits.device_mesh

    def combine(lse, gold):
        every = shd.all_gather(lse[None], 0, dm, mdim)
        return (torch.logsumexp(every, dim=0),
                shd.all_reduce(gold, dm, mdim))

    def body(ll_, tl, ml):
        return _nll(ll_, tl, ml, cfg.vocab, lo,
                    None if mdim is None else combine)

    return shd.local_map(body, out, (lp, rows, rows), logits, targets, mask)


def _head_ce(h: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
             lm_head: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return _ce_from_logits(h @ shd.gathered(lm_head, h), targets, mask, cfg)


def loss_fn(params: ll.Params, batch: dict, cfg: ModelConfig
            ) -> tuple[torch.Tensor, dict]:
    """batch: {tokens, targets, mask, [frontend_embeds]} -> (loss, metrics
    {ce, aux, tokens}), the loss ``ce + AUX_LOSS_WEIGHT * aux``.

    Under the reference's condition (``loss_chunk`` off, or not dividing
    S, or S no longer than a chunk) the whole (B, S, Vpad) logits are
    formed; otherwise the head and the cross-entropy run over sequence
    chunks, each checkpointed, so the f32 logits are never whole and
    nothing of them is saved for backward.
    """
    tokens, targets, mask = batch["tokens"], batch["targets"], batch["mask"]
    s = tokens.shape[1]
    chunk = cfg.loss_chunk
    h, aux = _hidden_states(params, tokens, cfg, batch.get("frontend_embeds"))
    if chunk <= 0 or s % chunk or s <= chunk:
        nll = _head_ce(h, targets, mask, params.lm_head, cfg)
    else:
        nll = shd.lift(torch.zeros((), dtype=torch.float32, device=h.device),
                       h)
        for c in range(0, s, chunk):
            sl = slice(c, c + chunk)
            nll = nll + ll.checkpointed(_head_ce, h[:, sl], targets[:, sl],
                                        mask[:, sl], params.lm_head, cfg)
    denom = torch.clamp_min(torch.sum(mask), 1.0)
    # the loss whole on every rank (over a mesh each rank's sum is a
    # partial one over the batch's shards)
    ce = constrain(nll / denom)
    return ce + AUX_LOSS_WEIGHT * aux, {"ce": ce, "aux": aux, "tokens": denom}


def _embed(params: ll.Params, tokens: torch.Tensor, cfg: ModelConfig,
           frontend_embeds: torch.Tensor | None) -> torch.Tensor:
    """Token embeddings (B, S, D), the first F positions overwritten by the
    frontend stub's (B, F, D) embeddings when the config has a frontend.

    ``F.embedding``, not ``embedding[tokens]``: over a vocab-sharded table
    its rule is exact (each rank looks up its rows, one rank's row is
    non-zero, an all-reduce over "model" sums them), where indexing would
    gather the table. The lookup is constrained at once, so that over a
    mesh what follows (the overwrite, the residual adds) meets placed
    rows, not partial sums (``_lookup``)."""
    h = constrain(_lookup(tokens, params.embedding), "batch", "seq", "embed")
    if cfg.frontend != "none" and frontend_embeds is not None:
        h[:, :frontend_embeds.shape[1]] = frontend_embeds.to(h.dtype)
    return h


def _lookup(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``F.embedding`` of ``tokens`` in ``table``. Over a mesh whose rules
    shard the table's embed dim too (FSDP serving), the table is first
    taken whole on that dim (an all-gather of each rank's vocab rows, as
    an FSDP weight is gathered): DTensor's rule for a lookup in a table
    sharded on both dims builds its vocab mask for other rows than the
    ones it looks up."""
    if shd.is_placed(table) and any(p.is_shard(1) for p in table.placements):
        table = table.redistribute(
            placements=shd.keep_shard(table.placements, 0))
    return F.embedding(tokens.long(), table)


def _hidden_states(params: ll.Params, tokens: torch.Tensor, cfg: ModelConfig,
                   frontend_embeds: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """forward() minus the lm_head: final-norm hidden states (B, S, D)."""
    h = constrain(_embed(params, tokens, cfg, frontend_embeds),
                  "batch", "seq", "embed")
    stack = {"attn": tf.attn_stack, "mamba2": tf.mamba_stack,
             "rwkv6": tf.rwkv_stack}[cfg.block_type]
    h, aux = stack(params.stack, h, cfg, _positions(tokens))
    return ll.rmsnorm(h, shd.gathered(params.ln_f, h), cfg.norm_eps), aux


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


def cache_axes(cfg: ModelConfig):
    """The logical axes of ``init_cache(cfg, ...)``'s tree."""
    if cfg.block_type == "attn":
        return kvc.pq_cache_axes() if cfg.kv_pq else kvc.exact_cache_axes()
    if cfg.block_type == "mamba2":
        return tf.mamba_cache_axes(cfg)
    return tf.rwkv_cache_axes()


@torch.inference_mode()
def decode_step(params: ll.Params, cache, tokens: torch.Tensor,
                position: torch.Tensor, cfg: ModelConfig):
    """One decode step. tokens: (B,) int; position: (B,) int32.

    Returns (logits (B, Vpad), cache), the cache updated in place.
    """
    h = constrain(_lookup(tokens, params.embedding), "batch", "embed")
    if cfg.block_type == "attn":
        h, cache = tf.attn_stack_decode(params.stack, h, cfg, cache, position)
    elif cfg.block_type == "mamba2":
        h, cache = tf.mamba_stack_decode(params.stack, h, cfg, cache,
                                         position, h)
    else:
        h, cache = tf.rwkv_stack_decode(params.stack, h, cfg, cache, position)
    h = ll.rmsnorm(h, params.ln_f, cfg.norm_eps)
    return constrain(h @ params.lm_head, "batch", "vocab"), cache


@torch.inference_mode()
def prefill(params: ll.Params, tokens: torch.Tensor, cfg: ModelConfig,
            max_seq: int | None = None, frontend_embeds=None, pq_cache=None):
    """Prefill a prompt, returning (last-position logits, filled cache).

    Attention family: one pass through the stack that also captures each
    layer's K/V into an exact cache of ``max_seq`` positions (zero past the
    prompt; ``frontend_embeds`` written over the first positions), or
    their 4-bit PQ codes when ``cfg.kv_pq`` (``pq_cache``, a
    ``PQKVCache``, carries calibrated codebooks; the embeddings are
    dropped, as the reference's ``encode_pq_cache`` drops them). Mamba2 /
    RWKV6 (no embeddings either, as in the reference): the
    chunked scans emit their O(1) states; the hybrid's shared attention
    fills an exact cache, or with ``cfg.kv_pq`` PQ codes under
    ``pq_cache["attn_k_cb"]`` / ``["attn_v_cb"]`` (G, KV, M, 16, dsub).
    """
    b, s = tokens.shape
    max_seq = max_seq or s
    if cfg.block_type != "attn":
        h = constrain(_lookup(tokens, params.embedding), "batch", "seq",
                      "embed")
        if cfg.block_type == "mamba2":
            positions = _positions(tokens)
            if cfg.kv_pq and cfg.shared_attn_every:
                assert pq_cache is not None, \
                    "PQ prefill needs calibrated codebooks"
                h, cache = tf.mamba_stack_prefill_pq(
                    params.stack, h, cfg, positions, max_seq, pq_cache)
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

    h = _embed(params, tokens, cfg, frontend_embeds)
    positions = _positions(tokens)
    if shd.is_placed(h):
        cache = kvc.ExactKVCache(*(
            shd.placed_zeros((cfg.n_layers, b, max_seq, cfg.n_kv_heads,
                              cfg.resolved_head_dim), kvc.EXACT_KV_AXES,
                             h.dtype, h.device) for _ in range(2)))
    else:
        cache = kvc.init_exact(cfg, b, max_seq, h.dtype, h.device)
    for i, lp in enumerate(params.stack.blocks):
        h, k, v = _prefill_layer(lp, h, cfg, positions)
        kvc.write_prompt(cache.k[i], k)
        kvc.write_prompt(cache.v[i], v)
    h = ll.rmsnorm(h, params.ln_f, cfg.norm_eps)
    return h[:, -1] @ params.lm_head, cache


def _prefill_layer(lp: ll.Params, h: torch.Tensor, cfg: ModelConfig,
                   positions: torch.Tensor):
    """One block over the prompt: (h, k, v), k and v (B, S, KV, hd)."""
    x = ll.rmsnorm(h, lp.ln1, cfg.norm_eps)
    q, k, v = ll.qkv_project(lp.attn, x, cfg, positions)
    out = ll.chunked_causal_attention(q, k, v, cfg)
    h = h + constrain(ll.unproject(out, lp.attn.wo), "batch", "seq",
                      "embed")
    h = h + tf.block_ffn(lp, ll.rmsnorm(h, lp.ln2, cfg.norm_eps), cfg)
    return h, k, v


@torch.inference_mode()
def encode_pq_cache(params: ll.Params, tokens: torch.Tensor, cfg: ModelConfig,
                    cache: kvc.PQKVCache):
    """Prefill into a PQ cache whose codebooks are already calibrated: its
    code tensors are filled in place (zero past the prompt)."""
    h = _embed(params, tokens, cfg, None)
    positions = _positions(tokens)
    cache.k_codes.zero_()
    cache.v_codes.zero_()
    for i, lp in enumerate(params.stack.blocks):
        h, k, v = _prefill_layer(lp, h, cfg, positions)
        kvc.write_prompt(cache.k_codes[i], k, cache.k_cb[i])
        kvc.write_prompt(cache.v_codes[i], v, cache.v_cb[i])
    h = ll.rmsnorm(h, params.ln_f, cfg.norm_eps)
    return h[:, -1] @ params.lm_head, cache
