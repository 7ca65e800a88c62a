"""Stack assembly for the attention (dense, MoE and the frontend stubs'
backbones), Mamba2 (with the zamba2 hybrid) and RWKV6 families (the port
of ``repro/models/transformer.py``).

The reference scans over layer-stacked parameters; here a stack is an
``nn.ModuleList`` of per-layer blocks and a Python loop visits them. The
config's ``remat`` (``none`` | ``layer`` | ``group:k``) is the
reference's: each layer, or each group of k layers (``_group_size``; the
hybrid's unit is its group of Mamba2 layers and the shared block), runs
under ``torch.utils.checkpoint`` and is recomputed in backward, so a
stack saves only the units' inputs. It applies only while autograd
records: serving runs under inference mode and checkpoints nothing.

Decode writes every cache in place: the attention caches at the position
(``kvcache.update_exact`` / ``update_pq``), and each layer's recurrent
state (Mamba ``h`` and ``conv``, RWKV ``s``, ``tm_prev`` and ``cm_prev``)
with ``copy_`` once the layer has read it, where the reference returns new
arrays. So a captured decode step replays against the same storage.

The residual stream is pinned with ``launch.sharding.constrain`` after
each unit where the reference pins it; ``mamba_cache_axes`` and
``rwkv_cache_axes`` give the recurrent caches' logical axes.
"""
from __future__ import annotations

import torch

from repro_torch.launch import sharding as shd
from repro_torch.launch.sharding import constrain
from repro_torch.models import kvcache as kvc
from repro_torch.models import layers as ll
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamSpec


def _remat(cfg: ModelConfig, fn):
    """``fn`` checkpointed (while autograd records) unless the config
    remats nothing."""
    if cfg.remat == "none":
        return fn
    return lambda *args: ll.checkpointed(fn, *args)


def _group_size(cfg: ModelConfig) -> int:
    if cfg.remat.startswith("group:"):
        gs = int(cfg.remat.split(":")[1])
        if gs <= cfg.n_layers and cfg.n_layers % gs == 0:
            return gs
    return 1  # fall back to per-layer remat (e.g. reduced smoke configs)


def _units(blocks, cfg: ModelConfig) -> list:
    """The stack's layers cut into remat units of ``_group_size``."""
    gs = _group_size(cfg)
    return [blocks[i:i + gs] for i in range(0, len(blocks), gs)]


def attn_block_specs(cfg: ModelConfig) -> dict:
    specs = {
        "ln1": ll.rmsnorm_spec(cfg.d_model),
        "ln2": ll.rmsnorm_spec(cfg.d_model),
        "attn": ll.attn_specs(cfg),
    }
    if cfg.n_experts:
        specs["moe"] = moe_mod.moe_specs(cfg)
    else:
        specs["ffn"] = ll.ffn_specs(cfg)
    return specs


def block_ffn(p: ll.Params, hn: torch.Tensor, cfg: ModelConfig
              ) -> torch.Tensor:
    """The block's FFN on (B, S, D) where its aux loss is not wanted
    (prefill, decode): the routed experts (``moe``) or the dense FFN."""
    if cfg.n_experts:
        return moe_mod.moe_ffn(p.moe, hn, cfg)[0]
    return ll.ffn(p.ffn, hn, cfg)


def attn_block(p: ll.Params, h: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm transformer block. Returns (h, aux_loss)."""
    h = h + ll.attention(p.attn, ll.rmsnorm(h, p.ln1, cfg.norm_eps), cfg,
                         positions)
    hn = ll.rmsnorm(h, p.ln2, cfg.norm_eps)
    if cfg.n_experts:
        out, aux = moe_mod.moe_ffn(p.moe, hn, cfg)
    else:
        out, aux = ll.ffn(p.ffn, hn, cfg), torch.zeros((), device=h.device)
    return constrain(h + out, "batch", "seq", "embed"), aux


def attn_stack_specs(cfg: ModelConfig) -> dict:
    return {"blocks": ll.stacked(attn_block_specs(cfg), cfg.n_layers)}


def attn_stack(p: ll.Params, h: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    def unit(h, aux, layers):
        for lp in layers:
            h, a = attn_block(shd.gather_weights(lp, h), h, cfg, positions)
            aux = aux + a
        return h, aux

    body = _remat(cfg, unit)
    aux = torch.zeros((), device=h.device)
    for layers in _units(p.blocks, cfg):
        h, aux = body(h, aux, layers)
    return h, aux


def attn_stack_decode(p: ll.Params, h: torch.Tensor, cfg: ModelConfig,
                      cache, position: torch.Tensor):
    """One-token decode through the stack; cache is Exact or PQ (the
    paper's technique), updated in place at ``position[0]`` before each
    layer scores (the current token attends to itself)."""
    pq = isinstance(cache, kvc.PQKVCache)
    # the batch's write position, read once a step (placed: taken whole
    # over the batch first, an all-gather of B ints)
    pos0 = (position.redistribute(placements=shd.replicate(position))
            if shd.is_placed(position) else position)[0]
    for i, lp in enumerate(p.blocks):
        x = ll.rmsnorm(h, lp.ln1, cfg.norm_eps)
        q, k_new, v_new = ll.qkv_project(lp.attn, x[:, None], cfg,
                                         position[:, None])
        if pq:
            kcod, vcod = kvc.update_pq(cache.k_codes[i], cache.v_codes[i],
                                       k_new[:, 0], v_new[:, 0],
                                       cache.k_cb[i], cache.v_cb[i], pos0)
            out = kvc.pq_decode_attention(q[:, 0], kcod, vcod, cache.k_cb[i],
                                          cache.v_cb[i], position,
                                          quantize_q8=True)
        else:
            kc, vc = kvc.update_exact(cache.k[i], cache.v[i], k_new[:, 0],
                                      v_new[:, 0], pos0)
            out = ll.decode_attention_scores(q[:, 0], kc, vc, cfg, position)
        h = h + constrain(ll.unproject(out, lp.attn.wo), "batch", "embed")
        hn = ll.rmsnorm(h, lp.ln2, cfg.norm_eps)
        h = h + block_ffn(lp, hn[:, None], cfg)[:, 0]
    return h, cache


# ---------------------------------------------------------------------------
# mamba2 family (+ the zamba2 hybrid: a shared attention block every k
# layers)
# ---------------------------------------------------------------------------

def mamba_stack_specs(cfg: ModelConfig) -> dict:
    specs = {"blocks": ll.stacked({
        "ln": ll.rmsnorm_spec(cfg.d_model),
        "mamba": ssm_mod.mamba_specs(cfg),
    }, cfg.n_layers)}
    if cfg.shared_attn_every:
        n_groups = cfg.n_layers // cfg.shared_attn_every
        d = cfg.d_model
        specs["shared"] = {
            "ln1": ll.rmsnorm_spec(d),
            "ln2": ll.rmsnorm_spec(d),
            "attn": ll.attn_specs(cfg),
            "ffn": ll.ffn_specs(cfg),
        }
        # zamba2's per-invocation input projection of concat(h, h0)
        specs["group_in"] = ll.stacked(
            {"w": ParamSpec((2 * d, d), ("embed", "embed"))}, n_groups)
    return specs


def _mamba_layer(lp: ll.Params, h: torch.Tensor, cfg: ModelConfig
                 ) -> torch.Tensor:
    return h + ssm_mod.mamba_block(lp.mamba,
                                   ll.rmsnorm(h, lp.ln, cfg.norm_eps), cfg)


def _groups(cfg: ModelConfig) -> range:
    """The hybrid's groups: layers [g k, (g + 1) k) then the shared block."""
    return range(cfg.n_layers // cfg.shared_attn_every)


def _shared_in(p: ll.Params, gi: int, h, h0) -> torch.Tensor:
    """The shared block's input, concat(h, h0) (B, [S,] 2D) times group
    ``gi``'s (2D, D) projection. Where the rules shard the weight over
    the batch's mesh dims (FSDP, training), it is gathered there and, as
    the reference's partitioner does, each rank of the other mesh dims
    contracts its slice of the 2D features: a partial sum, reduced into
    the residual stream's placement at once."""
    x = torch.cat([h, h0], dim=-1)
    w = p.group_in[gi].w
    whole = shd.gathered(w, h)
    if whole is w:
        return x @ w
    return constrain(shd.split_contraction(x, whole), "batch",
                     *("seq",) * (h.ndim - 2), "embed")


def mamba_stack(p: ll.Params, h: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    aux = torch.zeros((), device=h.device)
    if not cfg.shared_attn_every:
        layer = _remat(cfg, lambda h, lp: _mamba_layer(
            shd.gather_weights(lp, h), h, cfg))
        for lp in p.blocks:
            h = layer(h, lp)
        return h, aux
    k = cfg.shared_attn_every

    def group(h, h0, gi):
        for lp in p.blocks[gi * k:(gi + 1) * k]:
            h = _mamba_layer(shd.gather_weights(lp, h), h, cfg)
        shared = shd.gather_weights(p.shared, h)
        # the shared attention block on concat(h, h0), weight-tied
        x = _shared_in(p, gi, h, h0)
        x = x + ll.attention(shared.attn,
                             ll.rmsnorm(x, shared.ln1, cfg.norm_eps), cfg,
                             positions)
        x = x + ll.ffn(shared.ffn, ll.rmsnorm(x, shared.ln2, cfg.norm_eps),
                       cfg)
        return constrain(h + x, "batch", "seq", "embed")

    body = _remat(cfg, group)
    h0 = h
    for gi in _groups(cfg):
        h = body(h, h0, gi)
    return h, aux


def mamba_cache_init(cfg: ModelConfig, batch: int, max_seq: int,
                     dtype: torch.dtype, device: torch.device,
                     placed: bool = False) -> dict:
    """Zero states; with the hybrid's shared attention, an exact
    (``attn_k``/``attn_v``, (G, B, Smax, KV, hd)) or, with ``cfg.kv_pq``, a
    PQ cache (``attn_k_codes``/``attn_v_codes`` u8 and zero bf16 codebooks
    ``attn_k_cb``/``attn_v_cb`` (G, KV, M, 16, dsub), which calibration
    fills). ``placed``: each tensor placed on the active mesh by
    ``mamba_cache_axes`` (each rank allocating its shard)."""
    nh, hd, ds = cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * ds
    shapes = {
        "h": ((cfg.n_layers, batch, nh, hd, ds), torch.float32),
        "conv": ((cfg.n_layers, batch, cfg.ssm_conv - 1, conv_dim), dtype),
    }
    if cfg.shared_attn_every:
        n_groups = cfg.n_layers // cfg.shared_attn_every
        kv, ahd = cfg.n_kv_heads, cfg.resolved_head_dim
        if cfg.kv_pq:
            m = cfg.resolved_kv_pq_m
            for name in ("attn_k_codes", "attn_v_codes"):
                shapes[name] = ((n_groups, batch, max_seq, kv, m // 2),
                                torch.uint8)
            for name in ("attn_k_cb", "attn_v_cb"):
                shapes[name] = ((n_groups, kv, m, 16, ahd // m),
                                torch.bfloat16)
        else:
            for name in ("attn_k", "attn_v"):
                shapes[name] = ((n_groups, batch, max_seq, kv, ahd), dtype)
    return _zeros(shapes, mamba_cache_axes(cfg), device, placed)


def _zeros(shapes: dict, axes: dict, device, placed: bool) -> dict:
    """{name: zeros of its (shape, dtype)}, placed on the active mesh by
    its ``axes`` where ``placed``."""
    if placed:
        return {k: shd.placed_zeros(shape, axes[k], dt, device)
                for k, (shape, dt) in shapes.items()}
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in shapes.items()}


def mamba_cache_axes(cfg: ModelConfig) -> dict:
    """The logical axes of ``mamba_cache_init``'s dict; the shared
    attention's cache, exact or PQ, as the attention family's."""
    axes = {
        "h": ("stack", "batch", "ssm_heads", None, None),
        "conv": ("stack", "batch", None, "mlp"),
    }
    if cfg.shared_attn_every:
        if cfg.kv_pq:
            axes.update({"attn_k_codes": kvc.PQ_CODE_AXES,
                         "attn_v_codes": kvc.PQ_CODE_AXES,
                         "attn_k_cb": kvc.PQ_CB_AXES,
                         "attn_v_cb": kvc.PQ_CB_AXES})
        else:
            axes.update({"attn_k": kvc.EXACT_KV_AXES,
                         "attn_v": kvc.EXACT_KV_AXES})
    return axes


def _mamba_decode_layer(lp: ll.Params, h: torch.Tensor, cfg: ModelConfig,
                        cache: dict, i: int) -> torch.Tensor:
    """Layer ``i``'s decode step; its state written back in place."""
    x = ll.rmsnorm(h, lp.ln, cfg.norm_eps)
    out, new = ssm_mod.mamba_decode_step(
        lp.mamba, x, {"h": cache["h"][i], "conv": cache["conv"][i]}, cfg)
    # both are fresh tensors (conv a view of the step's new window), so
    # the writes read nothing they overwrite
    cache["h"][i].copy_(new["h"])
    cache["conv"][i].copy_(new["conv"])
    return h + out


def mamba_stack_decode(p: ll.Params, h: torch.Tensor, cfg: ModelConfig,
                       cache: dict, position: torch.Tensor, h0: torch.Tensor
                       ) -> tuple[torch.Tensor, dict]:
    """One-token decode. h/h0: (B, D). The cache is updated in place."""
    if not cfg.shared_attn_every:
        for i, lp in enumerate(p.blocks):
            h = _mamba_decode_layer(lp, h, cfg, cache, i)
        return h, cache
    k, shared = cfg.shared_attn_every, p.shared
    for gi in _groups(cfg):
        for i in range(gi * k, (gi + 1) * k):
            h = _mamba_decode_layer(p.blocks[i], h, cfg, cache, i)
        x = _shared_in(p, gi, h, h0)
        xn = ll.rmsnorm(x, shared.ln1, cfg.norm_eps)
        q, k_new, v_new = ll.qkv_project(shared.attn, xn[:, None], cfg,
                                         position[:, None])
        if cfg.kv_pq:
            kcod, vcod = kvc.update_pq(
                cache["attn_k_codes"][gi], cache["attn_v_codes"][gi],
                k_new[:, 0], v_new[:, 0], cache["attn_k_cb"][gi],
                cache["attn_v_cb"][gi], position[0])
            out = kvc.pq_decode_attention(q[:, 0], kcod, vcod,
                                          cache["attn_k_cb"][gi],
                                          cache["attn_v_cb"][gi], position)
        else:
            kc, vc = kvc.update_exact(cache["attn_k"][gi],
                                      cache["attn_v"][gi], k_new[:, 0],
                                      v_new[:, 0], position[0])
            out = ll.decode_attention_scores(q[:, 0], kc, vc, cfg, position)
        x = x + constrain(ll.unproject(out, shared.attn.wo), "batch",
                          "embed")
        x = x + ll.ffn(shared.ffn,
                       ll.rmsnorm(x, shared.ln2, cfg.norm_eps)[:, None],
                       cfg)[:, 0]
        h = h + x
    return h, cache


def _mamba_prefill_layer(lp: ll.Params, h: torch.Tensor, cfg: ModelConfig,
                         cache: dict, i: int) -> torch.Tensor:
    out, st = ssm_mod.mamba_block(lp.mamba, ll.rmsnorm(h, lp.ln, cfg.norm_eps),
                                  cfg, return_state=True)
    cache["h"][i].copy_(st["h"])
    cache["conv"][i].copy_(st["conv"])
    return h + out


def _mamba_prefill(p: ll.Params, h: torch.Tensor, cfg: ModelConfig,
                   positions: torch.Tensor, cache: dict, encode):
    """The prefill shared by both caches: every layer's final state into
    ``cache``, and each group's shared-attention K/V (B, S, KV, hd) handed
    to ``encode(gi, k, v)``."""
    if not cfg.shared_attn_every:
        for i, lp in enumerate(p.blocks):
            h = _mamba_prefill_layer(lp, h, cfg, cache, i)
        return h
    h0, k, shared = h, cfg.shared_attn_every, p.shared
    for gi in _groups(cfg):
        for i in range(gi * k, (gi + 1) * k):
            h = _mamba_prefill_layer(p.blocks[i], h, cfg, cache, i)
        x = _shared_in(p, gi, h, h0)
        xn = ll.rmsnorm(x, shared.ln1, cfg.norm_eps)
        q, kk, vv = ll.qkv_project(shared.attn, xn, cfg, positions)
        out = ll.chunked_causal_attention(q, kk, vv, cfg)
        x = x + constrain(ll.unproject(out, shared.attn.wo), "batch", "seq",
                          "embed")
        x = x + ll.ffn(shared.ffn, ll.rmsnorm(x, shared.ln2, cfg.norm_eps),
                       cfg)
        encode(gi, kk, vv)
        h = constrain(h + x, "batch", "seq", "embed")
    return h


def mamba_stack_prefill(p: ll.Params, h: torch.Tensor, cfg: ModelConfig,
                        positions: torch.Tensor, max_seq: int
                        ) -> tuple[torch.Tensor, dict]:
    """Full-sequence forward that also emits the decode cache (states, and
    the shared attention's exact K/V, zero past the prompt); placed on the
    mesh where ``h`` is."""
    b = h.shape[0]
    if cfg.kv_pq and cfg.shared_attn_every:
        raise NotImplementedError(
            "hybrid PQ prefill: encode via examples/serve_lm.py calibration")
    cache = mamba_cache_init(cfg, b, max_seq, h.dtype, h.device,
                             placed=shd.is_placed(h))

    def encode(gi, kk, vv):
        kvc.write_prompt(cache["attn_k"][gi], kk)
        kvc.write_prompt(cache["attn_v"][gi], vv)

    return _mamba_prefill(p, h, cfg, positions, cache, encode), cache


def mamba_stack_prefill_pq(p: ll.Params, h: torch.Tensor, cfg: ModelConfig,
                           positions: torch.Tensor, max_seq: int,
                           pq_cache: dict) -> tuple[torch.Tensor, dict]:
    """Hybrid prefill with 4-bit-PQ encoding of the shared attention's K/V
    (the paper's technique): the (G, B, S, KV, hd) cache becomes (G, B,
    Smax, KV, M//2) u8 codes (zero past the prompt) under the (G, KV, M,
    16, dsub) codebooks ``pq_cache["attn_k_cb"]`` / ``["attn_v_cb"]``.
    A ``pq_cache`` that holds the whole cache (codes and states: a mesh
    cell's placed one) is filled in place, its codes zeroed first; one
    that holds the codebooks alone gets a new cache around them."""
    b = h.shape[0]
    if "attn_k_codes" in pq_cache:
        cache = pq_cache
        cache["attn_k_codes"].zero_()
        cache["attn_v_codes"].zero_()
    else:
        cache = mamba_cache_init(cfg.replace(kv_pq=True), b, max_seq,
                                 h.dtype, h.device)
        cache["attn_k_cb"] = pq_cache["attn_k_cb"]
        cache["attn_v_cb"] = pq_cache["attn_v_cb"]

    def encode(gi, kk, vv):
        kvc.write_prompt(cache["attn_k_codes"][gi], kk,
                         cache["attn_k_cb"][gi])
        kvc.write_prompt(cache["attn_v_codes"][gi], vv,
                         cache["attn_v_cb"][gi])

    return _mamba_prefill(p, h, cfg, positions, cache, encode), cache


# ---------------------------------------------------------------------------
# rwkv6 family
# ---------------------------------------------------------------------------

def rwkv_stack_specs(cfg: ModelConfig) -> dict:
    return {"blocks": ll.stacked({
        "ln1": ll.rmsnorm_spec(cfg.d_model),
        "ln2": ll.rmsnorm_spec(cfg.d_model),
        "rwkv": rwkv_mod.rwkv_specs(cfg),
    }, cfg.n_layers)}


def _rwkv_layer(lp: ll.Params, h: torch.Tensor, cfg: ModelConfig):
    """One block over a sequence: (h, final state, its ln1 and ln2 inputs
    to the two mixes)."""
    x = ll.rmsnorm(h, lp.ln1, cfg.norm_eps)
    tm, s_final = rwkv_mod.rwkv_time_mix(lp.rwkv, x, cfg)
    h = h + tm
    xn = ll.rmsnorm(h, lp.ln2, cfg.norm_eps)
    h = h + rwkv_mod.rwkv_channel_mix(lp.rwkv, xn)
    return constrain(h, "batch", "seq", "embed"), s_final, x, xn


def rwkv_stack(p: ll.Params, h: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    del positions

    def unit(h, layers):
        for lp in layers:
            h = _rwkv_layer(shd.gather_weights(lp, h), h, cfg)[0]
        return h

    body = _remat(cfg, unit)
    for layers in _units(p.blocks, cfg):
        h = body(h, layers)
    return h, torch.zeros((), device=h.device)


def rwkv_cache_init(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                    device: torch.device, placed: bool = False) -> dict:
    """Zero states (``placed``: on the active mesh by ``rwkv_cache_axes``)."""
    nh, hd, d, n = cfg.rwkv_nheads, cfg.rwkv_head_dim, cfg.d_model, cfg.n_layers
    return _zeros({"s": ((n, batch, nh, hd, hd), torch.float32),
                   "tm_prev": ((n, batch, d), dtype),
                   "cm_prev": ((n, batch, d), dtype)},
                  rwkv_cache_axes(), device, placed)


def rwkv_cache_axes() -> dict:
    return {"s": ("stack", "batch", "ssm_heads", None, None),
            "tm_prev": ("stack", "batch", "embed"),
            "cm_prev": ("stack", "batch", "embed")}


def rwkv_stack_prefill(p: ll.Params, h: torch.Tensor, cfg: ModelConfig
                       ) -> tuple[torch.Tensor, dict]:
    """Full-sequence forward emitting each layer's O(1) decode state."""
    cache = rwkv_cache_init(cfg, h.shape[0], h.dtype, h.device,
                            placed=shd.is_placed(h))
    for i, lp in enumerate(p.blocks):
        h, s_final, x, xn = _rwkv_layer(lp, h, cfg)
        cache["s"][i].copy_(s_final)
        cache["tm_prev"][i].copy_(x[:, -1])
        cache["cm_prev"][i].copy_(xn[:, -1])
    return h, cache


def rwkv_stack_decode(p: ll.Params, h: torch.Tensor, cfg: ModelConfig,
                      cache: dict, position: torch.Tensor
                      ) -> tuple[torch.Tensor, dict]:
    """One-token decode; each layer's state written back in place after
    the layer has read it."""
    del position
    for i, lp in enumerate(p.blocks):
        s, tm_prev, cm_prev = (cache[n][i] for n in ("s", "tm_prev",
                                                     "cm_prev"))
        x = ll.rmsnorm(h, lp.ln1, cfg.norm_eps)
        tm, new = rwkv_mod.rwkv_decode_step(
            lp.rwkv, x, {"s": s, "tm_prev": tm_prev, "cm_prev": cm_prev}, cfg)
        h = h + tm
        xn = ll.rmsnorm(h, lp.ln2, cfg.norm_eps)
        h = h + rwkv_mod.rwkv_channel_mix_step(lp.rwkv, xn, cm_prev)
        s.copy_(new["s"])
        tm_prev.copy_(x)
        cm_prev.copy_(xn)
    return h, cache
