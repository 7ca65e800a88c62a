"""Model configuration schema (a copy of the reference's ``ModelConfig``).

One frozen dataclass drives model construction and the analytic parameter
count. The port serves the dense attention, Mamba2 (and zamba2 hybrid) and
RWKV6 families; the MoE and frontend fields are kept so that configs
compare alike.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | vlm | audio | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int                 # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab: int

    # --- attention details
    head_dim: int = 0            # 0 -> d_model // n_heads
    rope_theta: float = 10_000.0
    qk_norm: bool = False        # qwen3
    qkv_bias: bool = False       # qwen1.5
    attn_logit_softcap: float = 0.0

    # --- FFN
    mlp_type: str = "swiglu"     # swiglu | gelu | relu2 (squared ReLU)

    # --- MoE
    n_experts: int = 0
    n_experts_active: int = 0
    moe_every: int = 1           # MoE layer cadence (1 = every layer)
    shared_expert: bool = False  # llama4-style always-on expert
    router_act: str = "softmax"  # softmax | sigmoid
    capacity_factor: float = 1.25
    moe_groups: int = 32         # dispatch groups; align with pod x data

    # --- SSM (Mamba2) / hybrid
    block_type: str = "attn"     # attn | mamba2 | rwkv6
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 128
    shared_attn_every: int = 0   # zamba2: one shared attn block every k ssm layers

    # --- RWKV6
    rwkv_head_dim: int = 64
    rwkv_lora: int = 32
    rwkv_chunk: int = 128

    # --- modality frontend (STUB per brief: precomputed embeddings)
    frontend: str = "none"       # none | patch (vlm) | codec (audio)
    frontend_len: int = 0        # number of prepended frontend embeddings

    # --- numerics / lowering
    dtype: str = "bfloat16"
    loss_chunk: int = 512        # seq-chunked cross-entropy (0 = off)
    norm_eps: float = 1e-5
    remat: str = "layer"         # none | layer | group:<k>
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024
    vocab_pad_multiple: int = 2048

    # --- paper technique: PQ-compressed KV cache for decode
    kv_pq: bool = False
    kv_pq_m: int = 0             # sub-quantizers per head (0 -> head_dim // 2)

    # -------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        assert self.n_heads > 0
        return self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab + m - 1) // m) * m

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def rwkv_nheads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    @property
    def resolved_kv_pq_m(self) -> int:
        return self.kv_pq_m or self.resolved_head_dim // 2

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (embedding included once)."""
        d, v = self.d_model, self.padded_vocab
        total = v * d * 2  # embed + unembed
        hd = self.resolved_head_dim if self.n_heads else 0
        for layer in range(self.n_layers):
            if self.block_type in ("attn",) or (
                    self.block_type == "mamba2" and self.shared_attn_every):
                pass
            if self.block_type == "attn":
                total += self._attn_params(d, hd)
                total += self._ffn_params(layer)
                total += 2 * d  # norms
            elif self.block_type == "mamba2":
                total += self._mamba_params()
                total += d
            elif self.block_type == "rwkv6":
                total += self._rwkv_params()
                total += 2 * d
        if self.block_type == "mamba2" and self.shared_attn_every:
            total += self._attn_params(d, hd) + self._ffn_params(0) + 2 * d
            total += (self.n_layers // self.shared_attn_every) * 2 * d * d  # io projs
        return total

    def _attn_params(self, d: int, hd: int) -> int:
        q = d * self.n_heads * hd
        kv = 2 * d * self.n_kv_heads * hd
        o = self.n_heads * hd * d
        bias = (self.n_heads + 2 * self.n_kv_heads) * hd if self.qkv_bias else 0
        qknorm = 2 * hd if self.qk_norm else 0
        return q + kv + o + bias + qknorm

    def _ffn_params(self, layer: int) -> int:
        d, f = self.d_model, self.d_ff
        dense = 3 * d * f if self.mlp_type == "swiglu" else 2 * d * f
        if self.n_experts and layer % self.moe_every == 0:
            ffn = self.n_experts * dense + d * self.n_experts
            if self.shared_expert:
                ffn += dense
            return ffn
        return dense

    def _mamba_params(self) -> int:
        d, di = self.d_model, self.d_inner
        g, ds, nh = self.ssm_groups, self.ssm_state, self.ssm_nheads
        in_proj = d * (2 * di + 2 * g * ds + nh)
        conv = self.ssm_conv * (di + 2 * g * ds)
        extra = 3 * nh + di  # A_log, D, dt_bias, norm
        return in_proj + conv + extra + di * d

    def _rwkv_params(self) -> int:
        d, f, r = self.d_model, self.d_ff, self.rwkv_lora
        tm = 4 * d * d          # r, k, v, g (square: d_head*nh == d)
        tm += d * d             # output proj
        tm += 6 * d + 5 * (d * r + r * d)  # mus + loras (w + 4 mixes)
        tm += 2 * self.d_model  # u bonus + w bias
        cm = 2 * d * f          # channel mix (k, v)... rwkv6 ffn: wk (d,f), wv (f,d), wr (d,d)
        cm += d * d
        return tm + cm

    def active_param_count(self) -> int:
        """Active params per token (MoE counts only routed-active experts)."""
        if not self.n_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense = 3 * d * f if self.mlp_type == "swiglu" else 2 * d * f
        inactive_per_moe_layer = (self.n_experts - self.n_experts_active) * dense
        n_moe_layers = len([l for l in range(self.n_layers) if l % self.moe_every == 0])
        return self.param_count() - n_moe_layers * inactive_per_moe_layer
