"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16e top-1, shared expert, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    n_experts=16,
    n_experts_active=1,
    shared_expert=True,
    router_act="sigmoid",
    mlp_type="swiglu",
    rope_theta=500_000.0,
    remat="group:8",
)

SMOKE = CONFIG.replace(
    name="llama4-scout-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=96, vocab=256, n_experts=4, n_experts_active=1, dtype="float32",
    attn_q_chunk=32, attn_kv_chunk=32, vocab_pad_multiple=8,
)
