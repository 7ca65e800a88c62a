"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352,
MoE 16 experts top-4, fine-grained. [hf:databricks/dbrx-base; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab=100352,
    n_experts=16,
    n_experts_active=4,
    mlp_type="swiglu",
    rope_theta=500_000.0,
    remat="group:8",
)

SMOKE = CONFIG.replace(
    name="dbrx-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=96, vocab=256, n_experts=4, n_experts_active=2, dtype="float32",
    attn_q_chunk=32, attn_kv_chunk=32, vocab_pad_multiple=8,
)
