"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000,
ssm_state=64, Mamba2 backbone + shared attention block every 6 layers.
[arXiv:2411.15242; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    block_type="mamba2",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_expand=2,
    ssm_chunk=128,
    shared_attn_every=6,     # 9 shared-attn invocations over 54 mamba layers
    mlp_type="swiglu",
    rope_theta=10_000.0,
    remat="layer",
    kv_pq=True,              # paper tech on the shared-attn KV at long context
)

SMOKE = CONFIG.replace(
    name="zamba2-smoke", n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=96, vocab=256, ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
    shared_attn_every=2, dtype="float32",
    attn_q_chunk=32, attn_kv_chunk=32, vocab_pad_multiple=8,
)
