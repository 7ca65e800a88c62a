"""rwkv6-3b "Finch" [ssm]: 32L d_model=2560 (attention-free) d_ff=8960
vocab=65536, data-dependent decay. [arXiv:2404.05892; hf]

The paper's PQ-KV technique does not apply here: there is no KV cache, the
state is a fixed (hd x hd) matrix a head. Served without the technique.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    block_type="rwkv6",
    n_layers=32,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=8960,
    vocab=65536,
    rwkv_head_dim=64,
    rwkv_lora=64,
    rwkv_chunk=128,
    remat="group:8",
)

SMOKE = CONFIG.replace(
    name="rwkv6-smoke", n_layers=2, d_model=64, d_ff=96, vocab=256,
    rwkv_head_dim=16, rwkv_lora=8, rwkv_chunk=8, dtype="float32",
    vocab_pad_multiple=8,
)
