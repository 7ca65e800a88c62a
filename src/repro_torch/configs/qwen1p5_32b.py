"""qwen1.5-32b [dense]: 64L d_model=5120 40H (GQA kv=40) d_ff=27392
vocab=152064, QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]

The reference's PQ-KV showcase arch (its TPU sizing: decode_32k exact KV
does not fit a v5e pod's HBM, the 4-bit PQ cache does).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab=152064,
    qkv_bias=True,
    mlp_type="swiglu",
    rope_theta=1_000_000.0,
    remat="group:8",
    kv_pq=True,          # paper technique: 4-bit PQ KV cache for decode
)

SMOKE = CONFIG.replace(
    name="qwen1.5-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=160, vocab=256, dtype="float32",
    attn_q_chunk=32, attn_kv_chunk=32, vocab_pad_multiple=8,
)
