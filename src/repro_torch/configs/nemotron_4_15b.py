"""nemotron-4-15b [dense]: 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000, squared-ReLU FFN. [arXiv:2402.16819; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab=256000,
    mlp_type="relu2",
    rope_theta=10_000.0,
    remat="group:8",
)

SMOKE = CONFIG.replace(
    name="nemotron-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab=256, dtype="float32",
    attn_q_chunk=32, attn_kv_chunk=32, vocab_pad_multiple=8,
)
