"""musicgen-medium [audio]: 48L d_model=1536 24H (kv=24) d_ff=6144 vocab=2048,
decoder-only over EnCodec tokens. EnCodec frontend is a STUB (precomputed
frame embeddings per brief). [arXiv:2306.05284; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab=2048,
    mlp_type="gelu",
    rope_theta=10_000.0,
    frontend="codec",
    frontend_len=128,        # precomputed EnCodec frame embeddings
    vocab_pad_multiple=256,
    remat="group:8",
)

SMOKE = CONFIG.replace(
    name="musicgen-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=96, vocab=128, frontend_len=8, dtype="float32",
    attn_q_chunk=32, attn_kv_chunk=32, vocab_pad_multiple=8,
)
