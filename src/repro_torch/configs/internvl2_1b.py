"""internvl2-1b [vlm]: 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.
InternViT frontend is a STUB (precomputed patch embeddings per brief);
backbone is the Qwen2-0.5B-style decoder. [arXiv:2404.16821; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151655,            # padded to 153600 internally (vocab_pad_multiple)
    qkv_bias=True,
    mlp_type="swiglu",
    rope_theta=1_000_000.0,
    frontend="patch",
    frontend_len=256,        # 256 precomputed patch embeddings
    remat="layer",
)

SMOKE = CONFIG.replace(
    name="internvl2-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=96, vocab=256, frontend_len=8, dtype="float32",
    attn_q_chunk=32, attn_kv_chunk=32, vocab_pad_multiple=8,
)
