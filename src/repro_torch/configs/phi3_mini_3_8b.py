"""phi3-mini-3.8b [dense]: RoPE SwiGLU MHA (kv=32).

32L d_model=3072 32H (GQA kv=32, head_dim=96) d_ff=8192 vocab=32064
[arXiv:2404.14219].
"""
from ..models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, head_dim=96,
    d_ff=8192, vocab=32064,
    pattern=(LayerSpec("attn"),), mlp_kind="swiglu", norm="rms",
    rope_theta=10000.0, tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="phi3-mini-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=512,
    pattern=(LayerSpec("attn"),), mlp_kind="swiglu", norm="rms",
    rope_theta=10000.0, tie_embeddings=False,
    kv_kt=4, kv_cap=16, kv_nprobe=2, kv_pool=8, kv_tail=16,
)
