"""stablelm-3b [dense]: partial rotary (25%), LayerNorm, SwiGLU.

32L d_model=2560 32H (GQA kv=32, head_dim=80) d_ff=6912 vocab=50304
[hf:stabilityai/stablelm-2-1_6b family].
"""
from ..models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=6912, vocab=50304,
    pattern=(LayerSpec("attn"),), mlp_kind="swiglu", norm="layer",
    rope_theta=10000.0, rotary_pct=0.25, tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="stablelm-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=512,
    pattern=(LayerSpec("attn"),), mlp_kind="swiglu", norm="layer",
    rope_theta=10000.0, rotary_pct=0.25, tie_embeddings=False,
    kv_kt=4, kv_cap=16, kv_nprobe=2, kv_pool=8, kv_tail=16,
)
