"""qwen2-vl-2b [vlm]: M-RoPE backbone, dynamic-resolution ViT stubbed.

28L d_model=1536 12H (GQA kv=2, head_dim=128) d_ff=8960 vocab=151936
[arXiv:2409.12191].  mrope_sections=(16,24,24) over head_dim/2=64 freq
slots; input_specs() provides token ids + [3,B,S] positions + precomputed
patch embeddings (ViT frontend out of scope per assignment).
"""
from ..models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
    d_ff=8960, vocab=151936,
    pattern=(LayerSpec("attn"),), mlp_kind="swiglu", norm="rms",
    qkv_bias=True, rope_theta=1000000.0,
    mrope_sections=(16, 24, 24), tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen2-vl-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512,
    pattern=(LayerSpec("attn"),), mlp_kind="swiglu", norm="rms",
    qkv_bias=True, rope_theta=1000000.0,
    mrope_sections=(2, 3, 3), tie_embeddings=True,
    kv_kt=4, kv_cap=16, kv_nprobe=2, kv_pool=8, kv_tail=16,
)
