"""codeqwen1.5-7b [dense]: qwen1.5 arch — QKV bias, long-context theta.

32L d_model=4096 32H (GQA kv=32, head_dim=128) d_ff=13440 vocab=92416
[hf:Qwen/CodeQwen1.5-7B].
"""
from ..models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=13440, vocab=92416,
    pattern=(LayerSpec("attn"),), mlp_kind="swiglu", norm="rms",
    qkv_bias=True, rope_theta=1000000.0, tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="codeqwen-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=512,
    pattern=(LayerSpec("attn"),), mlp_kind="swiglu", norm="rms",
    qkv_bias=True, rope_theta=1000000.0, tie_embeddings=False,
    kv_kt=4, kv_cap=16, kv_nprobe=2, kv_pool=8, kv_tail=16,
)
