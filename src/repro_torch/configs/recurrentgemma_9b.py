"""recurrentgemma-9b [hybrid]: RG-LRU + local attention, 2:1 pattern.

38L d_model=4096 16H (MQA kv=1, head_dim=256) d_ff=12288 (GeGLU)
vocab=256000 [arXiv:2402.19427].  Pattern (rglru, rglru, local-2048-attn)
x12 + tail (rglru, rglru); lru width = d_model; conv width 4.
Natively sub-quadratic: long_500k runs on recurrent state + ring caches —
HNTL-KV not needed (DESIGN.md SS Arch-applicability).
"""
from ..models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12288, vocab=256000,
    pattern=(LayerSpec("rglru"), LayerSpec("rglru"),
             LayerSpec("attn", window=2048)),
    mlp_kind="geglu", norm="rms",
    rope_theta=10000.0, final_logit_cap=30.0, embed_scale=True,
    tie_embeddings=True, conv_width=4, rnn_width=4096,
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke", family="hybrid",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab=512,
    pattern=(LayerSpec("rglru"), LayerSpec("rglru"),
             LayerSpec("attn", window=16)),
    mlp_kind="geglu", norm="rms",
    rope_theta=10000.0, final_logit_cap=30.0, embed_scale=True,
    tie_embeddings=True, conv_width=4, rnn_width=64,
    kv_kt=4, kv_cap=16, kv_nprobe=2, kv_pool=8, kv_tail=16,
)
