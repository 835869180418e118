"""rwkv6-1.6b [ssm]: Finch — attention-free, data-dependent decay.

24L d_model=2048 d_ff=7168 vocab=65536 head_size=64 [arXiv:2404.05892].
The paper's HNTL-KV technique is inapplicable (no KV cache to index);
implemented without it per the assignment (DESIGN.md SS Arch-applicability).
"""
from ..models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=7168, vocab=65536,
    pattern=(LayerSpec("rwkv"),), norm="layer",
    tie_embeddings=False, rwkv_head_size=64,
)

SMOKE = ModelConfig(
    name="rwkv6-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=512,
    pattern=(LayerSpec("rwkv"),), norm="layer",
    tie_embeddings=False, rwkv_head_size=16,
)
