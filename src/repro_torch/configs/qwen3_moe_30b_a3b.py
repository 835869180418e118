"""qwen3-moe-30b-a3b [moe]: 128 experts top-8, QK-norm.

48L d_model=2048 32H (GQA kv=4, head_dim=128) expert d_ff=768 vocab=151936
MoE 128e top-8 [hf:Qwen/Qwen3-30B-A3B].
"""
from ..models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=768, vocab=151936,
    pattern=(LayerSpec("attn"),), mlp_kind="swiglu", norm="rms",
    qk_norm=True, rope_theta=1000000.0, tie_embeddings=False,
    n_experts=128, moe_top_k=8, norm_topk=True,
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=32, vocab=512,
    pattern=(LayerSpec("attn"),), mlp_kind="swiglu", norm="rms",
    qk_norm=True, rope_theta=1000000.0, tie_embeddings=False,
    n_experts=8, moe_top_k=2, norm_topk=True, capacity_factor=4.0,  # no-drop for smoke determinism
    kv_kt=4, kv_cap=16, kv_nprobe=2, kv_pool=8, kv_tail=16,
)
