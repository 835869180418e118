"""dbrx-132b [moe]: 16 experts top-4, fine-grained FFN.

40L d_model=6144 48H (GQA kv=8, head_dim=128) expert d_ff=10752
vocab=100352, MoE 16e top-4 [hf:databricks/dbrx-base].
"""
from ..models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=10752, vocab=100352,
    pattern=(LayerSpec("attn"),), mlp_kind="swiglu", norm="layer",
    rope_theta=500000.0, tie_embeddings=False,
    n_experts=16, moe_top_k=4, norm_topk=True,
)

SMOKE = ModelConfig(
    name="dbrx-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=64, vocab=512,
    pattern=(LayerSpec("attn"),), mlp_kind="swiglu", norm="layer",
    rope_theta=500000.0, tie_embeddings=False,
    n_experts=4, moe_top_k=2, norm_topk=True, capacity_factor=2.0,  # no-drop for smoke determinism
    kv_kt=4, kv_cap=16, kv_nprobe=2, kv_pool=8, kv_tail=16,
)
