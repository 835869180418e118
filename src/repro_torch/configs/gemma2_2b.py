"""gemma2-2b [dense]: local+global alternating attention, logit softcaps.

26L d_model=2304 8H (GQA kv=4, head_dim=256) d_ff=9216 (GeGLU) vocab=256000
[arXiv:2408.00118; hf].  Pattern = (local-4096, global); sandwich norms;
embeddings scaled by sqrt(d); attn softcap 50, final logit softcap 30.
"""
from ..models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=9216, vocab=256000,
    pattern=(LayerSpec("attn", window=4096), LayerSpec("attn", window=None)),
    mlp_kind="geglu", norm="rms", post_norm=True,
    rope_theta=10000.0, attn_logit_cap=50.0, final_logit_cap=30.0,
    attn_scale=256 ** -0.5, embed_scale=True, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma2-2b-smoke", family="dense",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512,
    pattern=(LayerSpec("attn", window=16), LayerSpec("attn", window=None)),
    mlp_kind="geglu", norm="rms", post_norm=True,
    rope_theta=10000.0, attn_logit_cap=50.0, final_logit_cap=30.0,
    attn_scale=16 ** -0.5, embed_scale=True, tie_embeddings=True,
    kv_kt=4, kv_cap=16, kv_nprobe=2, kv_pool=8, kv_tail=16,
)
