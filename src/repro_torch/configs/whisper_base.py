"""whisper-base [audio]: encoder-decoder, conv frontend stubbed.

enc 6L + dec 6L, d_model=512 8H (head_dim=64) d_ff=2048 vocab=51865
[arXiv:2212.04356].  input_specs() provides precomputed frame embeddings
[B, T, 512] (conv1/conv2 mel frontend out of scope per assignment).
Decode shapes = one token against an encoder memory of seq_len frames
(cross-attention is the long axis); long_500k retrieves from an
HNTL-indexed encoder memory — the paper's Mode B as cross-attention.
"""
from ..models.config import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec",
    n_layers=6, n_enc_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    head_dim=64, d_ff=2048, vocab=51865,
    pattern=(LayerSpec("attn"),), mlp_kind="gelu", norm="layer",
    tie_embeddings=True, max_target_len=448,
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="encdec",
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=128, vocab=512,
    pattern=(LayerSpec("attn"),), mlp_kind="gelu", norm="layer",
    tie_embeddings=True, max_target_len=64,
    kv_kt=4, kv_cap=16, kv_nprobe=2, kv_pool=8, kv_tail=16,
)
