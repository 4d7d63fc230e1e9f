"""Qwen3-0.6B [hf:Qwen/Qwen3 family] — dense GQA with per-head qk RMSNorm.

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936, head_dim 128.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=3072,
    vocab_size=151936,
    attention="gqa",
    qk_norm=True,
    head_dim=128,
    rope_theta=1000000.0,
    tie_embeddings=True,
)
