"""Mamba-2 780M [arXiv:2405.21060] — SSD, attention-free.

48L d_model=1536 vocab=50280 ssm_state=128; expand 2 → d_inner 3072,
head_dim 64 → 48 SSM heads.  Sub-quadratic: runs the long_500k shape.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    attention="none",
    ssm_state=128,
    ssm_heads=48,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_expand=2,
    tie_embeddings=True,
)
