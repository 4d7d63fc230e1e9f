"""Jamba-1.5-Large 398B [arXiv:2403.19887; hf] — hybrid Mamba+attention MoE.

72L d_model=8192, attention every 8th layer (1:7 attn:mamba interleave,
64H GQA kv=8), MoE 16 experts top-2 on every other layer, d_ff=24576,
vocab=65536.  Mamba layers: d_inner=16384, state 16 (mamba-arch default),
head_dim 64 → 256 heads.  Hybrid ⇒ runs the long_500k shape.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    attention="gqa",
    attn_every=8,
    attn_offset=4,
    moe=True,
    num_experts=16,
    experts_per_token=2,
    moe_d_ff=24576,
    moe_every=2,
    moe_offset=1,
    moe_balance="padded",
    moe_impl="shard_map",
    ssm_state=16,
    ssm_heads=256,
    ssm_head_dim=64,
    ssm_conv=4,
    fsdp=True,
    opt_state_dtype="bfloat16",
)
