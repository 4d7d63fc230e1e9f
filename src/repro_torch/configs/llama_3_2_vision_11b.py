"""Llama 3.2 11B Vision [hf:meta-llama/Llama-3.2-11B-Vision].

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256; gated
cross-attention image layers every 5th layer.  The vision tower is a STUB
per the assignment: ``input_specs`` supplies precomputed, already-projected
patch embeddings [B, 1601, d_model].
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    attention="gqa",
    rope_theta=500000.0,
    frontend="vision",
    num_image_tokens=1601,
    cross_attn_every=5,
)
