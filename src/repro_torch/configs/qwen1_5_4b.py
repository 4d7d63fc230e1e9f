"""Qwen1.5-4B [hf:Qwen] — llama-arch dense with QKV bias.

40L d_model=2560 20H (kv=20) d_ff=6912 vocab=151936.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    num_layers=40,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    attention="gqa",
    qkv_bias=True,
)
