"""StarCoder2-15B [arXiv:2402.19173; hf].

40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152; GQA + RoPE.
(HF uses gelu FFN + learned pos — assignment pins GQA/RoPE; we use the
assigned spec with gelu activation per the original.)
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    attention="gqa",
    ffn_activation="gelu",
    rope_theta=100000.0,
)
