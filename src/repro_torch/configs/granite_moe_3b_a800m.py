"""IBM Granite 3.0 3B-A800M MoE [hf:ibm-granite; assigned spec].

32L d_model=1536 24H (GQA kv=8) expert d_ff=512 vocab=49155,
MoE 40 experts top-8.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    attention="gqa",
    moe=True,
    num_experts=40,
    experts_per_token=8,
    moe_d_ff=512,
    moe_balance="padded",
)
