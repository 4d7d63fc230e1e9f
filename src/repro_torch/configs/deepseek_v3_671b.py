"""DeepSeek-V3 671B [arXiv:2412.19437; hf].

61L d_model=7168 128H d_ff=2048(first-3-dense d_ff=18432 in HF; the assigned
spec pins d_ff=2048 for the dense path too — we follow the assignment)
vocab=129280; MLA (q_lora 1536, kv_lora 512, rope 64, nope 128, v 128);
MoE 256 routed experts top-8 + 1 shared, first 3 layers dense; MTP depth 1.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    d_ff=18432,
    vocab_size=129280,
    attention="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_rope_head_dim=64,
    qk_nope_head_dim=128,
    v_head_dim=128,
    moe=True,
    num_experts=256,
    experts_per_token=8,
    num_shared_experts=1,
    moe_d_ff=2048,
    moe_layer_start=3,
    moe_balance="padded",
    moe_impl="shard_map",
    mtp_depth=1,
    fsdp=True,
    opt_state_dtype="bfloat16",
)
