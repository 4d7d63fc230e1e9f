"""Architecture configuration (a copy of :mod:`repro.models.config`).

One frozen dataclass drives every family in the assigned pool: dense / MoE /
SSM / hybrid / VLM / audio.  `src/repro_torch/configs/<arch>.py` instantiates
the exact published numbers; `smoke()` shrinks any config to CPU scale while
preserving its family topology (same layer kinds, same attention flavor,
fewer/smaller everything).  Fields that only the JAX package's mesh, scan
and remat machinery reads are kept so that the two registries stay equal
field by field; the port ignores them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None  # default d_model // num_heads

    # -- attention flavor --------------------------------------------------
    attention: str = "gqa"          # gqa | mla | none
    qk_norm: bool = False           # qwen3
    qkv_bias: bool = False          # qwen1.5
    rope_theta: float = 10000.0
    # MLA (deepseek-v3)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 0
    qk_nope_head_dim: int = 0
    v_head_dim: int = 0

    # -- FFN / MoE ----------------------------------------------------------
    ffn_activation: str = "swiglu"  # swiglu | gelu
    moe: bool = False
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    moe_layer_start: int = 0        # first k layers stay dense (deepseek-v3)
    moe_every: int = 1              # MoE on layers where i % moe_every == moe_offset
    moe_offset: int = 0
    # Paper-derived dispatch strategy: padded (BS) | sorted_block (WD/EP) |
    # replicate (NS) | multi_round (HP).  See repro/moe/balancing.py.
    moe_balance: str = "padded"
    moe_impl: str = "gspmd"     # gspmd | shard_map (explicit EP, DESIGN.md §6)
    # serving layout: experts one-group-per-device over data×model, tokens
    # move instead of weights (EXPERIMENTS.md §Perf, deepseek decode cell)
    serve_ep: bool = False
    moe_capacity_factor: float = 1.25

    # -- SSM (mamba2) --------------------------------------------------------
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 256

    # -- hybrid (jamba) -------------------------------------------------------
    attn_every: int = 0             # attention at layers i % attn_every == attn_offset
    attn_offset: int = 0

    # -- multimodal stub frontends --------------------------------------------
    frontend: Optional[str] = None  # vision | audio
    num_image_tokens: int = 0       # vlm: precomputed patch embeddings
    cross_attn_every: int = 0       # vlm: cross-attention layer cadence
    num_codebooks: int = 0          # audio: EnCodec codebooks

    # -- extras -----------------------------------------------------------------
    mtp_depth: int = 0              # deepseek-v3 multi-token prediction
    tie_embeddings: bool = False

    # -- numerics / distribution ----------------------------------------------
    dtype: str = "bfloat16"         # activation / param dtype
    remat: bool = True              # activation checkpointing per block
    fsdp: bool = False              # ZeRO-3 param sharding over the data axis
    opt_state_dtype: Optional[str] = None  # bf16 moments for the giants
    # 'scan' (default) | 'unroll': python-loop every internal scan.  Used by
    # the dry-run's reduced-depth cost compiles — XLA HloCostAnalysis counts
    # while bodies once, so cost-accurate variants must be scan-free.
    scan_impl: str = "scan"
    loss_chunk: int = 0          # >0: chunked cross-entropy (seq chunks)
    remat_policy: str = "full"   # full | dots (save matmul outputs)
    microbatches: int = 1        # grad-accumulation microbatches
    # "node splitting" for attention heads: replicate KV heads / pad Q
    # groups so indivisible head counts (24H/8kv over 16-way TP) shard
    # instead of replicating the whole attention computation (§Perf A3)
    pad_heads: bool = False
    attn_block_q: int = 512
    attn_block_k: int = 1024

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.attention == "mla":
            return self.qk_nope_head_dim + self.qk_rope_head_dim
        return self.head_dim or (self.d_model // self.num_heads)

    def layer_kind(self, i: int) -> str:
        """'attn' | 'mamba' — sequence-mixer kind for layer i."""
        if self.family == "ssm":
            return "mamba"
        if self.attn_every:
            return "attn" if i % self.attn_every == self.attn_offset else "mamba"
        return "attn"

    def layer_is_moe(self, i: int) -> bool:
        if not self.moe:
            return False
        if i < self.moe_layer_start:
            return False
        return i % self.moe_every == self.moe_offset

    def layer_is_cross_attn(self, i: int) -> bool:
        return bool(self.cross_attn_every) and (
            i % self.cross_attn_every == self.cross_attn_every - 1)

    def num_params(self) -> int:
        """Parameter count from the port's own parameter specs."""
        from repro_torch.models.model import model_param_specs
        from repro_torch.models.params import param_count
        return param_count(model_param_specs(self))

    def active_params(self) -> int:
        """Active (per-token) parameter count — MoE counts only routed
        experts actually used (top-k of E) + shared experts."""
        if not self.moe:
            return self.num_params()
        total = self.num_params()
        n_moe_layers = sum(self.layer_is_moe(i) for i in range(self.num_layers))
        ff_mult = 3 if self.ffn_activation == "swiglu" else 2
        per_expert = ff_mult * self.d_model * self.moe_d_ff
        inactive = n_moe_layers * per_expert * (
            self.num_experts - self.experts_per_token)
        return total - inactive

    def smoke(self, **overrides) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        # keep every structural feature present: at least one attention
        # layer (hybrid), one cross-attn layer (vlm), one MoE layer
        min_layers = max(4, self.attn_every, self.cross_attn_every,
                         self.moe_layer_start + 1)
        changes = dict(
            num_layers=min(self.num_layers, min_layers),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) or 2,
            head_dim=32,
            d_ff=256,
            vocab_size=min(self.vocab_size, 512),
            num_image_tokens=min(self.num_image_tokens, 16),
        )
        if self.attention == "mla":
            changes.update(q_lora_rank=64, kv_lora_rank=32,
                           qk_rope_head_dim=16, qk_nope_head_dim=32,
                           v_head_dim=32, head_dim=None)
        if self.moe:
            changes.update(num_experts=min(self.num_experts, 8),
                           experts_per_token=min(self.experts_per_token, 2),
                           moe_d_ff=128)
        if self.ssm_state:
            changes.update(ssm_state=16, ssm_heads=4, ssm_head_dim=16,
                           ssm_chunk=32)
        changes.update(overrides)
        return dataclasses.replace(self, **changes)
