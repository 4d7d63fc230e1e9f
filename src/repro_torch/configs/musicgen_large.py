"""MusicGen-Large [arXiv:2306.05284; hf] — decoder-only over EnCodec tokens.

48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048 per codebook, 4 codebooks.
The EnCodec frontend is a STUB per the assignment: the backbone consumes
codebook token ids [B, S, 4] (sum-of-codebook-embeddings in) and emits
4 per-codebook heads out.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    attention="gqa",
    ffn_activation="gelu",
    frontend="audio",
    num_codebooks=4,
)
