"""starcoder2-15b — 40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152.
GQA + RoPE, LayerNorm, GELU MLP with bias.  [arXiv:2402.19173; hf]

Kept full-attention per the assignment's tagging ([dense] "GQA, RoPE"), so
`long_500k` is skipped for this arch (DESIGN.md §Arch-applicability).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    block_pattern=("attn_mlp",),
    repeat=40,
    rope_theta=100_000.0,
    mlp_type="gelu",
    mlp_bias=True,
    norm_type="layernorm",
    dtype="bfloat16",
    tie_embeddings=True,
)
