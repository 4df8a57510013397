"""h2o-danube-1.8b — 24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000.
Llama+Mistral mix with sliding-window attention.  [arXiv:2401.16818; hf]

The 4096-token sliding window makes this arch sub-quadratic: `long_500k`
decode runs with a bounded ring KV cache (DESIGN.md §Arch-applicability).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab_size=32000,
    block_pattern=("attn_mlp",),
    repeat=24,
    sliding_window=4096,
    rope_theta=10_000.0,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    tie_embeddings=False,
)
