"""internvl2-76b — 80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
InternViT + Llama-3-70B-style backbone.  [arXiv:2404.16821; unverified]

VLM: the InternViT frontend is a STUB per the assignment — training/prefill
consume precomputed patch embeddings (input_mode="embeddings"); decode
generates text tokens through the vocab head.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    block_pattern=("attn_mlp",),
    repeat=80,
    rope_theta=500_000.0,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    input_mode="embeddings",
    dtype="bfloat16",
    tie_embeddings=False,
)
