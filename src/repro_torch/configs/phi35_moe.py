"""phi3.5-moe-42b-a6.6b — 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, MoE 16e top-2.  [hf:microsoft/Phi-3.5-MoE-instruct; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    block_pattern=("attn_moe",),
    repeat=32,
    n_experts=16,
    n_experts_active=2,
    moe_d_ff=6400,
    rope_theta=10_000.0,
    mlp_type="swiglu",
    norm_type="layernorm",
    dtype="bfloat16",
    tie_embeddings=False,
)
