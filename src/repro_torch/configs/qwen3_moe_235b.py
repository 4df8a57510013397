"""qwen3-moe-235b-a22b — 94L d_model=4096 64H (GQA kv=4) MoE 128e top-8,
expert d_ff=1536, vocab=151936.  [hf:Qwen/Qwen3-30B-A3B family; hf]

Qwen3 specifics: head_dim=128 (decoupled from d_model/n_heads), qk-norm,
no qkv bias, every layer MoE, SwiGLU experts, RMSNorm, rope_theta=1e6.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    block_pattern=("attn_moe",),
    repeat=94,
    n_experts=128,
    n_experts_active=8,
    moe_d_ff=1536,
    qk_norm=True,
    rope_theta=1_000_000.0,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    dtype="bfloat16",
    tie_embeddings=False,
)
