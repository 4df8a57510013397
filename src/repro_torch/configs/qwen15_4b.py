"""qwen1.5-4b — 40L d_model=2560 20H (kv=20, i.e. MHA) d_ff=6912
vocab=151936, QKV bias.  [hf:Qwen/Qwen1.5-0.5B family; hf]

20 heads do not divide the 16-wide model axis: this arch uses the `fsdp`
sharding profile (see launch/sharding.py).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab_size=151936,
    block_pattern=("attn_mlp",),
    repeat=40,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mlp_type="swiglu",
    norm_type="rmsnorm",
    tie_embeddings=True,
)
