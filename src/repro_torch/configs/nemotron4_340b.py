"""nemotron-4-340b — 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000.  GQA + squared-ReLU MLP.  [arXiv:2402.16819; unverified]

The memory monster of the pool: ~340B params.  Uses the `fsdp2d` sharding
profile (params sharded over data AND model axes, ZeRO-3 style) plus bf16
params to fit the v5e HBM budget — see launch/sharding.py and
EXPERIMENTS.md §Dry-run.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab_size=256000,
    block_pattern=("attn_mlp",),
    repeat=96,
    rope_theta=10_000.0,
    mlp_type="relu2",
    norm_type="layernorm",
    tie_embeddings=False,
    dtype="bfloat16",
)
