"""zamba2-2.7b — 54 blocks d_model=2560, Mamba2 mixers + a shared
attention+MLP block applied every 6th position, ssm_state=64, 32H MHA,
d_ff=10240, vocab=32000.  [arXiv:2411.15242; hf]

Simplification noted in DESIGN.md: the shared block reuses one set of
weights at every application (true to Zamba2), but we omit the per-
application LoRA deltas and the concatenated-embedding re-injection.

This is the arch most representative of the paper's technique: its Mamba2
conv branch can run through repro_torch.core.fftconv, and hybrid 500k-context
decode stresses the data-movement trade-offs the paper studies.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    block_pattern=("mamba2",) * 6 + ("shared_attn",),
    repeat=9,                        # 54 mamba2 blocks + 9 shared-attn apps
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    rope_theta=10_000.0,
    mlp_type="gelu",
    norm_type="rmsnorm",
    tie_embeddings=True,
)
