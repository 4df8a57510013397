"""fnet_demo — the paper's technique inside a transformer: FNet-style
Fourier token mixing (repro_torch.core.spectral) replaces attention.  Used by the
end-to-end training example; not part of the assigned pool.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="fnet_demo",
    family="dense",
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=32000,
    block_pattern=("fourier_mlp",),
    repeat=12,
    token_mixing="fourier",
    mlp_type="gelu",
    norm_type="layernorm",
    tie_embeddings=True,
)
