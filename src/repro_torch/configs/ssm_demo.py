"""ssm_demo — a small pure-Mamba2 stack whose causal-conv branch runs
through the fused spectral-convolution plan (``use_fft_conv=True``,
``fft_backend="cuda"``, the reference's ``"pallas"``): the model-stack
consumer of ``kind="conv_causal"`` plans.  Used by the training example's
``--ssm`` mode and the CI model-smoke step; not part of the assigned pool.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="ssm_demo",
    family="ssm",
    d_model=256,
    n_heads=4,
    n_kv_heads=4,
    head_dim=64,
    d_ff=1024,
    vocab_size=32000,
    block_pattern=("mamba2",),
    repeat=4,
    ssm_state=32,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=64,
    mlp_type="gelu",
    norm_type="rmsnorm",
    tie_embeddings=True,
    use_fft_conv=True,
    fft_backend="cuda",
)
