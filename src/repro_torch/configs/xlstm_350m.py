"""xlstm-350m — 24 blocks d_model=1024 4H, sLSTM + mLSTM mix, d_ff=0 (the
blocks carry their own up/down projections), vocab=50304.
[arXiv:2405.04517; unverified]

Block ratio ~[5:1] mLSTM:sLSTM (the paper's large models are mLSTM-heavy).
4 heads do not divide the 16-wide model axis: `fsdp` sharding profile.
Fully recurrent -> long_500k decode runs with O(1) state.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm",) * 5 + ("slstm",),
    repeat=4,                        # 24 blocks
    mlstm_chunk=128,
    norm_type="layernorm",
    tie_embeddings=True,
)
