"""hubert-xlarge — 48L d_model=1280 16H (MHA) d_ff=5120 vocab=504.
Encoder-only audio transformer (wav2vec2 arch).  [arXiv:2106.07447; unverified]

The CNN waveform frontend is a STUB per the assignment: inputs are
precomputed frame embeddings (input_mode="embeddings").  Encoder-only: no
decode step — decode_32k / long_500k cells are skipped with reason
(DESIGN.md §Arch-applicability).  The natural FFT frontend (STFT features
via the FFT library) is demonstrated in examples/audio_frontend.py.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    block_pattern=("attn_mlp",),
    repeat=48,
    causal=False,
    mlp_type="gelu",
    mlp_bias=True,
    norm_type="layernorm",
    input_mode="embeddings",
    tie_embeddings=False,
    vocab_pad_multiple=128,          # 504 -> 512 (16-way shardable)
)
