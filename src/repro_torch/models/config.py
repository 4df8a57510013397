"""Model configuration: one dataclass drives every architecture in the pool
(a copy of :mod:`repro.models.config`, which imports no JAX; the port keeps
its own).

A model is a stack of ``repeat`` copies of a *super-block*, a static tuple
of block types, so heterogeneous stacks (zamba2's mamba+shared-attention,
xlstm's mLSTM/sLSTM mix) repeat one block pattern.  The model stack
(:mod:`repro_torch.models.model`) and :mod:`repro_torch.data.pipeline` read
it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | audio | vlm
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    # depth = repeat x len(block_pattern)
    block_pattern: Tuple[str, ...]   # e.g. ("attn_mlp",) / ("mamba2",)*5+("shared_attn",)
    repeat: int
    head_dim: Optional[int] = None   # default d_model // n_heads

    # --- attention options ---
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: Optional[int] = None      # SWA width (tokens)
    causal: bool = True
    attn_chunk: int = 512            # streaming-softmax block size

    # --- mlp / norm ---
    mlp_type: str = "swiglu"         # swiglu | gelu | relu2
    mlp_bias: bool = False
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm
    norm_eps: float = 1e-5

    # --- MoE ---
    n_experts: int = 0
    n_experts_active: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    moe_prefill_cap_scale: float = 2.0   # prefill capacity headroom
    router_aux_weight: float = 0.01

    # --- SSM (Mamba2) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128

    # --- xLSTM ---
    mlstm_chunk: int = 128
    slstm_head_dim: Optional[int] = None

    # --- io ---
    input_mode: str = "tokens"       # tokens | embeddings (vlm/audio stubs)
    tie_embeddings: bool = True
    vocab_pad_multiple: int = 128

    # --- technique integration ---
    token_mixing: str = "attention"  # attention | fourier (FNet mixing)
    use_fft_conv: bool = False       # Mamba2 conv branch via repro.core.fftconv
    fft_backend: str = "torch"       # torch | cuda: backend for the FFT paths
    #   (fft_conv plans + fourier_mix); cuda requests demote with a
    #   registry-visible reason when no kernel schedule exists

    # --- numerics ---
    dtype: str = "float32"           # activation/param dtype
    remat: bool = True               # checkpoint each super-block in train

    @property
    def n_layers(self) -> int:
        return self.repeat * len(self.block_pattern)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def d_inner(self) -> int:        # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        shrink = dict(
            d_model=max(32, self.resolved_head_dim),
            n_heads=4, n_kv_heads=min(4, max(1, self.n_kv_heads)),
            head_dim=16, d_ff=64, vocab_size=256, repeat=2,
            rope_theta=self.rope_theta,
            sliding_window=16 if self.sliding_window else None,
            attn_chunk=16, ssm_chunk=16, mlstm_chunk=16,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            n_experts=8 if self.n_experts else 0,
            n_experts_active=min(2, self.n_experts_active),
            moe_d_ff=32 if self.n_experts else 0,
            vocab_pad_multiple=32,
            dtype="float32",         # reduced configs always test in f32
        )
        shrink["d_model"] = 64
        shrink.update(overrides)
        return dataclasses.replace(self, **shrink)
