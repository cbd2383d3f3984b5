"""ModelConfig — the configuration of the port's model families.

Field names and defaults follow ``repro.models.config.ModelConfig`` so a
config converts field by field. The port runs all six of the reference's
families: "dense" (GQA decoder), "moe" (GQA attention and top-k token-choice
experts: dbrx, kimi-k2), "ssm" (Mamba-2 SSD), "hybrid" (recurrentgemma:
RG-LRU blocks and local attention), "encdec" (whisper: an encoder over
precomputed frames, a decoder with cross-attention) and "vlm"
(llama-3.2-vision: gated cross-attention layers over precomputed image
embeddings).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    vocab: int
    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    window: Optional[int] = None  # local attention window (hybrid archs): not on the paged path
    # mlp
    d_ff: int = 0
    mlp_act: str = "swiglu"
    norm: str = "rmsnorm"  # "rmsnorm" | "layernorm"
    # moe
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # ssm (mamba2 SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_chunk: int = 128
    conv_kernel: int = 4
    # hybrid (recurrentgemma): repeating block pattern, e.g. ("rec", "rec", "local_attn")
    pattern: Tuple[str, ...] = ()
    lru_width: int = 0
    # encoder-decoder (whisper): n_layers == decoder layers
    n_enc_layers: int = 0
    enc_seq: int = 0  # precomputed frame embeddings fed by the stub frontend
    # vlm (llama-3.2-vision): every `cross_every`-th layer is cross-attention
    cross_every: int = 0
    n_img_tokens: int = 0
    # numerics / embedding
    dtype: str = "bfloat16"
    vocab_pad_to: int = 256
    tie_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // max(self.n_heads, 1)

    @property
    def vocab_padded(self) -> int:
        return round_up(self.vocab, self.vocab_pad_to)

    @property
    def param_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def is_subquadratic(self) -> bool:
        """Can this arch serve 500k-token contexts (the long_500k shape)?"""
        return self.family in ("ssm", "hybrid")

    # ssm derived
    @property
    def ssm_dinner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.ssm_dinner // self.ssm_headdim

    @property
    def ssm_conv_dim(self) -> int:
        return self.ssm_dinner + 2 * self.ssm_ngroups * self.ssm_state
