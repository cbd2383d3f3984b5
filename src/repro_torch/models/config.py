"""ModelConfig — the dense decoder configuration of the port's first slice.

Field names and defaults follow ``repro.models.config.ModelConfig`` so a
config converts field by field; families other than "dense" are refused by
the registry until their slice is ported.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # only "dense" runs in this port so far
    n_layers: int
    d_model: int
    vocab: int
    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    window: Optional[int] = None  # local attention window: not on the paged path
    # mlp
    d_ff: int = 0
    mlp_act: str = "swiglu"
    norm: str = "rmsnorm"
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
