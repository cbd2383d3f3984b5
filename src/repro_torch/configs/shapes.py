"""The assigned input-shape set (the port's copy of ``repro.configs.shapes``):
every (arch x shape) pair is one cell.

train_*   the train step (forward, backward and the optimizer update)
prefill_* the prefill forward (logits and populated caches)
decode_*  / long_* the serve step (one new token against a seq_len KV cache)

long_500k needs sub-quadratic attention: it applies to the ssm and hybrid
families only (``ModelConfig.is_subquadratic``).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str  # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": Shape("train_4k", "train", 4096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32768, 128),
    "long_500k": Shape("long_500k", "decode", 524288, 1),
}


def cell_is_applicable(cfg, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return cfg.is_subquadratic()
    return True


def applicable_shapes(cfg):
    return [s for n, s in SHAPES.items() if cell_is_applicable(cfg, n)]
