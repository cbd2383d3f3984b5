"""Per-(arch x shape-kind) sharding policies: logical axis name -> mesh
axes (the port's copy of ``repro.launch.sharding``, table for table).

One ShardingRules table is the parallelism configuration:

  DP    "batch"/"tokens" -> ("pod", "data")
  FSDP  "embed" (the non-TP dim of weight matrices) -> ("pod", "data");
        moments and grads inherit it (a moment carries its parameter's axes)
  TP    "heads"/"kv_heads"/"ffn"/"vocab"/"lru"/"ssm_*" -> "model"
  EP    "expert" -> "model"
  SP    "seq" -> "model" (off by default)
  cache "kv_seq" -> "model" for serving

Divisibility fallbacks happen inside ShardingRules.binding_for (the
offending dim is replicated), so one table serves all ten architectures.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core.distributed import ShardingRules

BATCH = ("pod", "data")  # binding_for drops absent mesh axes


def train_rules(cfg, *, fsdp: bool = True, seq_shard: bool = False) -> ShardingRules:
    rules: Dict[str, object] = {
        # data / tokens
        "batch": BATCH,
        "tokens": BATCH,
        "seq": "model" if seq_shard else None,
        # tensor parallel
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "ffn": "model",
        "lru": "model",
        "lru_gate": None,
        "ssm_inner": "model",
        "ssm_heads": "model",
        "ssm_conv": "model",
        # expert parallel
        "expert": "model",
        "expert_ffn": None,
        # fsdp (ZeRO-3): the non-TP weight dim over the batch axes
        "embed": BATCH if fsdp else None,
        # caches (unused in training)
        "kv_seq": None,
        "layers": None,
    }
    return ShardingRules(rules)


def serve_rules(cfg, *, fsdp_params: bool = False) -> ShardingRules:
    rules: Dict[str, object] = {
        "batch": BATCH,
        "tokens": BATCH,
        "seq": None,
        "vocab": "model",
        "heads": "model",
        "kv_heads": None,  # caches shard the seq dim instead (uniform across archs)
        "kv_seq": "model",
        "ffn": "model",
        "lru": "model",
        "lru_gate": None,
        "ssm_inner": "model",
        "ssm_heads": "model",
        "ssm_conv": "model",
        "expert": "model",
        "expert_ffn": None,
        "embed": BATCH if fsdp_params else None,
        "layers": None,
    }
    return ShardingRules(rules)


def needs_fsdp_for_serving(cfg, *, quantized: bool = False) -> bool:
    """Does TP-16 alone leave more than 11 GB of weights a chip (16 GB less
    ~3 GB of cache and ~2 GB of activations)? int8 weights with per-block
    f32 scales take ~1.07 bytes a parameter, bf16 2."""
    from repro_torch.models import count_params

    bytes_per_param = 1.07 if quantized else 2.0
    return count_params(cfg) * bytes_per_param / 16 > 11e9


def rules_for(cfg, shape_kind: str, *, seq_shard: bool = False,
              quantized: bool = False) -> ShardingRules:
    if shape_kind == "train":
        return train_rules(cfg, seq_shard=seq_shard)
    return serve_rules(cfg, fsdp_params=needs_fsdp_for_serving(cfg, quantized=quantized))
