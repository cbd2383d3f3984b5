"""SamplingParams: per-request token-selection policy, executed on the device.

Port of ``repro.serving.sampling``. The engine's decode step fuses token
selection (``kernels.ops.sample_tokens``) so logits never leave the device;
this module is the host half: the policy record and the packing of a batch's
policies into the (B,) device vectors the sampler consumes.

Reproducibility contract:
  - greedy (temperature 0) equals host argmax over the same logits row;
  - a sampled request is a pure function of (seed, rid, position): the
    sampler's noise is keyed on the stream seed and the absolute position
    only, so a rerun, another batch composition, or a preempted-and-recomputed
    request gives the same tokens. The noise is the reference's threefry
    stream bit for bit (``kernels.ops.gumbel_noise``);
  - the fused K-step window (EngineConfig.multi_step) samples with the same
    fold, so it is token-exact against single steps.

Speculative stream contract (serving/speculative.py,
``kernels.ops.verify_draft_tokens``): greedy requests are token-exact between
the speculative and the plain paths (accepting argmax-agreeing draft
prefixes reproduces the serial stream). Sampled requests stay a pure function
of (seed, rid, position): the verify derives per-position keys with the same
fold_in(PRNGKey(stream), position) base as sample_tokens, then folds the tag
``ops.SPEC_ACCEPT_FOLD`` (the acceptance uniform) or
``ops.SPEC_RESAMPLE_FOLD`` (the resample Gumbel noise), the reference's bits.
The speculative sampled stream differs from the plain one (rejection
sampling draws other randomness than Gumbel-max): only reproducibility, not
equality across the two paths, holds above temperature 0. A request opts out
with GenerationParams.speculative=False.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """temperature 0 = greedy argmax (the default); temperature > 0 samples
    after the optional top_k (0 = off) and top_p (1.0 = off) filters. ``seed``
    names the request's stream; the effective stream also folds the request id
    (``stream_seed``)."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 = off), got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")

    @property
    def is_greedy(self) -> bool:
        return self.temperature == 0.0


GREEDY = SamplingParams()


def stream_seed(seed: int, rid: int) -> int:
    """The per-request stream id: the user seed mixed with the request id
    (golden-ratio multiply, uint32 wraparound), so concurrent requests sharing
    a seed draw independent streams."""
    return (int(seed) ^ ((int(rid) * 0x9E3779B9) & 0xFFFFFFFF)) & 0xFFFFFFFF


def pack_slot_params(states_by_slot, max_batch: int):
    """The running slots' policies as two packed host arrays:

      f32 (2, B): [temperature, top_p]
      i32 (2, B): [top_k, seed bits] — the uint32 stream seed as int32

    Inactive slots keep greedy defaults (the engine masks them anyway)."""
    f32 = np.zeros((2, max_batch), np.float32)
    f32[1] = 1.0  # top_p off
    i32 = np.zeros((2, max_batch), np.int32)
    for slot, state in states_by_slot.items():
        sp = state.sampling
        f32[0, slot] = sp.temperature
        f32[1, slot] = sp.top_p
        i32[0, slot] = sp.top_k
        i32[1, slot] = np.uint32(stream_seed(sp.seed, state.request.rid)).astype(np.int32)
    return f32, i32
