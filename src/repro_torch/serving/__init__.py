from .params import (
    FINISH_EOS,
    FINISH_ERROR,
    FINISH_LENGTH,
    GenerationParams,
    RequestHandle,
    Sequence,
)
from .sampling import GREEDY, SamplingParams, stream_seed
from .step import (
    make_chunked_prefill_step,
    make_paged_serve_multistep,
    make_paged_serve_step,
    make_prefill,
    make_serve_step,
)

__all__ = [
    "FINISH_EOS",
    "FINISH_ERROR",
    "FINISH_LENGTH",
    "GREEDY",
    "GenerationParams",
    "RequestHandle",
    "SamplingParams",
    "Sequence",
    "make_chunked_prefill_step",
    "make_paged_serve_multistep",
    "make_paged_serve_step",
    "make_prefill",
    "make_serve_step",
    "stream_seed",
]
