from .grammar import (
    JSON_ARRAY_CHARS,
    MASK_OFF,
    TokenDFA,
    fixed_json_array_dfa,
    json_array_dfa,
)
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
    distribute_params,
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
    "JSON_ARRAY_CHARS",
    "MASK_OFF",
    "RequestHandle",
    "SamplingParams",
    "Sequence",
    "TokenDFA",
    "distribute_params",
    "fixed_json_array_dfa",
    "json_array_dfa",
    "make_chunked_prefill_step",
    "make_paged_serve_multistep",
    "make_paged_serve_step",
    "make_prefill",
    "make_serve_step",
    "stream_seed",
]
