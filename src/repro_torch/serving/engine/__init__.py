"""Continuous-batching serving engine over a paged KV cache (the port).

    engine = ServeEngine(model, params, EngineConfig(num_pages=64, page_size=16))
    h = engine.submit(Request(rid=0, prompt=[...],
                              params=GenerationParams(max_new_tokens=32)))
    results = engine.run()          # rid -> RequestState
    print(engine.metrics())         # tokens/s, step and TTFT percentiles, preemptions
"""
from repro_torch.serving.params import (
    FINISH_EOS,
    FINISH_ERROR,
    FINISH_LENGTH,
    GenerationParams,
    RequestHandle,
    Sequence,
)
from repro_torch.serving.sampling import GREEDY, SamplingParams
from repro_torch.serving.telemetry import EngineTrace, MetricsRegistry, validate_chrome_trace

from .cache import PagedKVCache
from .engine import EngineConfig, ServeEngine, aligned_max_logit_err
from .kvquant import KV_DTYPES, PagedQuantSpec
from .request import DECODING, PREFILLING, QUEUED, Request, RequestQueue, RequestState
from .scheduler import Scheduler, SchedulerConfig

__all__ = [
    "DECODING",
    "EngineConfig",
    "EngineTrace",
    "FINISH_EOS",
    "FINISH_ERROR",
    "FINISH_LENGTH",
    "GREEDY",
    "GenerationParams",
    "KV_DTYPES",
    "MetricsRegistry",
    "PREFILLING",
    "PagedKVCache",
    "PagedQuantSpec",
    "QUEUED",
    "Request",
    "RequestHandle",
    "RequestQueue",
    "RequestState",
    "SamplingParams",
    "Scheduler",
    "SchedulerConfig",
    "Sequence",
    "ServeEngine",
    "aligned_max_logit_err",
    "validate_chrome_trace",
]
