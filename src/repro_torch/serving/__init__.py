"""repro_torch.serving — the stable public serving facade of the port.

  from repro_torch.serving import ServeConfig, build_engine

  engine = build_engine(ServeConfig(arch="qwen3-0.6b", full=True,
                                    num_slots=8, prefill_buckets=(16, 32, 64)))
  uid = engine.submit([1, 17, 42], max_new_tokens=8)
  for event in engine.run():        # StreamEvents as tokens decode
      ...

Requests roll through a fixed population of slots; per-request aggregates
fold through ONE planner-lowered keyed masked fold per decode step (request
slot == segment id), on the card through the CUDA segment-fold kernel.
The radix prefix KV cache (:class:`PrefixCache`) serves shared prompt
prefixes from a trie, its bookkeeping one keyed fold per step.
:class:`WindowedMetrics` subscribes to the engine's stream events for
per-user and fleet windows; ``build_serve_step`` and ``run_batched_decode``
are the pre-engine API.
"""
from ..data.windows import WindowedMetrics
from ..launch.serve import (build_engine, build_serve_step, make_backend,
                            poisson_trace, run_batched_decode, serve_trace)
from ..runtime.batcher import BatcherStats, DecodeBatch, Request, RequestBatcher
from ..runtime.engine import (ContinuousEngine, EngineBackend, EngineStats,
                              METRIC_COLS, RequestResult, ServeConfig,
                              StreamEvent, decode_metrics_init,
                              decode_metrics_plan, decode_metrics_step,
                              extract_metrics)
from ..runtime.prefix_cache import (PrefixCache, PrefixCacheConfig,
                                    PrefixCacheStats, PrefixHit)

__all__ = [
    "BatcherStats", "ContinuousEngine", "DecodeBatch", "EngineBackend",
    "EngineStats", "METRIC_COLS", "PrefixCache", "PrefixCacheConfig",
    "PrefixCacheStats", "PrefixHit", "Request", "RequestBatcher",
    "RequestResult", "ServeConfig", "StreamEvent", "WindowedMetrics",
    "build_engine", "build_serve_step", "decode_metrics_init",
    "decode_metrics_plan", "decode_metrics_step", "extract_metrics",
    "make_backend", "poisson_trace", "run_batched_decode", "serve_trace",
]
