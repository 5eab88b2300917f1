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
"""
from ..launch.serve import build_engine, make_backend, poisson_trace, serve_trace
from ..runtime.batcher import BatcherStats, DecodeBatch, Request, RequestBatcher
from ..runtime.engine import (ContinuousEngine, EngineBackend, EngineStats,
                              METRIC_COLS, RequestResult, ServeConfig,
                              StreamEvent, decode_metrics_init,
                              decode_metrics_plan, decode_metrics_step,
                              extract_metrics)

__all__ = [
    "BatcherStats", "ContinuousEngine", "DecodeBatch", "EngineBackend",
    "EngineStats", "METRIC_COLS", "Request", "RequestBatcher",
    "RequestResult", "ServeConfig", "StreamEvent", "build_engine",
    "decode_metrics_init", "decode_metrics_plan", "decode_metrics_step",
    "extract_metrics", "make_backend", "poisson_trace", "serve_trace",
]
