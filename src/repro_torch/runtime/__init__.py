"""Serving runtime of the port: the request batcher and the engine."""
from .batcher import BatcherStats, DecodeBatch, Request, RequestBatcher
from .engine import (ContinuousEngine, EngineBackend, EngineStats,
                     METRIC_COLS, RequestResult, ServeConfig, StreamEvent,
                     decode_metrics_init, decode_metrics_plan,
                     decode_metrics_step, extract_metrics)

__all__ = [
    "BatcherStats", "ContinuousEngine", "DecodeBatch", "EngineBackend",
    "EngineStats", "METRIC_COLS", "Request", "RequestBatcher",
    "RequestResult", "ServeConfig", "StreamEvent", "decode_metrics_init",
    "decode_metrics_plan", "decode_metrics_step", "extract_metrics",
]
