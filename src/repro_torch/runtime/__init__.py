"""Runtime of the port: the request batcher and the engine (serving), and
the fault-tolerance control plane (training)."""
from .batcher import BatcherStats, DecodeBatch, Request, RequestBatcher
from .engine import (ContinuousEngine, EngineBackend, EngineStats,
                     METRIC_COLS, RequestResult, ServeConfig, StreamEvent,
                     decode_metrics_init, decode_metrics_plan,
                     decode_metrics_step, extract_metrics)
from .fault_tolerance import (ElasticController, MeshPlan, PreemptionHandler,
                              StragglerMonitor, StragglerReport,
                              checkpoint_interval, plan_remesh)

__all__ = [
    "BatcherStats", "ContinuousEngine", "DecodeBatch", "ElasticController",
    "EngineBackend", "EngineStats", "METRIC_COLS", "MeshPlan",
    "PreemptionHandler", "Request", "RequestBatcher", "RequestResult",
    "ServeConfig", "StragglerMonitor", "StragglerReport", "StreamEvent",
    "checkpoint_interval", "decode_metrics_init", "decode_metrics_plan",
    "decode_metrics_step", "extract_metrics", "plan_remesh",
]
