"""Deterministic resumable pipeline, monoid stream statistics and windowed
streaming analytics."""
from .pipeline import DataConfig, Prefetcher, SyntheticCorpus, packed_stats
from .stats import (init_stats, make_stream_stats, state_from_numpy,
                    summarize, sync_stats, update_stats)
from .windows import (SlidingWindow, TumblingWindow, WindowedMetrics,
                      WindowResult, session_fold, sessionize, tumbling_fold,
                      tumbling_ids)

__all__ = ["DataConfig", "Prefetcher", "SlidingWindow", "SyntheticCorpus",
           "TumblingWindow", "WindowResult", "WindowedMetrics", "init_stats",
           "make_stream_stats", "packed_stats", "session_fold", "sessionize",
           "state_from_numpy", "summarize", "sync_stats", "tumbling_fold",
           "tumbling_ids", "update_stats"]
