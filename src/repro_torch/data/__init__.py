"""Deterministic resumable pipeline + monoid stream statistics."""
from .pipeline import DataConfig, Prefetcher, SyntheticCorpus, packed_stats
from .stats import (init_stats, make_stream_stats, state_from_numpy,
                    summarize, sync_stats, update_stats)

__all__ = ["DataConfig", "Prefetcher", "SyntheticCorpus", "init_stats",
           "make_stream_stats", "packed_stats", "state_from_numpy",
           "summarize", "sync_stats", "update_stats"]
