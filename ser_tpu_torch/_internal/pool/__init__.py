"""Temporal pooling: deterministic windowing + statistics pooling."""

from ser_tpu_torch._internal.pool.stats_pool import mean_std_pool
from ser_tpu_torch._internal.pool.windowing import temporal_pooling_windows

__all__ = ["mean_std_pool", "temporal_pooling_windows"]
