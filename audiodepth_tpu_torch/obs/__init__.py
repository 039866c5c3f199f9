"""Observability of the port: the metric sink, timers, the profiler hook
and the matplotlib visualizations (matplotlib is imported only inside the
functions that draw)."""

from .logging import MetricLogger, ProfilerHook, Timer
from .visualize import (save_batch_visualization, save_decomposition, save_depth_comparison,
                        save_distillation_panel)

__all__ = ["MetricLogger", "ProfilerHook", "Timer", "save_batch_visualization",
           "save_decomposition", "save_depth_comparison", "save_distillation_panel"]
