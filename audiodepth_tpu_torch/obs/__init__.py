"""Observability of the port: the metric sink, the profiler hook, the spans
inside the steps (`spans`, on the profiler's clock) and the matplotlib
visualizations (matplotlib is imported only inside the functions that
draw)."""

from . import spans
from .logging import MetricLogger, ProfilerHook
from .spans import summary
from .visualize import (save_batch_visualization, save_decomposition, save_depth_comparison,
                        save_distillation_panel)

__all__ = ["MetricLogger", "ProfilerHook", "save_batch_visualization", "save_decomposition",
           "save_depth_comparison", "save_distillation_panel", "spans", "summary"]
