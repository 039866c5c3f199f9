"""Observability of the port: the metric sink, timers and the matplotlib
visualizations (matplotlib is imported only inside the functions that
draw)."""

from .logging import MetricLogger, Timer
from .visualize import save_batch_visualization, save_depth_comparison

__all__ = ["MetricLogger", "Timer", "save_batch_visualization", "save_depth_comparison"]
