"""Depth metrics of the port."""

from .errors import EVAL_PRED_MIN, METRIC_NAMES, compute_errors_batch, compute_errors_np

__all__ = ["EVAL_PRED_MIN", "METRIC_NAMES", "compute_errors_batch", "compute_errors_np"]
