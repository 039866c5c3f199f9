"""Losses of the port (the basic criteria and the binaural family's)."""

from .basic import combined_loss, l1_loss, l2_loss, make_criterion, silog_loss

__all__ = ["l1_loss", "l2_loss", "silog_loss", "combined_loss", "make_criterion"]
