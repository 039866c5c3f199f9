"""Shared CLI flag groups (port of `cli/common.py`).

Checkpoint-shape model hyperparameters — the knobs that change parameter
shapes, so they must match the checkpoint being served.
"""

from __future__ import annotations

# config fields whose values change parameter shapes
MODEL_SHAPE_FIELDS = (
    "generator", "ngf", "base_channels", "n_bins", "model_type",
    "attention_levels",
)


def add_model_shape_args(p) -> None:
    """Add --generator/--ngf/... flags matching cli/train.py's spellings."""
    p.add_argument("--generator", default=None, choices=[None, "unet_256", "unet_128"])
    p.add_argument("--ngf", type=int, default=None)
    p.add_argument("--base_channels", type=int, default=None)
    p.add_argument("--n_bins", type=int, default=None)
    p.add_argument("--model_type", default=None,
                   choices=[None, "unet", "lite", "hybrid", "dual_reg"])
    p.add_argument("--attention_levels", default=None,
                   help="comma-separated encoder levels for cross-attention, "
                        "e.g. 2,3,4,5 (binaural family)")


def model_shape_overrides(args) -> dict:
    """Dotted config overrides for the flags the user actually passed."""
    out = {}
    for field in MODEL_SHAPE_FIELDS:
        val = getattr(args, field, None)
        if val is not None:
            out[f"model.{field}"] = val
    return out
