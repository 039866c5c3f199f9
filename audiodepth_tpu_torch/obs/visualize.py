"""Host-side matplotlib visualizations of depth predictions (port of
`obs/visualize.py`: the 3-panel comparison, the 5-row batch grid, the
AdaBins distillation panel and the per-family decomposition row).

They draw fetched numpy arrays in meters, never tensors on the device.
matplotlib is imported inside each function, so the port imports without
it; `pyplot()` raises ImportError where it is absent, which the train CLI
checks before training.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np


def pyplot():
    """matplotlib.pyplot on the non-interactive Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _chw(x: np.ndarray) -> np.ndarray:
    """Accept [H,W], [H,W,1] or [1,H,W]; return [H,W]."""
    x = np.asarray(x)
    if x.ndim == 3:
        x = x[..., 0] if x.shape[-1] == 1 else x[0]
    return x


def save_depth_comparison(gt, pred, path: str, max_depth: float = 30.0,
                          title: str = "") -> str:
    plt = pyplot()
    gt, pred = _chw(gt), _chw(pred)
    err = np.abs(gt - pred)
    fig, axes = plt.subplots(1, 3, figsize=(15, 5))
    for ax, img, name, cmap in (
        (axes[0], gt, "Ground Truth", "viridis"),
        (axes[1], pred, "Prediction", "viridis"),
        (axes[2], err, "Abs Error", "hot"),
    ):
        im = ax.imshow(img, cmap=cmap, vmin=0,
                       vmax=max_depth if name != "Abs Error" else None)
        ax.set_title(name)
        ax.axis("off")
        fig.colorbar(im, ax=ax, fraction=0.046)
    if title:
        fig.suptitle(title)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return path


def save_batch_visualization(gts: np.ndarray, preds: np.ndarray, path: str,
                             max_depth: float = 30.0, max_cols: int = 4) -> str:
    """5-row grid: GT / pred / percentile-clipped error / GT hist / pred hist."""
    plt = pyplot()
    n = min(len(gts), max_cols)
    fig, axes = plt.subplots(5, n, figsize=(4 * n, 16), squeeze=False)
    for j in range(n):
        gt, pred = _chw(gts[j]), _chw(preds[j])
        err = np.abs(gt - pred)
        clip = np.percentile(err, 95) if err.size else 1.0
        axes[0][j].imshow(gt, cmap="viridis", vmin=0, vmax=max_depth)
        axes[0][j].set_title(f"GT #{j}")
        axes[1][j].imshow(pred, cmap="viridis", vmin=0, vmax=max_depth)
        axes[1][j].set_title("Pred")
        axes[2][j].imshow(np.clip(err, 0, clip), cmap="hot")
        axes[2][j].set_title(f"Err (p95={clip:.2f})")
        for row, (img, name) in ((3, (gt, "GT hist")), (4, (pred, "Pred hist"))):
            vals = img[img > 0].ravel() if (img > 0).any() else img.ravel()
            axes[row][j].hist(vals, bins=50, color="steelblue")
            if vals.size:
                axes[row][j].axvline(vals.mean(), color="red", linestyle="--",
                                     label=f"mean {vals.mean():.2f}")
                axes[row][j].legend(fontsize=7)
            axes[row][j].set_title(name)
        for row in range(3):
            axes[row][j].axis("off")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=90, bbox_inches="tight")
    plt.close(fig)
    return path


def save_distillation_panel(gt: np.ndarray, student_pred: np.ndarray,
                            teacher_pred: Optional[np.ndarray], student_centers: np.ndarray,
                            teacher_centers: Optional[np.ndarray], path: str,
                            max_depth: float = 30.0) -> str:
    """8-panel distillation view (train_adabins_distillation.py:41-132 twin):
    GT / student / teacher / |err| maps + bin-center bar charts + depth
    histograms for student vs teacher."""
    plt = pyplot()
    fig, axes = plt.subplots(2, 4, figsize=(20, 9))
    g, s = _chw(gt), _chw(student_pred)
    t = _chw(teacher_pred) if teacher_pred is not None else None
    panels = [(g, "GT", "viridis"), (s, "Student", "viridis")]
    panels.append((t if t is not None else np.zeros_like(g), "Teacher", "viridis"))
    panels.append((np.abs(g - s), "|GT − Student|", "hot"))
    for ax, (img, name, cmap) in zip(axes[0], panels):
        im = ax.imshow(img, cmap=cmap, vmin=0,
                       vmax=max_depth if cmap == "viridis" else None)
        ax.set_title(name)
        ax.axis("off")
        fig.colorbar(im, ax=ax, fraction=0.046)

    axes[1][0].bar(np.arange(len(student_centers)), student_centers, color="steelblue")
    axes[1][0].set_title("Student bin centers")
    if teacher_centers is not None:
        axes[1][1].bar(np.arange(len(teacher_centers)), teacher_centers, color="indianred")
    axes[1][1].set_title("Teacher bin centers")
    for ax, (img, name) in zip((axes[1][2], axes[1][3]),
                               ((s, "Student depth hist"), (g, "GT depth hist"))):
        vals = img[img > 0].ravel() if (img > 0).any() else img.ravel()
        ax.hist(vals, bins=50, color="gray")
        ax.set_title(name)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=90, bbox_inches="tight")
    plt.close(fig)
    return path


def save_decomposition(panels: Dict[str, np.ndarray], path: str, max_depth: float = 30.0,
                       signed_keys: Sequence[str] = ("residual", "offset")) -> str:
    """Row of named panels (base/residual/final/GT or coarse/offset/...)."""
    plt = pyplot()
    names = list(panels)
    fig, axes = plt.subplots(1, len(names), figsize=(4 * len(names), 4), squeeze=False)
    for ax, name in zip(axes[0], names):
        img = _chw(panels[name])
        if name in signed_keys:
            bound = max(abs(float(img.min())), abs(float(img.max())), 1e-6)
            im = ax.imshow(img, cmap="coolwarm", vmin=-bound, vmax=bound)
        else:
            im = ax.imshow(img, cmap="viridis", vmin=0, vmax=max_depth)
        ax.set_title(name)
        ax.axis("off")
        fig.colorbar(im, ax=ax, fraction=0.046)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return path
