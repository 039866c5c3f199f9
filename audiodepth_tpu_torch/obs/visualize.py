"""Host-side matplotlib visualizations of depth predictions (port of
`obs/visualize.py`: the 3-panel comparison and the 5-row batch grid).

They draw fetched numpy arrays in meters, never tensors on the device.
matplotlib is imported inside each function, so the port imports without
it; `pyplot()` raises ImportError where it is absent, which the train CLI
checks before training. The distillation and decomposition panels come with
their families (ROADMAP.md A5).
"""

from __future__ import annotations

import os

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
