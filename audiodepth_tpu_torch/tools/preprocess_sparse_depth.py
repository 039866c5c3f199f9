"""Offline sparse-depth preprocessor (port of
`tools/preprocess_sparse_depth.py`, the reference's
preprocess_sparse_depth.py): turns each location's `depth/depth_*.npy`
(mm) into `sparse_depth_{method}/` targets, which `data/sparse_depth.py`
reads. One-time host data preparation in numpy and OpenCV (imported in the
functions that need it).

    python -m audiodepth_tpu_torch.tools.preprocess_sparse_depth \
        --dataset_dir /data/BatvisionV2 --method downup_015

Methods (the reference's parse_method grammar):
  downup_015           — fill holes, INTER_AREA down to 15 %, INTER_LINEAR up
  superpixel_100       — SLIC mean-pool (n_segments=100)
  sp_extreme_30[_σ]    — coarse SLIC + Gaussian blur
  sp_hier_200_50_15    — hierarchical SLIC
  quantized_32         — digitize into 32 levels + blur
  grid_32              — block mean + blur
  blur_5[_3]           — iterative inpaint + blur
SLIC is a built-in grid-seeded local k-means with the same
(n_segments, compactness) interface (scikit-image is not needed).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(f"preprocess_sparse_depth requires OpenCV (cv2): {e}") from e
    return cv2


def slic_segments(image01: np.ndarray, n_segments: int, compactness: float,
                  n_iter: int = 5) -> np.ndarray:
    """Minimal SLIC: grid-seeded local k-means in (value, x, y) space.

    image01: [H, W] float in [0, 1]. Returns int32 labels [H, W].
    """
    h, w = image01.shape
    step = max(int(np.sqrt(h * w / max(n_segments, 1))), 1)
    ys = np.arange(step // 2, h, step)
    xs = np.arange(step // 2, w, step)
    cy, cx = np.meshgrid(ys, xs, indexing="ij")
    cy, cx = cy.ravel().astype(np.float64), cx.ravel().astype(np.float64)
    cv = image01[cy.astype(int), cx.astype(int)].astype(np.float64)
    k = len(cy)

    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    labels = np.zeros((h, w), np.int32)
    dist = np.full((h, w), np.inf)
    # spatial normalization as in SLIC: m/S scaling of spatial distance
    ratio = (compactness / step) ** 2
    for _ in range(n_iter):
        dist.fill(np.inf)
        for i in range(k):
            y0, y1 = int(max(cy[i] - step, 0)), int(min(cy[i] + step + 1, h))
            x0, x1 = int(max(cx[i] - step, 0)), int(min(cx[i] + step + 1, w))
            dv = (image01[y0:y1, x0:x1] - cv[i]) ** 2
            ds = (yy[y0:y1, x0:x1] - cy[i]) ** 2 + (xx[y0:y1, x0:x1] - cx[i]) ** 2
            d = dv + ratio * ds
            sub = dist[y0:y1, x0:x1]
            m = d < sub
            sub[m] = d[m]
            labels[y0:y1, x0:x1][m] = i
        for i in range(k):
            m = labels == i
            if m.any():
                cy[i] = yy[m].mean()
                cx[i] = xx[m].mean()
                cv[i] = image01[m].mean()
    return labels


def _segment_mean(depth: np.ndarray, labels: np.ndarray) -> np.ndarray:
    flat = labels.ravel()
    sums = np.bincount(flat, weights=depth.ravel())
    counts = np.maximum(np.bincount(flat), 1)
    return (sums / counts)[labels].astype(depth.dtype)


def fill_holes_completely(depth: np.ndarray, invalid_value: float = 0.0) -> np.ndarray:
    cv2 = _cv2()
    mask = (depth > invalid_value) & ~np.isnan(depth)
    filled = depth.copy().astype(np.float32)
    if mask.all():
        return filled
    hole = (~mask).astype(np.uint8) * 255
    filled = cv2.inpaint(filled, hole, 10, cv2.INPAINT_TELEA)
    kernel = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (15, 15))
    return cv2.morphologyEx(filled, cv2.MORPH_CLOSE, kernel)


def smooth_downup(depth, scale=0.15, invalid_value=0.0):
    cv2 = _cv2()
    h, w = depth.shape
    filled = fill_holes_completely(depth, invalid_value)
    small = cv2.resize(filled, (max(1, int(w * scale)), max(1, int(h * scale))),
                       interpolation=cv2.INTER_AREA)
    return cv2.resize(small, (w, h), interpolation=cv2.INTER_LINEAR)


def _norm01(x):
    return (x - x.min()) / (x.max() - x.min() + 1e-8)


def smooth_superpixel(depth, n_segments=100, invalid_value=0.0):
    filled = fill_holes_completely(depth, invalid_value)
    labels = slic_segments(_norm01(filled), n_segments, compactness=10 / 255.0)
    return _segment_mean(filled, labels)


def smooth_sp_extreme(depth, n_segments=30, blur_sigma=3.0, invalid_value=0.0):
    cv2 = _cv2()
    filled = fill_holes_completely(depth, invalid_value)
    labels = slic_segments(_norm01(filled), n_segments, compactness=30 / 255.0)
    out = _segment_mean(filled, labels)
    if blur_sigma > 0:
        k = int(blur_sigma * 4) | 1
        out = cv2.GaussianBlur(out.astype(np.float32), (k, k), blur_sigma)
    return out


def smooth_sp_hierarchical(depth, levels=(200, 50, 15), invalid_value=0.0):
    out = fill_holes_completely(depth, invalid_value)
    for n_seg in levels:
        labels = slic_segments(_norm01(out), n_seg, compactness=20 / 255.0)
        out = _segment_mean(out, labels)
    return out


def smooth_quantized(depth, n_levels=32, invalid_value=0.0):
    cv2 = _cv2()
    filled = fill_holes_completely(depth, invalid_value)
    valid = filled > invalid_value
    if not valid.any():
        return filled
    lo, hi = filled[valid].min(), filled[valid].max()
    bins = np.linspace(lo, hi, n_levels + 1)
    centers = 0.5 * (bins[:-1] + bins[1:])
    idx = np.clip(np.digitize(filled, bins) - 1, 0, n_levels - 1)
    return cv2.GaussianBlur(centers[idx].astype(np.float32), (5, 5), 1.5)


def smooth_planar_grid(depth, grid_size=32, invalid_value=0.0):
    cv2 = _cv2()
    h, w = depth.shape
    filled = fill_holes_completely(depth, invalid_value)
    out = np.zeros_like(filled)
    for i in range(0, h, grid_size):
        for j in range(0, w, grid_size):
            block = filled[i : i + grid_size, j : j + grid_size]
            out[i : i + grid_size, j : j + grid_size] = block.mean()
    return cv2.GaussianBlur(out.astype(np.float32), (15, 15), 3.0)


def smooth_iterative_blur(depth, iterations=3, blur_sigma=5.0, invalid_value=0.0):
    cv2 = _cv2()
    out = depth.copy().astype(np.float32)
    for _ in range(iterations):
        hole = (out <= invalid_value) | np.isnan(out)
        if hole.any():
            out = cv2.inpaint(out, hole.astype(np.uint8) * 255, 5, cv2.INPAINT_TELEA)
        k = int(blur_sigma * 4) | 1
        out = cv2.GaussianBlur(out, (k, k), blur_sigma)
    return out


def parse_method(method_str: str):
    parts = method_str.split("_")
    if parts[0] == "downup":
        return lambda d: smooth_downup(d, scale=int(parts[1]) / 100.0)
    if parts[0] == "superpixel":
        return lambda d: smooth_superpixel(d, n_segments=int(parts[1]))
    if parts[0] == "quantized":
        return lambda d: smooth_quantized(d, n_levels=int(parts[1]))
    if parts[:2] == ["sp", "extreme"]:
        n = int(parts[2])
        sigma = float(parts[3]) if len(parts) > 3 else 3.0
        return lambda d: smooth_sp_extreme(d, n_segments=n, blur_sigma=sigma)
    if parts[:2] == ["sp", "hier"]:
        levels = [int(x) for x in parts[2:]]
        return lambda d: smooth_sp_hierarchical(d, levels=levels)
    if parts[0] == "grid":
        return lambda d: smooth_planar_grid(d, grid_size=int(parts[1]))
    if parts[0] == "blur":
        sigma = float(parts[1])
        iters = int(parts[2]) if len(parts) > 2 else 3
        return lambda d: smooth_iterative_blur(d, iterations=iters, blur_sigma=sigma)
    raise ValueError(f"Unknown method: {method_str}")


def process_sequence(sequence_path: Path, method_str: str, smooth_func) -> int:
    depth_dir = sequence_path / "depth"
    out_dir = sequence_path / f"sparse_depth_{method_str}"
    if not depth_dir.exists():
        print(f"  Warning: {depth_dir} not found")
        return 0
    out_dir.mkdir(exist_ok=True)
    n = 0
    for f in sorted(depth_dir.glob("depth_*.npy")):
        depth = np.nan_to_num(np.load(f).astype(np.float32),
                              nan=0.0, posinf=0.0, neginf=0.0)
        np.save(out_dir / f.name, smooth_func(depth).astype(np.float32))
        n += 1
    return n


def main(argv=None):
    p = argparse.ArgumentParser(description="Generate sparse/coarse depth targets")
    p.add_argument("--dataset_dir", required=True)
    p.add_argument("--method", default="downup_015")
    p.add_argument("--sequences", nargs="*", default=None)
    args = p.parse_args(argv)

    root = Path(args.dataset_dir)
    fn = parse_method(args.method)
    seqs = args.sequences or [
        d.name for d in sorted(root.iterdir())
        if d.is_dir() and not d.name.startswith((".", "__"))
        and not d.name.endswith("_unzipped")
    ]
    total = 0
    for s in seqs:
        n = process_sequence(root / s, args.method, fn)
        print(f"{s}: {n} files")
        total += n
    print(f"done: {total} depth maps → sparse_depth_{args.method}")


if __name__ == "__main__":
    main()
