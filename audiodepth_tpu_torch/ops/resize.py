"""Bilinear resize with `jax.image.resize`'s linear + antialias semantics
(port of `ops/resize.py::resize_bilinear`).

The resize is two triangle-weight matrices, one per spatial axis, applied as
matrix products: out = Wh · x · Wwᵀ. The matrices are
`_triangle_weight_mat` of the JAX package (torchvision `Resize` semantics:
half-pixel centres, kernel support widened by in/out when downscaling,
rows renormalised to sum 1), built here in float64 and cast to the input's
dtype so the float64 mode stays float64. `resize_bilinear_np` is the
host's numpy float32 form, with the JAX package's float32 matrices.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _triangle_weight_mat(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] row-stochastic triangle resample matrix, float64."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(out_size, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[:, None] - np.arange(in_size, dtype=np.float64)[None, :])
    w = np.maximum(0.0, 1.0 - x / kernel_scale)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0.0, total, 1.0), 0.0)
    ok = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(ok[:, None], w, 0.0)


@functools.lru_cache(maxsize=32)
def _weight_tensor(in_size: int, out_size: int, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    w = torch.from_numpy(_triangle_weight_mat(in_size, out_size))
    return w.to(device=device, dtype=dtype)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Antialiased bilinear resize of the last two axes of [..., H, W]."""
    wh = _weight_tensor(x.shape[-2], out_h, x.dtype, x.device)
    ww = _weight_tensor(x.shape[-1], out_w, x.dtype, x.device)
    return torch.matmul(torch.matmul(wh, x), ww.T)


def resize_nearest_cv2_np(x: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """cv2 INTER_NEAREST resize of the last two axes of a numpy array: output
    pixel (i, j) takes source pixel (floor(i·in_h/out_h), floor(j·in_w/out_w)),
    clamped to the last row and column. The host loaders' depth resize
    (port of `ops/resize.py::resize_nearest_cv2_np`); OpenCV is not needed."""
    in_h, in_w = x.shape[-2], x.shape[-1]
    ys = np.minimum(np.floor(np.arange(out_h) * (in_h / out_h)).astype(np.int64), in_h - 1)
    xs = np.minimum(np.floor(np.arange(out_w) * (in_w / out_w)).astype(np.int64), in_w - 1)
    return x[..., ys, :][..., xs]


@functools.lru_cache(maxsize=32)
def _weight_mat_f32(in_size: int, out_size: int) -> np.ndarray:
    return _triangle_weight_mat(in_size, out_size).astype(np.float32)


def resize_bilinear_np(x: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """`resize_bilinear` on the host in numpy float32 (port of
    `ops/resize.py::resize_bilinear_np`): the sparse-depth targets, which
    the reference resizes with torchvision's antialiased bilinear Resize."""
    wh = _weight_mat_f32(x.shape[-2], out_h)
    ww = _weight_mat_f32(x.shape[-1], out_w)
    y = np.einsum("oh,...hw->...ow", wh, x.astype(np.float32))
    return np.einsum("pw,...ow->...op", ww, y)
