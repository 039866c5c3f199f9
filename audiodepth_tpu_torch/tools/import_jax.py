"""Weights carried across: the JAX package's variables → the port's
state_dict, and reference `.pth` checkpoints → the port.

`unet_state_dict_from_jax` runs the JAX package's UNet mapping spec
(tools/import_torch.py `_spec_unet`, in its flax→torch direction
`_ExportBuilder`) on plain numpy arrays:

    nn.Conv kernel            [kh,kw,I,O] -> Conv2d          [O,I,kh,kw]
    nn.ConvTranspose(SAME)    [kh,kw,I,O] -> ConvTranspose2d [I,O,kh,kw],
                                             spatially flipped
    BatchNorm scale/bias + mean/var       -> weight/bias + running_mean/var

Arrays keep their dtype, so float64 variables give a float64 state_dict.
Every leaf must be consumed and every key produced once; drift raises.
The port's native format is the reference's, so `load_torch_state_dict`
reads a reference checkpoint as it is.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested or '/'-flattened dict → {'a/b/c': array}."""
    out: Dict[str, np.ndarray] = {}
    for k, v in (tree or {}).items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _unet_block_prefixes(num_downs: int) -> Sequence[str]:
    """Torch Sequential prefixes for blocks outermost(0) → innermost(n-1)."""
    prefixes = ["model.model"]
    for d in range(1, num_downs):
        sub_idx = 1 if d == 1 else 3
        prefixes.append(f"{prefixes[-1]}.{sub_idx}.model")
    return prefixes


class _Exporter:
    def __init__(self, params: Mapping, batch_stats: Mapping):
        self.trees = {"params": _flatten(params), "batch_stats": _flatten(batch_stats)}
        self.used: set = set()
        self.out: Dict[str, np.ndarray] = {}

    def _take(self, col: str, fpath: str) -> np.ndarray:
        if fpath not in self.trees[col]:
            raise KeyError(f"JAX {col} are missing expected leaf {fpath!r}")
        self.used.add((col, fpath))
        return self.trees[col][fpath]

    def _emit(self, tkey: str, arr: np.ndarray):
        if tkey in self.out:
            raise ValueError(f"duplicate torch key {tkey}")
        self.out[tkey] = np.array(arr, order="C")  # a writable copy

    def conv(self, fpath: str, tprefix: str, bias: bool = True):
        w = self._take("params", f"{fpath}/kernel")                 # [kh,kw,I,O]
        self._emit(f"{tprefix}.weight", np.transpose(w, (3, 2, 0, 1)))
        if bias:
            self._emit(f"{tprefix}.bias", self._take("params", f"{fpath}/bias"))

    def convT(self, fpath: str, tprefix: str, bias: bool = True):
        w = self._take("params", f"{fpath}/kernel")                 # flipped [kh,kw,I,O]
        self._emit(f"{tprefix}.weight", np.transpose(w, (2, 3, 0, 1))[:, :, ::-1, ::-1])
        if bias:
            self._emit(f"{tprefix}.bias", self._take("params", f"{fpath}/bias"))

    def bn(self, fpath: str, tprefix: str):
        self._emit(f"{tprefix}.weight", self._take("params", f"{fpath}/scale"))
        self._emit(f"{tprefix}.bias", self._take("params", f"{fpath}/bias"))
        self._emit(f"{tprefix}.running_mean", self._take("batch_stats", f"{fpath}/mean"))
        self._emit(f"{tprefix}.running_var", self._take("batch_stats", f"{fpath}/var"))
        self.out[f"{tprefix}.num_batches_tracked"] = np.zeros((), np.int64)

    def finish(self) -> Dict[str, torch.Tensor]:
        leftover = sorted({(col, k) for col, tree in self.trees.items() for k in tree}
                          - self.used)
        if leftover:
            raise ValueError(f"{len(leftover)} JAX leaves were not consumed by the "
                             f"mapping (architecture drift?): {leftover[:8]}...")
        return {k: torch.from_numpy(v) for k, v in self.out.items()}


def unet_state_dict_from_jax(params: Mapping, batch_stats: Mapping,
                             num_downs: int = 8) -> Dict[str, torch.Tensor]:
    """The port's UNetGenerator state_dict from the JAX UNet's variables."""
    b = _Exporter(params, batch_stats)
    P = _unet_block_prefixes(num_downs)
    n = num_downs
    # encoder
    b.conv("ConvDown_0/Conv_0", f"{P[0]}.0", bias=False)
    for d in range(1, n - 1):
        b.conv(f"ConvDown_{d}/Conv_0", f"{P[d]}.1", bias=False)
        b.bn(f"BatchNorm_{d - 1}/BatchNorm_0", f"{P[d]}.2")
    b.conv(f"ConvDown_{n - 1}/Conv_0", f"{P[n - 1]}.1", bias=False)
    # decoder: innermost up, middles, outermost head
    b.convT("ConvUp_0/ConvTranspose_0", f"{P[n - 1]}.3", bias=False)
    b.bn(f"BatchNorm_{n - 2}/BatchNorm_0", f"{P[n - 1]}.4")
    for j, d in enumerate(range(n - 2, 0, -1), start=1):
        b.convT(f"ConvUp_{j}/ConvTranspose_0", f"{P[d]}.5", bias=False)
        b.bn(f"BatchNorm_{n - 2 + j}/BatchNorm_0", f"{P[d]}.6")
    b.convT(f"ConvUp_{n - 1}/ConvTranspose_0", f"{P[0]}.3", bias=True)
    return b.finish()


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Load a reference ``.pth`` checkpoint into {key: tensor} on the CPU.

    Accepts a bare state_dict or the reference's ``{"state_dict": ...}`` /
    ``{"model_state_dict": ...}`` wrappers; strips DataParallel ``module.``
    prefixes. Loads with ``weights_only=True``: tensors and plain containers
    only, no arbitrary pickled objects.
    """
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict):
        for key in ("state_dict", "model_state_dict"):
            if key in obj and isinstance(obj[key], dict):
                obj = obj[key]
                break
    sd = {}
    for k, v in obj.items():
        if k.startswith("module."):
            k = k[len("module."):]
        sd[k] = torch.as_tensor(v)
    return sd
