"""Weights carried across: the JAX package's variables → the port's
state_dict, and reference `.pth` checkpoints → the port.

The `*_state_dict_from_jax` functions run the JAX package's mapping specs
(tools/import_torch.py `_spec_unet`, `_spec_binaural`, `_spec_base_residual`,
`_spec_unet_cvae`, `_spec_rgb_depth` and `_spec_adabins`, in their
flax→torch direction `_ExportBuilder`) on plain numpy arrays:

    nn.Conv kernel            [kh,kw,I,O] -> Conv2d          [O,I,kh,kw]
    nn.ConvTranspose(SAME)    [kh,kw,I,O] -> ConvTranspose2d [I,O,kh,kw],
                                             spatially flipped
    nn.Dense kernel           [I,O]       -> 1x1 Conv2d      [O,I,1,1]
                                             (attention projections) or
                                             Linear          [O,I]
    BatchNorm scale/bias + mean/var       -> weight/bias + running_mean/var
    attention gamma           [1]         -> gamma [1], as it is

The cVAE's three BatchNorms that the reference registers and never runs
have no JAX leaves; they are written at their init values (float32), as
the JAX exporter writes them.

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

    def dense1x1(self, fpath: str, tprefix: str):
        w = self._take("params", f"{fpath}/kernel")                 # [I,O]
        self._emit(f"{tprefix}.weight", w.T[:, :, None, None])
        self._emit(f"{tprefix}.bias", self._take("params", f"{fpath}/bias"))

    def dense(self, fpath: str, tprefix: str):
        self._emit(f"{tprefix}.weight", self._take("params", f"{fpath}/kernel").T)
        self._emit(f"{tprefix}.bias", self._take("params", f"{fpath}/bias"))

    def dead_bn(self, tprefix: str, ch: int):
        for name, fill in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0),
                           ("running_var", 1.0)):
            self._emit(f"{tprefix}.{name}", np.full(ch, fill, np.float32))
        self.out[f"{tprefix}.num_batches_tracked"] = np.zeros((), np.int64)

    def raw(self, fpath: str, tkey: str):
        self._emit(tkey, self._take("params", fpath))

    # the reference's DoubleConv / Down / Up blocks
    def double_conv(self, fpath: str, tprefix: str):
        self.conv(f"{fpath}/Conv_0", f"{tprefix}.double_conv.0", bias=False)
        self.bn(f"{fpath}/BatchNorm_0/BatchNorm_0", f"{tprefix}.double_conv.1")
        self.conv(f"{fpath}/Conv_1", f"{tprefix}.double_conv.3", bias=False)
        self.bn(f"{fpath}/BatchNorm_1/BatchNorm_0", f"{tprefix}.double_conv.4")

    def encoder(self, fpath: str, tprefix: str = ""):
        p = f"{tprefix}." if tprefix else ""
        self.double_conv(f"{fpath}/DoubleConv_0", f"{p}inc")
        for i in range(4):
            self.double_conv(f"{fpath}/Down_{i}/DoubleConv_0", f"{p}down{i + 1}.maxpool_conv.1")

    def up(self, fpath: str, tprefix: str):
        self.double_conv(f"{fpath}/DoubleConv_0", f"{tprefix}.conv")

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


def binaural_state_dict_from_jax(params: Mapping, batch_stats: Mapping,
                                 attention_levels: Sequence[int] = (2, 3, 4, 5)
                                 ) -> Dict[str, torch.Tensor]:
    """The port's BinauralAttentionNet state_dict from the JAX model's
    variables (`_spec_binaural`)."""
    b = _Exporter(params, batch_stats)
    b.encoder("left_encoder", "left_encoder")
    b.encoder("right_encoder", "right_encoder")
    for lvl in attention_levels:
        tp = f"attention_modules.attn_{lvl}"
        for i, proj in enumerate(("query", "key", "value", "out")):
            b.dense1x1(f"attn_{lvl}/Dense_{i}", f"{tp}.{proj}")
        b.raw(f"attn_{lvl}/gamma", f"{tp}.gamma")
    for lvl in range(1, 6):
        b.conv(f"fusion_{lvl}", f"fusion_layers.fusion_{lvl}.0", bias=True)
        b.bn(f"fusion_bn_{lvl}/BatchNorm_0", f"fusion_layers.fusion_{lvl}.1")
    for i in range(4):
        b.up(f"UpBilinear_{i}", f"up{i + 1}")
    b.conv("Conv_0", "outc.0", bias=True)
    return b.finish()


def unet_cvae_state_dict_from_jax(params: Mapping, batch_stats: Mapping, num_downs: int = 8,
                                  ngf: int = 64, output_nc: int = 1
                                  ) -> Dict[str, torch.Tensor]:
    """The port's UNetCVAE state_dict from the JAX cVAE's variables
    (`_spec_unet_cvae`), the dead BatchNorms included."""
    b = _Exporter(params, batch_stats)
    n = num_downs
    Q = ["model"]
    for _ in range(1, n):
        Q.append(Q[-1] + ".submodule")
    b.conv("ConvDown_0/Conv_0", f"{Q[0]}.downconv", bias=False)
    for d in range(1, n - 1):
        b.conv(f"ConvDown_{d}/Conv_0", f"{Q[d]}.downconv", bias=False)
        b.bn(f"BatchNorm_{d - 1}/BatchNorm_0", f"{Q[d]}.downnorm")
    b.conv(f"ConvDown_{n - 1}/Conv_0", f"{Q[n - 1]}.downconv", bias=False)
    b.dead_bn(f"{Q[0]}.downnorm", ngf)
    b.dead_bn(f"{Q[0]}.upnorm", output_nc)
    b.dead_bn(f"{Q[n - 1]}.downnorm", ngf * 8)
    for name in ("fc_mu", "fc_logvar", "fc_dec"):
        b.dense(f"VAEBottleneck_0/{name}", f"{Q[n - 1]}.vae.{name}")
    b.convT("ConvUp_0/ConvTranspose_0", f"{Q[n - 1]}.upconv", bias=False)
    b.bn(f"BatchNorm_{n - 2}/BatchNorm_0", f"{Q[n - 1]}.upnorm")
    for j, d in enumerate(range(n - 2, 0, -1), start=1):
        b.convT(f"ConvUp_{j}/ConvTranspose_0", f"{Q[d]}.upconv", bias=False)
        b.bn(f"BatchNorm_{n - 2 + j}/BatchNorm_0", f"{Q[d]}.upnorm")
    b.convT(f"ConvUp_{n - 1}/ConvTranspose_0", f"{Q[0]}.upconv", bias=True)
    return b.finish()


def base_residual_state_dict_from_jax(params: Mapping, batch_stats: Mapping
                                      ) -> Dict[str, torch.Tensor]:
    """The port's BaseResidualNet state_dict (`_spec_base_residual`)."""
    b = _Exporter(params, batch_stats)
    b.encoder("SharedEncoder_0")
    for i in range(4):
        b.up(f"UpBilinear_{i}", f"base_up{i + 1}")
    b.conv("Conv_0", "base_head", bias=True)
    for i in range(4):
        b.up(f"UpBilinear_{i + 4}", f"res_up{i + 1}")
    b.conv("Conv_1", "res_head", bias=True)
    return b.finish()


def rgb_depth_state_dict_from_jax(params: Mapping, batch_stats: Mapping
                                  ) -> Dict[str, torch.Tensor]:
    """The port's RGBDepthNet state_dict (`_spec_rgb_depth`)."""
    b = _Exporter(params, batch_stats)
    b.encoder("SharedEncoder_0")
    for i in range(4):
        b.up(f"UpBilinear_{i}", f"up{i + 1}")
    b.conv("Conv_0", "outc", bias=True)
    return b.finish()


def adabins_state_dict_from_jax(params: Mapping, batch_stats: Mapping
                                ) -> Dict[str, torch.Tensor]:
    """The port's AdaBinsDistillationModel state_dict, both branches and the
    shared residual head (`_spec_adabins`)."""
    b = _Exporter(params, batch_stats)
    for branch in ("audio", "rgb"):
        b.encoder(f"{branch}/AdaBinsEncoder_0", f"{branch}_encoder")
        b.dense(f"{branch}/BinPredictor_0/Dense_0", f"{branch}_bin_predictor.predictor.0")
        b.dense(f"{branch}/BinPredictor_0/Dense_1", f"{branch}_bin_predictor.predictor.3")
        for i in range(4):
            b.up(f"{branch}/AdaBinsDecoder_0/UpBilinear_{i}", f"{branch}_decoder.up{i + 1}")
        b.conv(f"{branch}/AdaBinsDecoder_0/Conv_0", f"{branch}_decoder.class_head", bias=True)
    b.conv("residual_head", "residual_head", bias=True)
    return b.finish()


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Load a reference ``.pth`` checkpoint into {key: tensor} on the CPU.

    Accepts a bare state_dict or the reference's ``{"state_dict": ...}`` /
    ``{"model_state_dict": ...}`` wrappers; strips DataParallel ``module.``
    prefixes. Loads with ``weights_only=True``: tensors and plain containers
    only, no arbitrary pickled objects.
    """
    return torch_state_dict(torch.load(path, map_location="cpu", weights_only=True))


def torch_state_dict(obj) -> Dict[str, torch.Tensor]:
    """The {key: tensor} of a loaded reference checkpoint (see
    `load_torch_state_dict`)."""
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
