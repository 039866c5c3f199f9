"""The train-mode BatchNorm kernel pair (`ops/cuda/batch_norm.py`,
`csrc/batch_norm.cu`) and its place in `models/layers.py::BatchNorm`.

On the CPU (torch only, a few seconds):
  * the wrappers' plain versions against `BatchNorm`'s own code (which
    every CPU input takes): forward, mean and invstd,
    backward and the folded running buffers, bit for bit, in bf16 and
    fp32, at uneven C and a one-pixel spatial size; num_batches_tracked
    stays 0, as the module leaves it;
  * the op under `remat`: one fold, the recompute saves what the forward
    saved, the same gradients;
  * the ReLU epilogue against BatchNorm followed by `nn.ReLU`;
  * reference-format state_dicts (a reference DoubleConv, and the
    benchmark's plain reference of the binaural net under its published
    names) loading strict=True with identical keys;
  * the dispatch predicate, and each case that keeps the module's code;
  * `bn_plan` over the main path's shapes.
Marked `card` (skipped without one; on the card: `python3 -m pytest -m card
tests/test_torch_batch_norm.py`): the kernels against float64 and the
plain version at the main path's shapes, and two runs bit-equal.
"""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
import torch.nn as nn

from audiodepth_tpu_torch.models import layers
from audiodepth_tpu_torch.models.binaural_attention import BinauralAttentionNet
from audiodepth_tpu_torch.models.layers import BatchNorm, DoubleConv, remat
from audiodepth_tpu_torch.ops.cuda import KERNELS
from audiodepth_tpu_torch.ops.cuda import batch_norm as bn
from audiodepth_tpu_torch.parallel.mesh import use_group

ROOT = Path(__file__).resolve().parents[1]
EPS, MOMENTUM = 1e-5, 0.1

# every BatchNorm input of the benchmark's two train cells, [N, C, H, W]
UNET_SHAPES = [(256, 64, 128, 128), (256, 128, 64, 64), (256, 256, 32, 32),
               (256, 512, 16, 16), (256, 512, 8, 8), (256, 512, 4, 4), (256, 512, 2, 2)]
BINAURAL_SHAPES = [(64, 64, 256, 256), (64, 128, 128, 128), (64, 256, 64, 64),
                   (64, 512, 32, 32), (64, 512, 16, 16), (64, 256, 32, 32),
                   (64, 128, 64, 64), (64, 64, 128, 128)]
H100_SMS = 132


def _channels_last(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous(memory_format=torch.channels_last)


def _inputs(shape, dtype, seed=0, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    c = shape[1]

    def draw(*size):
        return torch.randn(size, generator=g, device=device)

    x = _channels_last((draw(*shape) * 1.7 + 0.6).to(dtype))
    dy = _channels_last(draw(*shape).to(dtype))
    w, b = draw(c) * 0.5 + 1.0, draw(c) * 0.2
    rm, rv = draw(c), draw(c).abs() + 0.5
    return x, dy, w, b, rm, rv


def _module(c, dtype, w, b, rm, rv, relu=False):
    m = BatchNorm(c, dtype, relu=relu)
    with torch.no_grad():
        m.weight.copy_(w)
        m.bias.copy_(b)
        m.running_mean.copy_(rm)
        m.running_var.copy_(rv)
    return m.train()


# ---- the plain versions against BatchNorm's own code ---------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(3, 12, 5, 4), (4, 7, 1, 1), (2, 24, 3, 5)])
@pytest.mark.parametrize("relu", [False, True])
def test_plain_matches_the_module_code(dtype, shape, relu):
    x, dy, w, b, rm, rv = _inputs(shape, dtype)
    m = _module(shape[1], dtype, w, b, rm, rv, relu)
    xm = x.clone().requires_grad_()
    y = m(xm)
    y.backward(dy)

    rm2, rv2 = rm.clone(), rv.clone()
    y2, mean, invstd = bn.batch_norm_train_fwd(x, w, b, rm2, rv2, MOMENTUM, EPS, relu, True)
    dx, dw, db = bn.batch_norm_train_bwd(dy, x, w, b, mean, invstd, EPS, relu)
    assert y2.dtype == dtype and dx.dtype == dtype and dw.dtype == torch.float32
    assert torch.equal(y2, y)
    assert torch.equal(rm2, m.running_mean) and torch.equal(rv2, m.running_var)
    assert torch.equal(dx, xm.grad)
    assert torch.equal(dw, m.weight.grad) and torch.equal(db, m.bias.grad)
    var, mu = torch.var_mean(x.float(), dim=(0, 2, 3), correction=0)
    torch.testing.assert_close(mean, mu, rtol=0, atol=1e-6)
    torch.testing.assert_close(invstd, torch.rsqrt(var + EPS), rtol=1e-6, atol=0)
    assert int(m.num_batches_tracked) == 0


def test_plain_without_fold_leaves_the_buffers():
    x, _, w, b, rm, rv = _inputs((3, 16, 4, 4), torch.bfloat16)
    rm2, rv2 = rm.clone(), rv.clone()
    y, _, _ = bn.batch_norm_train_fwd(x, w, b, rm2, rv2, MOMENTUM, EPS, False, False)
    assert torch.equal(rm2, rm) and torch.equal(rv2, rv)
    y_fold, _, _ = bn.batch_norm_train_fwd(x, w, b, rm.clone(), rv.clone(), MOMENTUM, EPS,
                                           False, True)
    assert torch.equal(y, y_fold)


@pytest.mark.parametrize("rows,channels", [(1, 8), (6, 12)])
def test_what_the_kernels_refuse(rows, channels):
    with pytest.raises(ValueError, match="more than one value a channel and a multiple of 8"):
        bn.bn_plan(rows, channels, H100_SMS)


def test_registered_ops_and_kernels_list():
    x, dy, w, b, rm, rv = _inputs((2, 8, 3, 3), torch.bfloat16)
    y, mean, invstd = torch.ops.audiodepth.batch_norm_train_fwd(x, w, b, rm, rv, MOMENTUM, EPS,
                                                                True, True)
    dx, dw, db = torch.ops.audiodepth.batch_norm_train_bwd(dy, x, w, b, mean, invstd, EPS, True)
    assert y.shape == dx.shape == x.shape and mean.shape == dw.shape == (8,)
    for op, args in ((bn.batch_norm_train_fwd_op,
                      (x, w, b, rm.clone(), rv.clone(), MOMENTUM, EPS, True, True)),
                     (bn.batch_norm_train_bwd_op, (dy, x, w, b, mean, invstd, EPS, True))):
        torch.library.opcheck(op, args, test_utils=("test_schema", "test_faketensor"))
    names = {w.name for w, _, _ in KERNELS}
    assert {"batch_norm_train_fwd", "batch_norm_train_bwd"} <= names
    entry = next(e for e in KERNELS if e[0] is bn.batch_norm_train_fwd)
    assert entry[1] == bn.SOURCE and (ROOT / bn.SOURCE).exists()


# ---- remat -------------------------------------------------------------------------


def _op_everywhere(monkeypatch):
    """Route every bf16 train-mode 4-D BatchNorm through the op (its plain
    version on the CPU), as the card routes bf16 channels-last inputs."""
    monkeypatch.setattr(layers, "kernel_takes", lambda x, *params: x.dim() == 4)


def test_remat_folds_once_and_saves_the_same(monkeypatch):
    _op_everywhere(monkeypatch)
    calls = []
    real = bn.batch_norm_train_fwd_op

    def counting(*args):
        calls.append(args[-1])  # fold
        return real(*args)

    monkeypatch.setattr(bn, "batch_norm_train_fwd_op", counting)
    x, _, w, b, rm, rv = _inputs((4, 16, 6, 6), torch.bfloat16)
    outs = {}
    for name in ("plain", "remat"):
        torch.manual_seed(0)
        net = nn.Sequential(layers.Conv2d(16, 16, 3, bias=False, dtype=torch.bfloat16),
                            _module(16, torch.bfloat16, w, b, rm, rv, relu=True))
        xi = x.clone().float().requires_grad_()
        y = remat(net, xi) if name == "remat" else net(xi)
        y.float().square().sum().backward()
        outs[name] = (y, xi.grad, net[0].weight.grad, net[1].weight.grad, net[1].running_mean,
                      net[1].running_var)
    # the plain forward folds once; remat's forward folds, its recompute does not
    assert calls == [True, True, False]
    for a, b_ in zip(outs["plain"], outs["remat"]):
        assert torch.equal(a, b_)


# ---- the ReLU epilogue ------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_epilogue_matches_batch_norm_then_relu(dtype):
    x, dy, w, b, rm, rv = _inputs((3, 12, 5, 5), dtype)
    ref = nn.Sequential(_module(12, dtype, w, b, rm, rv), nn.ReLU())
    xr = x.clone().requires_grad_()
    y_ref = ref(xr)
    y_ref.backward(dy)
    for route in ("module", "op"):
        m = _module(12, dtype, w, b, rm, rv, relu=True)
        xi = x.clone().requires_grad_()
        y = m(xi) if route == "module" else bn.batch_norm_train(
            xi, m.weight, m.bias, m.running_mean, m.running_var, m.momentum, m.eps, True, True)
        y.backward(dy)
        assert torch.equal(y, y_ref) and torch.equal(xi.grad, xr.grad)
        assert torch.equal(m.weight.grad, ref[0].weight.grad)
        assert torch.equal(m.bias.grad, ref[0].bias.grad)
        assert torch.equal(m.running_mean, ref[0].running_mean)
        assert torch.equal(m.running_var, ref[0].running_var)


# ---- state_dicts ---------------------------------------------------------------------------


def _reference_double_conv(cin, cout):
    """The reference's DoubleConv: (conv3x3 → BN → ReLU) × 2 in one Sequential."""
    seq = nn.Sequential(nn.Conv2d(cin, cout, 3, padding=1, bias=False), nn.BatchNorm2d(cout),
                        nn.ReLU(inplace=True), nn.Conv2d(cout, cout, 3, padding=1, bias=False),
                        nn.BatchNorm2d(cout), nn.ReLU(inplace=True))
    holder = nn.Module()
    holder.double_conv = seq
    return holder


def test_double_conv_loads_the_reference_state_dict():
    ref = _reference_double_conv(3, 8)
    with torch.no_grad():
        for p in ref.parameters():
            p.normal_()
    port = DoubleConv(3, 8)
    assert list(port.state_dict()) == list(ref.state_dict())
    port.load_state_dict(ref.state_dict(), strict=True)
    assert [type(m) for m in port.double_conv] == [
        layers.Conv2d, BatchNorm, nn.Identity, layers.Conv2d, BatchNorm, nn.Identity]
    assert port.double_conv[1].relu and port.double_conv[4].relu
    x = torch.randn(2, 3, 6, 6)
    torch.testing.assert_close(port.train()(x), ref.double_conv.train()(x), rtol=1e-5,
                               atol=1e-5)


def test_binaural_net_loads_the_reference_state_dict():
    from benchmark.reference.nets import build_net

    cfg = json.loads((ROOT / "benchmark/configs/binaural_attention.json").read_text())
    cfg.update(base_channels=8, images_size=32)
    ref = build_net(cfg)
    port = BinauralAttentionNet(base_channels=8, output_size=32)
    assert list(port.state_dict()) == list(ref.state_dict())
    port.load_state_dict(ref.state_dict(), strict=True)
    fused = port.fusion_layers["fusion_1"]
    assert isinstance(fused[1], BatchNorm) and fused[1].relu and isinstance(fused[2], nn.Identity)
    norms = [m for m in port.modules() if isinstance(m, BatchNorm)]
    assert len(norms) == 33 and all(m.relu for m in norms)


# ---- dispatch -------------------------------------------------------------------------------


class _OnCard:
    """A CPU tensor's properties, reported as lying on a card: what the
    dispatch predicate reads."""

    is_cuda = True

    def __init__(self, t):
        self.t = t

    @property
    def dtype(self):
        return self.t.dtype

    @property
    def shape(self):
        return self.t.shape

    def dim(self):
        return self.t.dim()

    def is_contiguous(self, **kw):
        return self.t.is_contiguous(**kw)


def test_dispatch_predicate(monkeypatch):
    x = _channels_last(torch.randn(2, 8, 4, 4).to(torch.bfloat16))
    m = BatchNorm(8, torch.bfloat16).train()
    params = (m.weight, m.bias, m.running_mean, m.running_var)
    assert bn.kernel_takes(_OnCard(x), *params)
    assert not bn.kernel_takes(x, *params)                                # CPU
    assert not bn.kernel_takes(_OnCard(x.float()), *params)               # fp32
    assert not bn.kernel_takes(_OnCard(x.contiguous()), *params)          # NCHW
    assert not bn.kernel_takes(_OnCard(torch.randn(2, 8).to(torch.bfloat16)), *params)  # [B, C]
    m12 = BatchNorm(12, torch.bfloat16)
    assert not bn.kernel_takes(_OnCard(_channels_last(                    # 12 channels
        torch.randn(2, 12, 4, 4).to(torch.bfloat16))), m12.weight, m12.bias, m12.running_mean,
        m12.running_var)
    assert not bn.kernel_takes(_OnCard(x), *(p.double() for p in params))  # fp64 buffers
    # the module's own conditions, on tensors the kernels take
    taken = []
    monkeypatch.setattr(layers, "kernel_takes", lambda *args: True)
    monkeypatch.setattr(layers, "batch_norm_train", lambda x, *args, **kw: taken.append(x) or x)

    def routed(m):
        taken.clear()
        m(x)
        return bool(taken)

    assert routed(m)
    assert not routed(BatchNorm(8, torch.float32).train())                # fp32 compute
    assert not routed(m.eval())                                           # eval
    m.train()
    with use_group(SimpleNamespace(size=1)):
        assert not routed(m)                                              # a data group


@pytest.mark.parametrize("case", ["cpu", "fp32", "fp64", "eval", "nchw", "group", "flat"])
def test_excluded_cases_run_the_module_code(case, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel path ran")

    monkeypatch.setattr(layers, "batch_norm_train", refuse)
    dtype = {"fp32": torch.float32, "fp64": torch.float64}.get(case, torch.bfloat16)
    m = BatchNorm(8, dtype, relu=True).to(torch.float64 if case == "fp64" else torch.float32)
    x = torch.randn(2, 8) if case == "flat" else torch.randn(2, 8, 3, 3)
    x = x.to(dtype)
    if case not in ("nchw", "flat"):
        x = _channels_last(x)
    if case == "eval":
        m.eval()
    if case == "group":
        with use_group(SimpleNamespace(size=1)):  # one rank's data group
            y = m(x)
    else:
        y = m(x)
    assert y.dtype == dtype and (y >= 0).all()


# ---- the plan ---------------------------------------------------------------------------------


@pytest.mark.parametrize("shape", UNET_SHAPES + BINAURAL_SHAPES)
def test_plan_over_the_main_shapes(shape):
    n, c, h, w = shape
    rows = n * h * w
    p = bn.bn_plan(rows, c, H100_SMS)
    assert p.channel_tiles == 1 and p.group_tile == c // bn.VEC
    assert p.rows_per_iter * p.group_tile == bn.THREADS
    assert p.rows_per_block % p.rows_per_iter == 0
    assert (p.row_blocks - 1) * p.rows_per_block < rows <= p.row_blocks * p.rows_per_block
    assert p.row_blocks <= H100_SMS * bn.BLOCKS_PER_SM
    assert p.fwd_scratch_floats == 2 * p.row_blocks * c
    assert p.bwd_scratch_floats == 2 * p.row_blocks * c + 3 * c
    # a full wave (chunks rounded up to whole row slots) where the rows allow
    # it, else at least MIN_ROWS_PER_SLOT rows a slot
    wave = H100_SMS * bn.BLOCKS_PER_SM
    if rows >= wave * p.rows_per_iter * bn.MIN_ROWS_PER_SLOT:
        assert p.rows_per_block == -(-(-(-rows // wave)) // p.rows_per_iter) * p.rows_per_iter
    else:
        assert p.rows_per_block >= p.rows_per_iter * bn.MIN_ROWS_PER_SLOT


def test_plan_literal_and_edges():
    assert bn.bn_plan(256 * 128 * 128, 64, H100_SMS) == bn.BnPlan(
        rows=4194304, channels=64, group_tile=8, channel_tiles=1, rows_per_iter=32,
        rows_per_block=15904, row_blocks=264)
    assert bn.bn_plan(256 * 2 * 2, 512, H100_SMS) == bn.BnPlan(
        rows=1024, channels=512, group_tile=64, channel_tiles=1, rows_per_iter=4,
        rows_per_block=64, row_blocks=16)
    few = bn.bn_plan(7, 24, H100_SMS)                 # 3 groups: 85 row slots, one block
    assert (few.group_tile, few.rows_per_iter, few.row_blocks) == (3, 85, 1)
    wide = bn.bn_plan(12, 4800, H100_SMS)             # 600 groups: three channel tiles
    assert (wide.channel_tiles, wide.group_tile, wide.rows_per_iter) == (3, 200, 1)


def test_row_stride():
    x = _channels_last(torch.zeros(2, 6, 3, 4))
    assert bn.row_stride(x) == 6
    both = _channels_last(torch.zeros(2, 10, 3, 4))
    assert bn.row_stride(both[:, 4:]) == 10            # the gradient of a concatenation
    assert bn.row_stride(torch.zeros(2, 6, 3, 4)) is None  # NCHW
    assert bn.row_stride(torch.zeros(5, 6, 1, 1)) == 6
    assert bn.row_stride(_channels_last(torch.zeros(1, 6, 1, 3))) == 6


# ---- on the card ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels are CUDA C++ with no CPU form")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def reference64(x, dy, w, b, rm, rv, relu_mask=None):
    """Float64 forward statistics, output, folded buffers and gradients of
    the same bf16 inputs; the backward's ReLU mask is the one given (the
    kernel's own, so that a pre-activation within rounding of 0 cannot
    part the two)."""
    xd, dyd = x.double(), dy.double()
    var, mean = torch.var_mean(xd, dim=(0, 2, 3), correction=0)
    rows = x.numel() // x.shape[1]
    invstd = torch.rsqrt(var + EPS)
    shape = (1, -1, 1, 1)
    xhat = (xd - mean.view(shape)) * invstd.view(shape)
    y = xhat * w.double().view(shape) + b.double().view(shape)
    g = dyd if relu_mask is None else dyd * relu_mask
    if relu_mask is not None:
        y = y.clamp_min(0)
    s1, s2 = g.sum(dim=(0, 2, 3)), (g * xhat).sum(dim=(0, 2, 3))
    dx = (w.double() * invstd).view(shape) * (g - (s1 / rows).view(shape)
                                              - xhat * (s2 / rows).view(shape))
    rm_ref = (1 - MOMENTUM) * rm.double() + MOMENTUM * mean
    rv_ref = (1 - MOMENTUM) * rv.double() + MOMENTUM * var * rows / (rows - 1)
    return dict(y=y, mean=mean, invstd=invstd, dx=dx, dw=s2, db=s1, rm=rm_ref, rv=rv_ref,
                abs_g=g.abs().sum(dim=(0, 2, 3)), abs_gx=(g * xhat).abs().sum(dim=(0, 2, 3)),
                rms=torch.sqrt(mean * mean + var))


def check_against_reference(got, ref):
    """Tolerances: y and dx are bf16, so within half a bf16 ulp (2^-8 of
    the value) plus 1e-4 of the largest |value| for the fp32 arithmetic
    before the rounding; mean within 1e-5 of the channel's rms and invstd
    within 1e-5 relative (fp32 Welford/Chan over up to 4.2 M rows); dγ and
    dβ within 1e-4 of the sum of the terms' magnitudes (fp32 sums of a few
    hundred terms a thread, then fixed trees); the folded buffers within
    1e-5 of the channel's rms."""
    y, dx = ref["y"], ref["dx"]
    assert ((got["y"].double() - y).abs() <= 2 ** -8 * y.abs() + 1e-4 * y.abs().max()).all()
    assert ((got["dx"].double() - dx).abs() <= 2 ** -8 * dx.abs() + 1e-4 * dx.abs().max()).all()
    assert ((got["mean"].double() - ref["mean"]).abs() <= 1e-5 * ref["rms"]).all()
    assert ((got["invstd"].double() / ref["invstd"] - 1).abs() <= 1e-5).all()
    assert ((got["dw"].double() - ref["dw"]).abs() <= 1e-4 * ref["abs_gx"] + 1e-6).all()
    assert ((got["db"].double() - ref["db"]).abs() <= 1e-4 * ref["abs_g"] + 1e-6).all()
    for k in ("rm", "rv"):
        assert ((got[k].double() - ref[k]).abs() <= 1e-5 * (ref["rms"] ** 2 + 1)).all()


def run_kernels(x, dy, w, b, rm, rv, relu):
    rm, rv = rm.clone(), rv.clone()
    y, mean, invstd = bn.batch_norm_train_fwd(x, w, b, rm, rv, MOMENTUM, EPS, relu, True)
    dx, dw, db = bn.batch_norm_train_bwd(dy, x, w, b, mean, invstd, EPS, relu)
    return dict(y=y, mean=mean, invstd=invstd, dx=dx, dw=dw, db=db, rm=rm, rv=rv)


@pytest.mark.card
@pytest.mark.parametrize("shape,relu", [(s, False) for s in UNET_SHAPES]
                         + [(s, True) for s in BINAURAL_SHAPES])
def test_kernels_on_the_card(card, shape, relu):
    x, dy, w, b, rm, rv = _inputs(shape, torch.bfloat16, device=card)
    before = (bn.batch_norm_train_fwd.launches, bn.batch_norm_train_bwd.launches)
    got = run_kernels(x, dy, w, b, rm, rv, relu)
    assert (bn.batch_norm_train_fwd.launches, bn.batch_norm_train_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    again = run_kernels(x, dy, w, b, rm, rv, relu)
    for k in got:
        assert torch.equal(got[k], again[k]), f"{k} differs between two runs"
    mask = (got["y"] > 0).double() if relu else None
    check_against_reference(got, reference64(x, dy, w, b, rm, rv, mask))
    del again
    # the plain version (the module's own chain, on the card) within the same bounds
    rm_p, rv_p = rm.clone(), rv.clone()
    y_p, mean_p, invstd_p = bn.batch_norm_train_fwd_plain(x, w, b, rm_p, rv_p, MOMENTUM, EPS,
                                                          relu, True)
    dx_p, dw_p, db_p = bn.batch_norm_train_bwd_plain(dy, x, w, b, mean_p, invstd_p, EPS, relu)
    mask_p = (y_p > 0).double() if relu else None
    check_against_reference(dict(y=y_p, mean=mean_p, invstd=invstd_p, dx=dx_p, dw=dw_p, db=db_p,
                                 rm=rm_p, rv=rv_p), reference64(x, dy, w, b, rm, rv, mask_p))


@pytest.mark.card
def test_sliced_gradient_and_module_path_on_the_card(card):
    """dy as a channel slice of a concatenation's gradient (rows 2C apart),
    and the module routing a bf16 channels-last train input to the kernels."""
    shape = (8, 64, 16, 16)
    x, dy, w, b, rm, rv = _inputs(shape, torch.bfloat16, device=card)
    wide = torch.cat([dy, dy], dim=1)
    got = run_kernels(x, wide[:, 64:], w, b, rm, rv, True)
    ref = run_kernels(x, dy.clone(), w, b, rm, rv, True)
    assert torch.equal(got["dx"], ref["dx"]) and torch.equal(got["dw"], ref["dw"])
    m = _module(64, torch.bfloat16, w, b, rm, rv, relu=True).to(card)
    before = bn.batch_norm_train_fwd.launches
    y = m(x)
    assert bn.batch_norm_train_fwd.launches == before + 1 and torch.equal(y, ref["y"])
    assert torch.equal(m.running_mean, ref["rm"])
