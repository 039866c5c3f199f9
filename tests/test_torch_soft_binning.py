"""AdaBins' soft-binning kernel pair (`ops/cuda/soft_binning.py`,
`csrc/soft_binning.cu`) and its place in `models/adabins.py` and
`losses/distillation.py`.

On the CPU (torch only, a few seconds):
  * `sb_plan` over the AdaBins cell's shape, small and ragged shapes, and
    what the kernels refuse;
  * the registered ops' plain versions (their CPU implementations) against
    the model's own chain through autograd, bit for bit in float64 and in
    bfloat16: base, the logits' spatial mean, and the gradients to the
    logits and the centers from random g_base and g_mean;
  * the ops' schemas and fakes (shapes, dtypes, layouts) and the
    registered autograd formula;
  * the model's dispatch predicate: the module path on the CPU and in
    float32 and float64, the kernel path only for bf16 channels-last logits
    on a card; the op through the model (its plain version on the CPU)
    giving the module path's outputs and gradients, with and without remat;
  * the KL term from the branches' `bin_logit_mean` against the KL of the
    spatial means of `bin_logits`, in float64.
Marked `card` (skipped without one; on the card: `python3 -m pytest -m card
tests/test_torch_soft_binning.py`): the kernels against the plain version,
two runs bit-equal, and the model routing bf16 channels-last logits to them.
"""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from audiodepth_tpu_torch.losses import distillation as dist
from audiodepth_tpu_torch.models import adabins
from audiodepth_tpu_torch.models.adabins import AdaBinsDistillationModel
from audiodepth_tpu_torch.models.layers import at_least_f32
from audiodepth_tpu_torch.ops.cuda import KERNELS
from audiodepth_tpu_torch.ops.cuda import soft_binning as sb

ROOT = Path(__file__).resolve().parents[1]
H100_SMS = 132


def _inputs(shape, dtype, seed=0, channels_last=True):
    g = torch.Generator().manual_seed(seed)
    b, k, h, w = shape
    logits = (torch.randn(shape, generator=g, dtype=torch.float64) * 2.0).to(dtype)
    if channels_last:
        logits = logits.contiguous(memory_format=torch.channels_last)
    widths = torch.softmax(torch.randn(b, k, generator=g, dtype=torch.float64), dim=1)
    centers = ((torch.cumsum(widths, dim=1) - 0.5 * widths) * 30.0).to(
        torch.promote_types(dtype, torch.float32))
    g_base = torch.randn(b, 1, h, w, generator=g, dtype=torch.float64).to(centers.dtype)
    g_mean = torch.randn(b, k, generator=g, dtype=torch.float64).to(centers.dtype)
    return logits, centers, g_base, g_mean


def _module_chain(logits, centers):
    """The model's chain as it was written before the op: the cast, the
    softmax expectation, and the loss's spatial mean."""
    z = at_least_f32(logits)
    probs = torch.softmax(z, dim=1)
    base = torch.sum(probs * centers[:, :, None, None], dim=1, keepdim=True)
    return base, z.mean(dim=(2, 3))


# ---- the launch plan ---------------------------------------------------------------------


def test_plan_of_the_adabins_cell():
    plan = sb.sb_plan(64, 128, 256 * 256, H100_SMS)
    assert plan == sb.SbPlan(batch=64, bins=128, hw=65536, lanes=16, slots=16,
                             pixels_per_block=1024, blocks=64)
    assert plan.scratch_floats == 64 * 64 * 128


@pytest.mark.parametrize("batch,bins,hw", [(1, 8, 1), (2, 8, 35), (3, 24, 323), (2, 64, 1023),
                                           (4, 128, 1640), (2, 136, 256), (2, 256, 420),
                                           (16, 128, 65536), (64, 128, 64 * 64)])
def test_plan_covers_every_pixel_once(batch, bins, hw):
    plan = sb.sb_plan(batch, bins, hw, H100_SMS)
    assert plan.lanes in (1, 2, 4, 8, 16, 32)
    assert plan.lanes * sb.VEC >= bins > plan.lanes * sb.VEC // 2     # lanes = pow2 ≥ K/8
    assert plan.slots * plan.lanes == sb.THREADS
    assert plan.pixels_per_block % plan.slots == 0
    assert (plan.blocks - 1) * plan.pixels_per_block < hw <= plan.blocks * plan.pixels_per_block
    # small images are cut into more blocks, so the card has work for each SM
    # (at least half the target: a block's pixels are rounded up to its slots)
    assert 2 * batch * plan.blocks >= min(sb.MIN_BLOCKS_PER_SM * H100_SMS,
                                          batch * -(-hw // plan.slots))


@pytest.mark.parametrize("batch,bins,hw", [(2, 12, 16), (2, 4, 16), (2, 264, 16), (2, 8, 0),
                                           (0, 8, 16), (65536, 8, 1)])
def test_what_the_kernels_refuse(batch, bins, hw):
    with pytest.raises(ValueError, match="the kernels take"):
        sb.sb_plan(batch, bins, hw, H100_SMS)


# ---- the plain versions against the model's chain -----------------------------------------


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 8, 5, 7), (3, 24, 4, 4), (2, 16, 1, 1)])
def test_plain_matches_the_model_chain(dtype, shape):
    logits, centers, g_base, g_mean = _inputs(shape, dtype)
    z = logits.detach().requires_grad_()
    c = centers.detach().requires_grad_()
    want_base, want_mean = _module_chain(z, c)
    want_dz, want_dc = torch.autograd.grad((want_base, want_mean), (z, c), (g_base, g_mean))
    base, mean = sb.soft_binning_fwd_plain(logits, centers)
    dz, dc = sb.soft_binning_bwd_plain(g_base, g_mean, logits, centers, base)
    for got, want in ((base, want_base), (mean, want_mean), (dz, want_dz), (dc, want_dc)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)
    assert dz.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_registered_op_autograd_matches_the_model_chain(dtype):
    logits, centers, g_base, g_mean = _inputs((2, 16, 6, 5), dtype, seed=3)
    z, c = logits.detach().requires_grad_(), centers.detach().requires_grad_()
    got = sb.soft_binning_fwd_op(z, c)
    got_grads = torch.autograd.grad(got, (z, c), (g_base, g_mean))
    z2, c2 = logits.detach().requires_grad_(), centers.detach().requires_grad_()
    want = _module_chain(z2, c2)
    want_grads = torch.autograd.grad(want, (z2, c2), (g_base, g_mean))
    for a, b in zip(got + got_grads, want + want_grads):
        assert torch.equal(a, b)
    # only the gradient asked for: the centers' alone
    (dc,) = torch.autograd.grad(sb.soft_binning_fwd_op(logits, c)[0], (c,), (g_base,))
    assert torch.equal(dc, torch.autograd.grad(_module_chain(logits, c)[0], (c,), (g_base,))[0])


def test_registered_ops_schemas_fakes_and_kernels_list():
    for channels_last in (True, False):
        logits, centers, g_base, g_mean = _inputs((2, 16, 3, 4), torch.bfloat16,
                                                  channels_last=channels_last)
        base, mean = torch.ops.audiodepth.soft_binning_fwd(logits, centers)
        dz, dc = torch.ops.audiodepth.soft_binning_bwd(g_base, g_mean, logits, centers, base)
        assert base.shape == (2, 1, 3, 4) and mean.shape == dc.shape == (2, 16)
        assert base.dtype == mean.dtype == dc.dtype == torch.float32
        assert dz.dtype == torch.bfloat16 and dz.shape == logits.shape
        for op, args in ((sb.soft_binning_fwd_op, (logits, centers)),
                         (sb.soft_binning_bwd_op, (g_base, g_mean, logits, centers, base))):
            torch.library.opcheck(op, args, test_utils=("test_schema", "test_faketensor"))
    leaf = logits.detach().requires_grad_()
    torch.library.opcheck(sb.soft_binning_fwd_op, (leaf, centers),
                          test_utils=("test_autograd_registration",))
    names = {w.name for w, _, _ in KERNELS}
    assert {"soft_binning_fwd", "soft_binning_bwd"} <= names
    for wrapper in (sb.soft_binning_fwd, sb.soft_binning_bwd):
        entry = next(e for e in KERNELS if e[0] is wrapper)
        assert entry[1] == sb.SOURCE and (ROOT / sb.SOURCE).exists()


def test_wrappers_check_their_inputs():
    logits, centers, g_base, g_mean = _inputs((2, 16, 3, 4), torch.float32)
    with pytest.raises(ValueError, match="centers must be"):
        sb.soft_binning_fwd(logits, centers[:, :8])
    with pytest.raises(ValueError, match="logits must be"):
        sb.soft_binning_fwd(logits[0], centers)
    base, _ = sb.soft_binning_fwd(logits, centers)
    with pytest.raises(ValueError, match="g_mean must be"):
        sb.soft_binning_bwd(g_base, g_mean[:1], logits, centers, base)


# ---- the model --------------------------------------------------------------------------------


class _Like:
    """A tensor's properties as the dispatch predicate reads them, reported
    on another device: what it sees of a card's tensor."""

    def __init__(self, t, device="cuda"):
        self.t, self.device = t, device
        self.is_cuda = device == "cuda"

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


def test_dispatch_predicate():
    path = AdaBinsDistillationModel._kernel_path
    logits, centers, _, _ = _inputs((2, 128, 4, 4), torch.bfloat16)
    on_card = lambda t: _Like(t)  # noqa: E731
    assert path(on_card(logits), on_card(centers))
    assert not path(logits, centers)                                          # CPU
    assert not path(on_card(logits.float()), on_card(centers))                # float32
    assert not path(on_card(logits.double()), on_card(centers.double()))      # float64
    assert not path(on_card(logits.contiguous()), on_card(centers))           # NCHW
    assert not path(on_card(logits), on_card(centers.double()))               # fp64 centres
    assert not path(on_card(logits), _Like(centers, "cpu"))                   # centres elsewhere
    assert not path(on_card(logits), on_card(centers[:1]))                    # [1, K] centres
    ragged = _inputs((2, 12, 4, 4), torch.bfloat16)
    assert not path(on_card(ragged[0]), on_card(ragged[1]))                   # 12 bins
    wide = _inputs((2, 264, 2, 2), torch.bfloat16)
    assert not path(on_card(wide[0]), on_card(wide[1]))                       # 264 bins
    odd = _inputs((2, 24, 3, 3), torch.bfloat16)
    assert path(on_card(odd[0]), on_card(odd[1]))                             # 24: 3 of 4 lanes


def _model(dtype, remat=False):
    torch.manual_seed(0)
    model = AdaBinsDistillationModel(n_bins=8, base_channels=4, output_size=32, dtype=dtype,
                                     remat=remat)
    return model.to(torch.promote_types(dtype, torch.float32)).to(
        memory_format=torch.channels_last)


def _run(model, audio, rgb):
    out = model(audio, rgb, mode="train", generator=torch.Generator().manual_seed(5))
    loss = out["audio"]["final_depth"].square().mean() + out["audio"]["bin_logit_mean"].sum()
    grads = torch.autograd.grad(loss, [p for p in model.parameters() if p.requires_grad
                                       and not any(p is q for q in model.teacher_parameters())])
    return out, grads


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
def test_module_path_on_the_cpu(dtype, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel path ran")

    monkeypatch.setattr(adabins, "soft_binning_fwd_op", refuse)
    model = _model(dtype).train()
    g = torch.Generator().manual_seed(1)
    audio = torch.rand(2, 2, 32, 32, generator=g).to(torch.promote_types(dtype, torch.float32))
    out = model(audio, torch.rand(2, 3, 32, 32, generator=g).to(audio.dtype), mode="train")
    for branch in ("audio", "rgb"):
        got = out[branch]
        assert got["bin_logits"].dtype == dtype                       # no fp32 copy kept
        assert torch.equal(got["bin_logit_mean"], at_least_f32(got["bin_logits"]).mean((2, 3)))
        assert got["base_depth"].dtype == torch.promote_types(dtype, torch.float32)


@pytest.mark.parametrize("remat", [False, True])
def test_op_through_the_model_matches_the_module_path(remat, monkeypatch):
    """The model routed to the registered op (its plain version and
    autograd formula on the CPU), as a card routes bf16 channels-last
    logits, gives the module path's outputs bit for bit and its gradients
    to float64 rounding: the op returns the logits' gradient channels-last,
    as the kernel does, so the class head's bias sums it in another order
    (3.6e-15 of 69 measured)."""
    g = torch.Generator().manual_seed(2)
    audio = torch.rand(2, 2, 32, 32, generator=g, dtype=torch.float64)
    rgb = torch.rand(2, 3, 32, 32, generator=g, dtype=torch.float64)
    want, want_grads = _run(_model(torch.float64, remat).train(), audio, rgb)
    calls = []

    def counted(logits, centers):
        calls.append(logits.requires_grad)
        return sb.soft_binning_fwd_op(logits, centers)

    monkeypatch.setattr(AdaBinsDistillationModel, "_kernel_path", staticmethod(lambda z, c: True))
    monkeypatch.setattr(adabins, "soft_binning_fwd_op", counted)
    got, got_grads = _run(_model(torch.float64, remat).train(), audio, rgb)
    # the student with grad (and again in remat's recompute), the teacher without
    assert calls == ([True, False, True] if remat else [True, False])
    for branch in ("audio", "rgb"):
        for k in ("base_depth", "bin_logit_mean", "final_depth", "bin_centers"):
            assert torch.equal(got[branch][k], want[branch][k]), (branch, k)
    for a, b in zip(got_grads, want_grads):
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())


# ---- the loss ---------------------------------------------------------------------------------


def test_kl_from_the_means_equals_the_kl_of_the_logits(monkeypatch):
    torch.manual_seed(4)
    audio = torch.randn(3, 8, 6, 5, dtype=torch.float64)
    rgb = torch.randn(3, 8, 6, 5, dtype=torch.float64)

    def kl_of_logits(a, r, t):  # the term as it read the logits before the op
        la = torch.log_softmax(a.mean(dim=(2, 3)) / t, dim=1)
        lr = torch.log_softmax(r.mean(dim=(2, 3)) / t, dim=1)
        return torch.sum(lr.exp() * (lr - la), dim=1).mean()

    for t in (1.0, 4.0):
        got = dist.bin_distribution_kl(audio.mean((2, 3)), rgb.mean((2, 3)), t)
        assert torch.equal(got, kl_of_logits(audio, rgb, t))
    # the whole loss reads the branches' means, not their logits
    branch = {"final_depth": torch.rand(3, 1, 6, 5, dtype=torch.float64) * 30,
              "residual": torch.randn(3, 1, 6, 5, dtype=torch.float64),
              "features": {}, "bin_centers": torch.rand(3, 8, dtype=torch.float64)}
    out = {"audio": dict(branch, bin_logit_mean=audio.mean((2, 3)), bin_logits=None),
           "rgb": dict(branch, bin_logit_mean=rgb.mean((2, 3)), bin_logits=None)}
    gt = torch.rand(3, 1, 6, 5, dtype=torch.float64) * 30
    _, parts = dist.distillation_loss(out, gt, gt > 0, temperature=2.0)
    assert torch.equal(parts["bin"], kl_of_logits(audio, rgb, 2.0))


# ---- on the card ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels are CUDA C++ with no CPU form")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("shape", [(2, 8, 5, 7), (3, 24, 17, 19), (4, 128, 40, 41),
                                   (2, 136, 16, 16), (2, 256, 20, 21), (1, 128, 1, 1)])
def test_kernels_on_the_card(card, shape):
    logits, centers, g_base, g_mean = (t.to(card) for t in _inputs(shape, torch.bfloat16))
    before = (sb.soft_binning_fwd.launches, sb.soft_binning_bwd.launches)
    runs = []
    for _ in range(2):
        base, mean = sb.soft_binning_fwd(logits, centers)
        runs.append((base, mean) + sb.soft_binning_bwd(g_base, g_mean, logits, centers, base))
    assert (sb.soft_binning_fwd.launches, sb.soft_binning_bwd.launches) == (
        before[0] + 2, before[1] + 2)
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    base, mean, dz, dc = runs[0]
    base_p, mean_p = sb.soft_binning_fwd_plain(logits, centers)
    dz_p, dc_p = sb.soft_binning_bwd_plain(g_base, g_mean, logits, centers, base_p)
    probs = torch.softmax(logits.float(), dim=1)
    assert float((base - base_p).abs().max()) <= 1e-5 * float(base_p.abs().max())
    assert ((mean - mean_p).abs() <= 1e-5 * logits.float().abs().mean((2, 3))).all()
    assert ((dc - dc_p).abs() <= 1e-5 * (g_base.abs() * probs).sum((2, 3))).all()
    want = dz_p.float()
    _, e = torch.frexp(want.abs().clamp_min(2.0 ** -126))
    ulp = torch.ldexp(torch.ones_like(want), e - 8)
    assert ((dz.float() - want).abs() <= ulp + 1e-6 * want.abs().max()).all()


@pytest.mark.card
def test_model_routes_to_the_kernels_on_the_card(card):
    model = _model(torch.bfloat16).to(card).train()
    g = torch.Generator().manual_seed(3)
    audio = torch.rand(2, 2, 32, 32, generator=g).to(card)
    rgb = torch.rand(2, 3, 32, 32, generator=g).to(card)
    fwd = SimpleNamespace(**dict(sb.soft_binning_fwd.variant_launches))
    grad, no_grad = getattr(fwd, "grad", 0), getattr(fwd, "no_grad", 0)
    bwd = sb.soft_binning_bwd.launches
    out = model(audio, rgb, mode="train", generator=torch.Generator(device=card).manual_seed(5))
    out["audio"]["final_depth"].mean().backward()
    assert sb.soft_binning_fwd.variant_launches["grad"] == grad + 1
    assert sb.soft_binning_fwd.variant_launches["no_grad"] == no_grad + 1
    assert sb.soft_binning_bwd.launches == bwd + 1
    assert out["audio"]["bin_logits"].dtype == torch.bfloat16
