"""What the benchmark's yardstick returns, pinned bit for bit: the pairs and
weights drawn from a seed, each family's initialisation rules, the model
FLOPs, the kernels' bounds and the reference's first training steps.

The constants were recorded from commit fc86411 (before families, their
FLOP counts and the kernels' bounds became files of their own), on the CPU
with one thread: the same ops in the same order give the same bits, so
every reading is compared exactly. The reference's steps run at a reduced
width (UNet-256 at ngf 8; the binaural net at base 8 and 64², where a
256² attention level would take minutes on the CPU), batch 2, two steps.

    python benchmark/tests/test_bench_pinned.py   # prints today's readings
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import pytest
import torch

BENCH_DIR = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[:0] = [str(BENCH_DIR.parent), str(BENCH_DIR)]

from flops import PEAKS, kernel_bound_s, model_flops, train_flops_per_pair  # noqa: E402
from harness.inputs import make_pairs, make_weights  # noqa: E402
from reference import Precision, param_specs  # noqa: E402
from reference.train import reference_steps  # noqa: E402

CONFIGS = ("unet_256", "binaural_attention")
B1 = "audiodepth::fused_mel_frontend"
B2 = "audiodepth::flash_cross_attention_fwd"
B3 = "audiodepth::flash_cross_attention_bwd"
# (op, input shapes, input dtype as the profiler names it): the trace
# test's call, chip_smoke.py's B1 rows and its four base-64 levels at
# 2B = 32 in bf16 and float32
BOUND_CALLS = [(B2, [[4, 256, 16], [4, 256, 16], [4, 256, 128], []], "c10::BFloat16")]
BOUND_CALLS += [(B1, [[b, c, length]], "float")
                for b, c, length in ((1, 2, 7782), (4, 2, 7782), (16, 2, 7782), (4, 2, 4000),
                                     (64, 2, 8038), (256, 2, 8038))]
for _n, _dk, _dv in ((16384, 16, 128), (4096, 32, 256), (1024, 64, 512), (256, 64, 512)):
    _q, _v = [32, _n, _dk], [32, _n, _dv]
    for _dtype in ("c10::BFloat16", "float"):
        BOUND_CALLS.append((B2, [_q, _q, _v], _dtype))
        BOUND_CALLS.append((B3, [_q, _q, _v, _v, [32, _n, 1], _v], _dtype))


def _config(name):
    with open(BENCH_DIR / "configs" / f"{name}.json") as f:
        return json.load(f)


def _tensors_digest(tensors) -> str:
    h = hashlib.sha256()
    for key, value in tensors.items():
        t = value.detach().cpu().contiguous()
        h.update(f"{key}:{tuple(t.shape)}:{t.dtype};".encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def _text_digest(value) -> str:
    return hashlib.sha256(repr(value).encode()).hexdigest()


def _reduced(name):
    cfg = _config(name)
    if cfg["family"] == "unet_baseline":
        cfg["ngf"] = 8
    else:
        cfg.update(base_channels=8, images_size=64)
    return cfg


def _steps(name):
    cfg = _reduced(name)
    weights = make_weights(cfg, 7, "cpu")
    pairs = make_pairs(4, 7, cfg, "cpu")
    batches = [lambda s=s: {k: v[s:s + 2] for k, v in pairs.items()} for s in (0, 2)]
    out = reference_steps(cfg, weights, batches, Precision(), "cpu")
    return {"loss": [float(x).hex() for x in out["loss"]],
            "grad": _text_digest([(n, float(g).hex()) for n, g in out["grad"].items()]),
            "change": _text_digest([(n, float(c).hex()) for n, c in out["change"].items()]),
            "bn": _tensors_digest({f"{n}.{i}": s for n, stats in out["bn"].items()
                                   for i, s in enumerate(stats)})}


def reading(key: str):
    """One pinned reading by its key: `<what>/<argument>`."""
    what, arg = key.split("/", 1)
    if what == "pairs":
        name, seed = arg.split("@")
        return _tensors_digest(make_pairs(8, int(seed), _config(name), "cpu"))
    if what == "param_specs":
        specs = param_specs(_config(arg))
        return [len(specs), _text_digest(specs)]
    if what == "weights":
        return _tensors_digest(make_weights(_config(arg), 0, "cpu"))
    if what == "flops":
        cfg = _config(arg)
        return [model_flops(cfg).hex(), train_flops_per_pair(cfg).hex()]
    if what == "bound":
        op, shapes, dtype = BOUND_CALLS[int(arg)]
        return [kernel_bound_s(op, shapes, dtype, PEAKS[p]).hex() for p in sorted(PEAKS)]
    if what == "steps":
        return _steps(arg)
    raise KeyError(key)


KEYS = ([f"pairs/{c}@{s}" for c in CONFIGS for s in (0, 1)]
        + [f"{w}/{c}" for w in ("param_specs", "weights", "flops", "steps") for c in CONFIGS]
        + [f"bound/{i}" for i in range(len(BOUND_CALLS))])

PINNED = {
    "pairs/unet_256@0": "fca782fb4ff59fa689e0c3f49b83008ac8ee673cf981d2287810e37f111c5121",
    "pairs/unet_256@1": "18e3889bfbdbeba3e39e1139f2de6435696b5d6aefba224cdd476fb8959bafd6",
    "pairs/binaural_attention@0":
        "fca782fb4ff59fa689e0c3f49b83008ac8ee673cf981d2287810e37f111c5121",
    "pairs/binaural_attention@1":
        "18e3889bfbdbeba3e39e1139f2de6435696b5d6aefba224cdd476fb8959bafd6",
    "param_specs/unet_256": [
        82,
        "e046fc85821b90ade7e93573905ae2b85c23730d228a7e0646c22156e41b73aa",
    ],
    "param_specs/binaural_attention": [
        241,
        "1398f36eba5e62482e0c94a96129244fd46d336bd430b28d80d19193e39d5d29",
    ],
    "weights/unet_256": "f97cc925a0a650c2bc3b0391157c47bb79c80f45f7c678ccd0cf531b0c6c428d",
    "weights/binaural_attention":
        "f9f725e0f38c7f8d05a3f3953d443f91f356c6c62e4def522e505dbace116d61",
    "flops/unet_256": ["0x1.6380000000000p+33", "0x1.0aa0000000000p+35"],
    "flops/binaural_attention": ["0x1.155a000000000p+38", "0x1.a007000000000p+39"],
    "steps/unet_256": {
        "loss": ["0x1.ed9d280000000p+2", "0x1.bb2d6c0000000p+2"],
        "grad": "078a3df3241e26a56a5f477b269a7fd7eb88d7e6b62107b05c9b58d5394d5d2f",
        "change": "d18e333f87841e9cfcf4adb19ea76f71442eaa6fafeaeb8ce9bf75d1722a9378",
        "bn": "530143e1c9fb8f8b1d7c47f5e6446200731c9e5fa81754b6c30be6af45990ecb",
    },
    "steps/binaural_attention": {
        "loss": ["0x1.1107080000000p+1", "0x1.10a18c0000000p+1"],
        "grad": "b21011e600c9da80609ad5e79684d23ded181ad3401f8a7e79a52eb8d2c5ae47",
        "change": "745378e528d9a79383b19da442c7c30130c1cd272bd431156e4346bdfe3558d5",
        "bn": "2522ba6afe8fbea32f8f9ef7618ee8321b6ddab78e9cfd541b103ef01fb70ef3",
    },
    "bound/0": ["0x1.4708c32655891p-23", "0x1.3edbbe4560327p-22", "0x1.7cb9f64b31e83p-23"],
    "bound/1": ["0x1.ce93c025585c6p-23", "0x1.00026dacc10c9p-22", "0x1.87556a8cbfdc7p-23"],
    "bound/2": ["0x1.ce93c025585c6p-21", "0x1.00026dacc10c9p-20", "0x1.87556a8cbfdc7p-21"],
    "bound/3": ["0x1.ce93c025585c6p-19", "0x1.00026dacc10c9p-18", "0x1.87556a8cbfdc7p-19"],
    "bound/4": ["0x1.ddbe5d87181c4p-22", "0x1.08673ab69d695p-21", "0x1.942a0d84c626ep-22"],
    "bound/5": ["0x1.ddbe5d87181c4p-17", "0x1.08673ab69d695p-16", "0x1.942a0d84c626ep-17"],
    "bound/6": ["0x1.ddbe5d87181c4p-15", "0x1.08673ab69d695p-14", "0x1.942a0d84c626ep-15"],
    "bound/7": ["0x1.8455973fbe56bp-9", "0x1.acea0c4d8401ap-9", "0x1.47dd9e3dd7938p-9"],
    "bound/8": ["0x1.99e8916df3947p-8", "0x1.c4be296e443aap-8", "0x1.5a1498cf7fff4p-8"],
    "bound/9": ["0x1.2340316fcec10p-6", "0x1.41af893a23014p-6", "0x1.ebcc6d5cc35d4p-7"],
    "bound/10": ["0x1.336e6d1276af5p-5", "0x1.538e9f12b32bfp-5", "0x1.038f729b9fff7p-5"],
    "bound/11": ["0x1.8455973fbe56bp-12", "0x1.acea0c4d8401ap-12", "0x1.47dd9e3dd7938p-12"],
    "bound/12": ["0x1.99e8916df3947p-11", "0x1.c4be296e443aap-11", "0x1.5a1498cf7fff4p-11"],
    "bound/13": ["0x1.2340316fcec10p-9", "0x1.41af893a23014p-9", "0x1.ebcc6d5cc35d4p-10"],
    "bound/14": ["0x1.336e6d1276af5p-8", "0x1.538e9f12b32bfp-8", "0x1.038f729b9fff7p-8"],
    "bound/15": ["0x1.8455973fbe56bp-15", "0x1.acea0c4d8401ap-15", "0x1.47dd9e3dd7938p-15"],
    "bound/16": ["0x1.99e8916df3947p-14", "0x1.c4be296e443aap-14", "0x1.5a1498cf7fff4p-14"],
    "bound/17": ["0x1.2340316fcec10p-12", "0x1.41af893a23014p-12", "0x1.ebcc6d5cc35d4p-13"],
    "bound/18": ["0x1.336e6d1276af5p-11", "0x1.538e9f12b32bfp-11", "0x1.038f729b9fff7p-11"],
    "bound/19": ["0x1.4557b950111eep-18", "0x1.3d3587e143e48p-17", "0x1.7ac1d3ea95d79p-18"],
    "bound/20": ["0x1.450f8d01b0628p-17", "0x1.3cef297b3f2cep-16", "0x1.7a6dce2fd12a2p-17"],
    "bound/21": ["0x1.2340316fcec10p-16", "0x1.41af893a23014p-16", "0x1.ebcc6d5cc35d4p-17"],
    "bound/22": ["0x1.336e6d1276af5p-15", "0x1.538e9f12b32bfp-15", "0x1.038f729b9fff7p-15"],
}


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("key", KEYS)
def test_reading_equals_the_recorded_one(key, one_thread):
    assert reading(key) == PINNED[key]


if __name__ == "__main__":
    torch.set_num_threads(1)
    print(json.dumps({k: reading(k) for k in KEYS}, indent=1))
