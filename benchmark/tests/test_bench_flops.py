"""The frozen FLOP counts against the closed-form cross-checks, against
`FlopCounterMode` on the reference nets, and the kernel bounds against
`chip_smoke.py`'s figures."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from flops import PEAKS, kernel_bound_s, model_flops, peak_for, train_flops_per_pair
from flops.families import family
from reference.families import build_net

unet_macs = family("unet_baseline").unet_macs
binaural_macs = family("binaural_attention").binaural_macs

SXM = PEAKS["H100 SXM"]


def test_unet256_macs():
    # 5.96 G multiply-adds a pair: 11.9 GFLOP forward, 35.8 GFLOP trained
    assert unet_macs(256, 64, 8) == pytest.approx(5.9643e9, rel=1e-4)
    cfg = {"family": "unet_baseline", "generator": "unet_256", "ngf": 64, "images_size": 256}
    assert train_flops_per_pair(cfg) == pytest.approx(35.79e9, rel=1e-3)


def test_binaural_level2_attention():
    # N = 16,384, dk = 16, dv = 128, both directions: about 155 GFLOP
    only2 = binaural_macs(256, 64, (2,))
    assert 2 * only2["attention"] == pytest.approx(2 * 2 * 16384 ** 2 * (16 + 128), rel=1e-12)
    assert 2 * only2["attention"] == pytest.approx(154.6e9, rel=1e-3)


@pytest.mark.parametrize("cfg", [
    {"family": "unet_baseline", "generator": "unet_128", "ngf": 8, "images_size": 128},
    {"family": "binaural_attention", "base_channels": 8, "images_size": 64,
     "attention_levels": [2, 3, 4, 5], "max_depth": 30.0},
    {"family": "binaural_attention", "base_channels": 4, "images_size": 32,
     "attention_levels": [3, 5], "max_depth": 30.0},
], ids=["unet", "binaural", "binaural-two-levels"])
def test_closed_form_matches_flop_counter(cfg):
    net = build_net(cfg).eval()
    x = torch.rand(1, cfg["images_size"], cfg["images_size"], 2)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        net(x)
    assert counter.get_total_flops() == model_flops(cfg)


def test_kernel_bounds_match_chip_smoke():
    q, v = [32, 16384, 16], [32, 16384, 128]
    fwd = kernel_bound_s("audiodepth::flash_cross_attention_fwd", [q, q, v], "c10::BFloat16", SXM)
    bwd = kernel_bound_s("audiodepth::flash_cross_attention_bwd", [q, q, v, v, [32, 16384, 1], v],
                         "c10::BFloat16", SXM)
    assert fwd * 1e3 == pytest.approx(2.501, abs=1e-3)   # chip_smoke's B2 level 2 bound
    assert bwd * 1e3 == pytest.approx(5.281, abs=1e-3)   # and B3's
    f32 = kernel_bound_s("audiodepth::flash_cross_attention_fwd", [q, q, v], "float", SXM)
    assert f32 == pytest.approx(6 * fwd, rel=1e-9)        # six bf16 passes


def test_b1_bound_is_operations_at_the_main_shape():
    b1 = kernel_bound_s("audiodepth::fused_mel_frontend", [[16, 2, 7782]], "float", SXM)
    dft = 6 * 2.0 * 32 * (1 + 7782 // 32) * 64 * 2 * 232 / SXM["bf16"]
    mel = 2.0 * 32 * (1 + 7782 // 32) * 439 / SXM["fp32"]
    assert b1 == pytest.approx(dft + mel, rel=1e-9)
    assert b1 * 1e6 == pytest.approx(2.916, abs=2e-3)   # chip_smoke's B1 bound at B·C = 32


def test_peaks_by_name():
    assert peak_for("NVIDIA H100 80GB HBM3")["bf16"] == 989e12
    assert peak_for("NVIDIA H100 PCIe")["hbm"] == 2.0e12
    with pytest.raises(ValueError):
        peak_for("NVIDIA A100-SXM4-80GB")
