"""The port's audio front end against the JAX package's, on the CPU.

Same numpy-seeded waveforms through both packages:
  * the fused mel front end's plain version (what the CUDA kernel B1 is held
    to on the card) against the Pallas kernel in interpret mode, atol 1e-5
    (both are fp32; the two sum in different orders before `log` and the
    division by the channel's range);
  * `make_frontend` for BV2 mel, BV1 STFT and the waveform passthrough, in
    f32 (atol 1e-5, the same reason) and f64 (atol 1e-12: the same math at
    double precision, so only the summation order differs);
  * `resize_bilinear` on an upscale and a downscale;
  * the numpy constants (DFT basis, mel bank) bit for bit.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from audiodepth_tpu.configs import load_config as jax_load_config
from audiodepth_tpu.data import frontend as jax_frontend
from audiodepth_tpu.ops import resize as jax_resize
from audiodepth_tpu.ops import stft as jax_stft
from audiodepth_tpu.ops.pallas.fused_frontend import fused_mel_frontend as jax_fused

from audiodepth_tpu_torch.configs import load_config
from audiodepth_tpu_torch.data import frontend as port_frontend
from audiodepth_tpu_torch.ops import resize as port_resize
from audiodepth_tpu_torch.ops import stft as port_stft
from audiodepth_tpu_torch.ops.cuda.fused_frontend import fused_mel_frontend


@pytest.fixture
def f64():
    """Enable x64 for the JAX side; restore afterwards."""
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _wave(shape, seed):
    return np.random.default_rng(seed).normal(size=shape)


@pytest.mark.parametrize("length", [7782, 4000])
def test_fused_plain_matches_pallas_interpret(length):
    wave = _wave((2, 2, length), seed=length).astype(np.float32)
    want = np.asarray(jax_fused(jnp.asarray(wave), interpret=True))
    before = fused_mel_frontend.launches
    got = fused_mel_frontend(torch.from_numpy(wave)).numpy()
    assert fused_mel_frontend.launches == before  # a CPU tensor launches nothing
    assert got.shape == want.shape == (2, 2, 32, 1 + length // 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_constants_bit_identical():
    assert np.array_equal(port_stft.stft_basis(512, 64), jax_stft.stft_basis(512, 64))
    assert np.array_equal(port_stft.mel_filterbank(257, 32, 44100, 20.0, 20000.0),
                          jax_stft.mel_filterbank(257, 32, 44100, 20.0, 20000.0))
    golden = np.load(os.path.join(os.path.dirname(__file__), "golden",
                                  "mel_fbank_htk_257x32.npy"))
    np.testing.assert_allclose(port_stft.mel_filterbank(257), golden, rtol=0, atol=1e-7)


_FORMATS = [
    ("batvisionv2", "mel_spectrogram", (2, 256, 256, 2)),
    ("batvisionv1", "spectrogram", (2, 256, 256, 2)),
    ("batvisionv2", "waveform", (2, 2, 7782)),
]


def _frontends(dataset, fmt, dtype_name):
    overrides = {"dataset.audio_format": fmt, "mode.compute_dtype": dtype_name}
    return (jax_frontend.make_frontend(jax_load_config(dataset, overrides=overrides)),
            port_frontend.make_frontend(load_config(dataset, overrides=overrides)))


@pytest.mark.parametrize("dataset,fmt,shape", _FORMATS)
def test_make_frontend_f32(dataset, fmt, shape):
    jfe, pfe = _frontends(dataset, fmt, "float32")
    wave = _wave((2, 2, 9000), seed=1).astype(np.float32)
    want = np.asarray(jfe(wave))
    got = pfe(torch.from_numpy(wave))
    assert got.dtype == torch.float32
    assert got.shape == want.shape == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dataset,fmt,shape", _FORMATS)
def test_make_frontend_f64(f64, dataset, fmt, shape):
    jfe, pfe = _frontends(dataset, fmt, "float64")
    wave = _wave((2, 2, 9000), seed=2)
    want = np.asarray(jfe(wave))
    got = pfe(torch.from_numpy(wave))
    assert want.dtype == np.float64 and got.dtype == torch.float64
    assert got.shape == want.shape == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


def test_tof_cut_samples():
    for depth, sr in [(30.0, 44100), (12.0, 44100), (5.0, 16000)]:
        assert port_frontend.tof_cut_samples(depth, sr) == jax_frontend.tof_cut_samples(depth, sr)
    assert port_frontend.tof_cut_samples(30.0, 44100) == 7782


@pytest.mark.parametrize("in_hw,out_hw", [((32, 244), (256, 256)),
                                          ((257, 487), (100, 256))])
def test_resize_bilinear_matches_jax(in_hw, out_hw):
    # values in [0, 1], the range of the min-max normalised spectrograms
    x = np.random.default_rng(3).uniform(size=(2, 3) + in_hw).astype(np.float32)
    want = np.asarray(jax_resize.resize_bilinear(jnp.asarray(x), *out_hw))
    got = port_resize.resize_bilinear(torch.from_numpy(x), *out_hw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
