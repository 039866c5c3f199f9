"""Kernel B1's plan, packed constants and numerics, on the CPU.

The CUDA kernel itself runs only on the card (`chip_smoke.py`); what
surrounds it is checked here:
  * `frontend_plan`: every frame covered once, a channel's blocks in one
    cluster, one wave at B·C ≤ 32 on 132 SMs, shared memory within a
    block's limit, frames per block a multiple of 16 (the blocks laid out
    as the kernel maps them); the plans at L = 7782 unchanged; a channel
    of more than 2,048 frames (L = 100,000) in the two-pass form;
  * the constants: in float64 the interleaved, bin-limited basis and the
    sparse bank give `mel_spectrogram`'s dense result to 1e-12, the bins
    outside the read range carry no weight, and the packed buffer holds
    the basis in the kernel's mma fragment order and the bank's table;
  * the numerics of the kernel's design: a numpy emulation of its DFT in
    three bf16 pieces a side (bf16 rounding by bit operations on a uint32
    view), sparse mel product and min-max,
    read from the packed buffer as the kernel reads it, is as close to
    float64 as the plain fp32 version (within 1e-5 more), and within 1e-5
    of float64 on noisy inputs;
  * the strided waveform the wrapper takes: a time-of-flight cut (a view)
    gives what its contiguous copy gives.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from audiodepth_tpu_torch.configs import load_config
from audiodepth_tpu_torch.data.frontend import make_frontend
from audiodepth_tpu_torch.data.synthetic import SyntheticEchoDataset
from audiodepth_tpu_torch.ops import stft
from audiodepth_tpu_torch.ops.cuda import fused_frontend as ff

N_SM = 132
# clusters of s blocks (one block an SM) that an H100 SXM runs at once:
# cudaOccupancyMaxActiveClusters for B1 on an H100 80GB HBM3 (700 W), as
# chip_smoke.py prints it (its b1_plan line)
H100_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15,
                 **{s: 9 if s == 9 else 7 for s in range(9, 17)}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread, the cores left to other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


def _blocks(plan):
    """{channel: [(cluster, first frame, end frame)]} as the kernel maps its
    blocks (csrc/fused_frontend.cu: ch, f_begin, f_end)."""
    out = {}
    for i in range(plan.blocks):
        cluster, rank = divmod(i, plan.cluster_size)
        ch = cluster * plan.channels_per_cluster + rank // plan.blocks_per_channel
        f0 = (rank % plan.blocks_per_channel) * plan.frames_per_block
        out.setdefault(ch, []).append((cluster, f0, f0 + plan.frames_per_block))
    return out


@pytest.mark.parametrize("bc", [2, 8, 32, 64])
@pytest.mark.parametrize("length", [7782, 4000, 300])
def test_frontend_plan(bc, length):
    plan = ff.frontend_plan(bc, length, N_SM, H100_CLUSTERS)
    t_frames = stft.num_frames(length, 32)
    assert plan.frames_per_block % 16 == 0
    assert plan.cluster_size == plan.blocks_per_channel * plan.channels_per_cluster
    assert plan.cluster_size <= ff.MAX_CLUSTER
    assert plan.smem_bytes == ff.smem_bytes(plan.frames_per_block, 32, ff.frontend_constants())
    assert plan.smem_bytes <= 232_448 - ff.SMEM_STATIC
    blocks = _blocks(plan)
    for ch in range(bc):
        spans = blocks[ch]
        assert len({cluster for cluster, _, _ in spans}) == 1  # one cluster a channel
        frames = np.zeros(t_frames, int)
        for _, f0, f1 in spans:
            assert f0 < t_frames  # every block has frames
            frames[f0:min(f1, t_frames)] += 1
        assert (frames == 1).all()  # every frame exactly once
    assert set(blocks) >= set(range(bc))
    assert plan.n_clusters <= plan.waves * H100_CLUSTERS[plan.cluster_size]
    assert plan.blocks <= plan.waves * N_SM
    if bc <= 32:
        assert plan.waves == 1


@pytest.mark.parametrize("bc,fpb,nb,size", [(2, 16, 16, 16), (8, 32, 8, 8), (32, 96, 3, 6)])
def test_frontend_plan_main_shapes(bc, fpb, nb, size):
    """The serving and training shapes (L = 7782, T = 244): one wave, the
    fewest frames a block. At B·C = 32 four blocks of 64 frames a channel
    would take 128 SMs in clusters of 4 or 8, more than the 120 that 30 or
    15 such clusters hold, so three blocks of 96 frames (two channels a
    cluster of 6, 96 SMs). Without clusters above 8 the small batches take
    8 blocks of 32 frames a channel."""
    plan = ff.frontend_plan(bc, 7782, N_SM, H100_CLUSTERS)
    assert (plan.frames_per_block, plan.blocks_per_channel, plan.cluster_size,
            plan.waves) == (fpb, nb, size, 1)
    portable = {s: n for s, n in H100_CLUSTERS.items() if s <= 8}
    plan = ff.frontend_plan(bc, 7782, N_SM, portable)
    assert plan.waves == 1 and plan.cluster_size <= 8
    assert plan.frames_per_block == (32 if bc <= 8 else 96)


def test_frontend_plan_smem_and_limits():
    consts = ff.frontend_constants()
    # 180,448 B of constants + 4,736 of segment + 29,824 of magnitudes + 8,192 of log-mel
    assert consts.nbytes == 180_448
    assert ff.smem_bytes(64, 32, consts) == 180_448 + 4_736 + 29_824 + 8_192
    # a long channel runs several tiles a block; one too long for 16 blocks
    # takes the two-pass form, whose blocks span clusters
    plan = ff.frontend_plan(64, 7782, N_SM, H100_CLUSTERS)
    assert plan.frames_per_block == 128 and plan.waves == 1 and not plan.two_pass
    plan = ff.frontend_plan(2, 400_000, N_SM, H100_CLUSTERS)
    assert plan.two_pass and plan.blocks_per_channel > ff.MAX_CLUSTER
    assert plan.smem_bytes <= ff.MAX_DYNAMIC_SMEM


@pytest.mark.parametrize("bc,plan", [
    (2, ff.FrontendPlan(16, 16, 1, 16, 2, 1, 199_840)),
    (8, ff.FrontendPlan(32, 8, 1, 8, 8, 1, 219_104)),
    (32, ff.FrontendPlan(96, 3, 2, 6, 16, 1, 227_296)),
])
def test_frontend_plan_at_7782_unchanged(bc, plan):
    """The serving and training shapes plan as before the two-pass form."""
    assert ff.frontend_plan(bc, 7782, N_SM, H100_CLUSTERS) == plan
    assert not plan.two_pass


@pytest.mark.parametrize("bc", [2, 8, 32])
def test_frontend_plan_two_pass_at_100000(bc):
    """L = 100,000 (3,126 frames, more than 16 blocks of 128): the two-pass
    form. Block i takes frames (i % nb)·F .. of channel i // nb, every frame
    of every channel once, whatever cluster holds it; the grid is whole
    clusters of a size the card runs, in the fewest waves."""
    length = 100_000
    t_frames = stft.num_frames(length, 32)
    plan = ff.frontend_plan(bc, length, N_SM, H100_CLUSTERS)
    assert plan.two_pass and plan.channels_per_cluster == 0
    assert plan.blocks_per_channel > ff.MAX_CLUSTER and plan.frames_per_block % 16 == 0
    assert plan.smem_bytes == ff.smem_bytes(plan.frames_per_block, 32, ff.frontend_constants())
    assert plan.smem_bytes <= ff.MAX_DYNAMIC_SMEM
    nb, fpb = plan.blocks_per_channel, plan.frames_per_block
    frames = np.zeros((bc, t_frames), int)
    for i in range(plan.blocks):
        ch, part = divmod(i, nb)
        if ch < bc:
            assert part * fpb < t_frames  # every block has frames
            frames[ch, part * fpb:min((part + 1) * fpb, t_frames)] += 1
        else:  # the last cluster's spare blocks still have frames to wait on
            assert part * fpb < t_frames
    assert (frames == 1).all()
    assert plan.n_clusters <= plan.waves * H100_CLUSTERS[plan.cluster_size]
    assert plan.blocks <= plan.waves * N_SM
    if bc == 2:
        assert plan == ff.FrontendPlan(48, 66, 0, 2, 66, 1, 221_152, True)


def _reference_parts(dtype):
    fb = stft.mel_filterbank(257, 32, 44100, 20.0, 20000.0, dtype=dtype)
    first, n_bins, starts, lengths, weights = ff.sparse_mel_bank(fb)
    basis = ff.interleaved_basis(512, 64, first, n_bins, dtype)
    return fb, first, n_bins, starts, lengths, weights, basis


def _frames(wave, hop=32, win=64):
    """[..., L] → [..., T, win]: frame t, tap m is sample t·hop − win/2 + m,
    reflected at both ends without the edge repeated (the kernel's
    reflect_index)."""
    length = wave.shape[-1]
    t = np.arange(stft.num_frames(length, hop))[:, None]
    s = t * hop - win // 2 + np.arange(win)[None, :]
    s = np.where(s < 0, -s, s)
    s = np.where(s >= length, 2 * (length - 1) - s, s)
    return wave[..., s]


def _sparse_mel(mag, starts, lengths, weights, first):
    """Σ over each filter's bins, in bin order, of mag[..., bin] · weight
    (mag [..., T, n_bins] from `first`) → [..., n_mels, T]."""
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    out = np.zeros(mag.shape[:-1] + (len(starts),), mag.dtype)
    for j, (s, n, o) in enumerate(zip(starts, lengths, offsets)):
        for k in range(n):
            out[..., j] += mag[..., s - first + k] * weights[o + k]
    return np.swapaxes(out, -1, -2)


def test_constants_reproduce_dense_mel_f64():
    fb, first, n_bins, starts, lengths, weights, basis = _reference_parts(np.float64)
    assert (first, n_bins, int(lengths.sum())) == (1, 232, 439)
    # no filter reads a bin outside first .. first + n_bins − 1
    assert not fb[:first].any() and not fb[first + n_bins:].any()
    assert int((fb != 0).sum()) == int(lengths.sum())
    wave = np.random.default_rng(0).normal(size=(2, 2, 2000))
    spec = _frames(wave) @ basis                        # [.., T, 2·n_bins]
    mag = np.sqrt(spec[..., 0::2] ** 2 + spec[..., 1::2] ** 2)
    got = _sparse_mel(mag, starts, lengths, weights, first)
    want = stft.mel_spectrogram(torch.from_numpy(wave), dtype=torch.float64).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


def _unpack(consts):
    """(B pieces [3, TAPS, 8·n_ntiles] as float64, starts, lengths, offsets,
    weights) read back from the packed buffer the way the kernel reads it:
    lane l's words of n-tile nt hold rows 16s + 2t (+1 in the high half)
    and 16s + 2t + 8 (+1) of column 8·nt + l // 4, t = l % 4."""
    n = consts.n_ntiles
    words = consts.packed[:n * 768].reshape(n, 768)
    w12 = words[:, :512].reshape(n, 4, 32, 4)
    w3 = words[:, 512:].reshape(n, 2, 32, 4)
    pieces = np.full((3, ff.TAPS, 8 * n), np.nan)

    def put(piece, s, lane, word, high_rows):
        row = 16 * s + 2 * (lane % 4) + (8 if high_rows else 0)
        cols = 8 * np.arange(n) + lane // 4
        for half in (0, 1):
            bits = ((word >> np.uint32(16 * half)) & np.uint32(0xFFFF)) << np.uint32(16)
            pieces[piece, row + half, cols] = bits.astype(np.uint32).view(np.float32)

    for lane in range(32):
        for s in range(4):
            for q, (piece, high) in enumerate(((0, False), (0, True), (1, False), (1, True))):
                put(piece, s, lane, w12[:, s, lane, q], high)
            sp, h = divmod(s, 2)
            put(2, s, lane, w3[:, sp, lane, 2 * h], False)
            put(2, s, lane, w3[:, sp, lane, 2 * h + 1], True)
    table = consts.packed[consts.table_off:consts.weight_off].view(np.int32).reshape(-1, 4)
    weights = consts.packed[consts.weight_off:].view(np.float32)
    return pieces, table[:, 0] + consts.first_bin, table[:, 1], table[:, 2], weights


def test_packed_constants_layout():
    consts = ff.frontend_constants()
    fb, first, n_bins, starts, lengths, weights, basis = _reference_parts(np.float64)
    pieces, p_starts, p_lengths, p_offsets, p_weights = _unpack(consts)
    assert not np.isnan(pieces).any()  # every entry written exactly by the fragment map
    assert consts.n_ntiles == 58 and not pieces[:, :, 2 * n_bins:].any()
    # each piece is a bf16 value; the three sum to the float64 basis within 2^-26
    assert not (pieces.astype(np.float32).view(np.uint32) & 0xFFFF).any()
    total = pieces.sum(axis=0)[:64, :2 * n_bins]
    assert (np.abs(total - basis) <= 2.0 ** -26 * np.abs(basis)).all()
    # cos / −sin of bin first + i in columns 2i / 2i + 1
    full = stft.stft_basis(512, 64, np.float64)
    np.testing.assert_allclose(total[:, 10], full[:, first + 5], rtol=2.0 ** -26, atol=0)
    np.testing.assert_allclose(total[:, 11], full[:, 257 + first + 5], rtol=2.0 ** -26, atol=0)
    assert np.array_equal(p_starts, starts) and np.array_equal(p_lengths, lengths)
    fb32 = stft.mel_filterbank(257, 32, 44100, 20.0, 20000.0)
    for j in range(32):  # the float32 bank's bits, as the plain version's
        np.testing.assert_array_equal(p_weights[p_offsets[j]:p_offsets[j] + p_lengths[j]],
                                      fb32[starts[j]:starts[j] + lengths[j], j])


# ---- numerics -----------------------------------------------------------------


def _bf16(x):
    """float32 → the nearest bf16 (ties to even), as float32 (the kernel's
    __floats2bfloat162_rn)."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x7FFF) + ((u >> 16) & 1)) & np.uint32(0xFFFF0000)).view(np.float32)


def _split3(x):
    """x = p1 + p2 + p3 in float32 arithmetic, as the kernel splits A."""
    p1 = _bf16(x)
    r = (x - p1).astype(np.float32)
    p2 = _bf16(r)
    return p1, p2, _bf16((r - p2).astype(np.float32))


def emulate_b1(wave):
    """[BC, L] float32 → [BC, 32, T] as kernel B1 computes it: per k-step of
    16 taps, six products of the bf16 pieces (a3·b1, a1·b3, a2·b2, a2·b1,
    a1·b2, a1·b1; exact products, each sum rounded once to fp32) in a fresh
    accumulator added to the fp32 one; the magnitude in fp32; each filter's
    non-zeros by fp32 FMA in bin order; log, min-max."""
    consts = ff.frontend_constants()
    pieces, starts, lengths, offsets, weights = _unpack(consts)
    f32, f64 = np.float32, np.float64
    a = _split3(_frames(wave.astype(f32)))
    b = pieces[:, :64]
    acc = np.zeros(a[0].shape[:-1] + (b.shape[-1],), f32)
    for s in range(4):
        k = slice(16 * s, 16 * s + 16)
        d = np.zeros_like(acc)
        for i, j in ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0)):
            d = (d.astype(f64) + a[i][..., k].astype(f64) @ b[j][k]).astype(f32)
        acc = acc + d
    re, im = acc[..., 0::2], acc[..., 1::2]
    mag = np.sqrt(re * re + im * im)
    mel = np.zeros(mag.shape[:-1] + (32,), f32)
    for j in range(32):
        for i in range(lengths[j]):
            m = mag[..., starts[j] - consts.first_bin + i].astype(f64)
            prod = m * f64(weights[offsets[j] + i])
            mel[..., j] = (mel[..., j].astype(f64) + prod).astype(f32)  # one rounding: an FMA
    x = np.log(mel + f32(1e-8))
    lo = x.min(axis=(-2, -1), keepdims=True)
    rng = x.max(axis=(-2, -1), keepdims=True) - lo
    safe = np.where(rng > 0, rng, f32(1))
    return np.swapaxes(np.where(rng > 0, (x - lo) / safe, f32(0)), -1, -2)


def _chirp():
    t = np.arange(256, dtype=np.float32)
    return np.sin(2 * np.pi * (0.01 + 0.0008 * t) * t) * np.hanning(256).astype(np.float32)


def _inputs(kind, length=7782):
    rng = np.random.default_rng(5)
    if kind == "noise":
        return (rng.standard_normal((2, length)) * 0.05).astype(np.float32)
    if kind == "synthetic echo":  # the train path's own data, cut to the time of flight
        ds = SyntheticEchoDataset(load_config("synthetic", "train"), num_samples=1)
        return ds.sample(0)["waveform"][:, :length]
    wave = np.zeros((2, length), np.float32)  # clean chirps: two echoes, no noise
    for ch, delays in enumerate(((900, 3100), (1500, 5200))):
        for amp, d in zip((1.0, 0.5), delays):
            wave[ch, d:d + 256] += amp * _chirp()
    return wave


@pytest.mark.parametrize("kind", ["noise", "synthetic echo", "clean chirps"])
def test_bf16x3_numerics(kind):
    wave = _inputs(kind)
    want = ff.log_minmax_per_channel(stft.mel_spectrogram(
        torch.from_numpy(wave.astype(np.float64))[None], dtype=torch.float64))[0].numpy()
    plain = ff.fused_mel_frontend_plain(torch.from_numpy(wave)[None])[0].numpy()
    got = emulate_b1(wave)
    assert got.shape == want.shape == (2, 32, 244)
    plain_err = float(np.abs(plain - want).max())
    err = float(np.abs(got - want).max())
    assert err <= plain_err + 1e-5, (err, plain_err)
    if kind != "clean chirps":
        assert err <= 1e-5, err


# ---- strided waveforms --------------------------------------------------------


def test_wave_strides_of_a_cut_view():
    full = torch.from_numpy(np.random.default_rng(1).normal(size=(3, 2, 8038)).astype(np.float32))
    cut = full[..., :7782]
    assert not cut.is_contiguous()
    assert ff.wave_strides(cut) == (2 * 8038, 8038, 2)
    assert ff.wave_strides(cut.contiguous()) == (2 * 7782, 7782, 2)
    with pytest.raises(ValueError, match="last axis"):
        ff.wave_strides(full[..., ::2])
    before = ff.fused_mel_frontend.launches
    got = ff.fused_mel_frontend(cut)
    assert torch.equal(got, ff.fused_mel_frontend(cut.contiguous()))
    assert ff.fused_mel_frontend.launches == before


def test_make_frontend_keeps_the_cut_a_view():
    """The train path's synthetic rows (8038 samples) through `make_frontend`
    equal the same rows cut and copied first."""
    cfg = load_config("synthetic", "train")
    ds = SyntheticEchoDataset(cfg, num_samples=2)
    wave = np.stack([ds.sample(i)["waveform"] for i in range(2)])
    assert wave.shape == (2, 2, 8038)
    frontend = make_frontend(cfg)
    got = frontend(torch.from_numpy(wave))
    want = frontend(torch.from_numpy(np.ascontiguousarray(wave[..., :7782])))
    assert got.shape == (2, 256, 256, 2)
    assert torch.equal(got, want)
