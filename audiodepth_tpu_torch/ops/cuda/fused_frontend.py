"""Fused mel front end: wrapper of the CUDA kernel `csrc/fused_frontend.cu`
(kernel B1), its launch plan, its packed constants and its plain PyTorch
version (port of `ops/pallas/fused_frontend.py`).

[B, C, L] float32 waveform → [B, C, n_mels, T] log-mel, min-max normalised
per channel: `mel_spectrogram` + `log_minmax_per_channel` in one kernel,
with the reflect pad and the frame gather folded into it.

`frontend_plan` (pure Python, tested on the CPU) decides how a call runs:
frames per block, blocks per channel, channels per cluster and the cluster
size, so that the call fits in one wave of clusters where it can. A channel
longer than 16 blocks of 128 frames (2,048 frames, L > 65,535 at hop 32)
takes the two-pass form: raw log-mel and per-block (min, max) from the
clusters, then a second kernel that normalises each channel (see
`csrc/fused_frontend.cu`, "Long inputs").
`frontend_constants` packs what every block copies into its shared memory:
the windowed DFT basis for the bins the mel bank reads, each bin's cos and
−sin columns interleaved, as three bf16 pieces in the kernel's mma fragment
order, then the bank's filters as (first bin, length, weights).

The wrapper takes the plain version only for a tensor that lies on the CPU.
A CUDA tensor goes to the kernel, or the wrapper raises.

`audiodepth::fused_mel_frontend` is the same function as a registered
PyTorch op, which the front end calls, so that `torch.export` can trace it:
its CUDA implementation is the wrapper (the kernel, counted), its CPU
implementation the plain version, and its fake gives the output's shape
without touching the library or the card. The ops are registered when
this module is imported; a saved `.pt2` that holds the op loads only after
that import.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from dataclasses import dataclass
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from ..stft import (log_minmax_per_channel, mel_filterbank, mel_spectrogram, num_frames,
                    stft_basis)

# the TPU kernel this one replaces (file:line of `_frontend_kernel`)
REPLACES = "audiodepth_tpu/ops/pallas/fused_frontend.py:39"
SOURCE = "audiodepth_tpu_torch/csrc/fused_frontend.cu"

# the kernel's compile-time shape (csrc/fused_frontend.cu: kTaps, kTile, ...)
TAPS = 64          # K of the DFT product: window taps, zero-padded
TILE = 32          # frames a block computes at once (two m-tiles of 16)
FRAME_STEP = 16    # frames per block is a multiple of the mma's M
MAX_CLUSTER = 16   # the largest cluster; above 8 it is the non-portable size
PORTABLE_CLUSTER = 8
# a block may take 227 KB of shared memory, less the kernel's static part (< 1 KB)
SMEM_PER_BLOCK = 232_448
SMEM_STATIC = 1024
MAX_DYNAMIC_SMEM = SMEM_PER_BLOCK - SMEM_STATIC


def fused_mel_frontend_plain(waveform: torch.Tensor, n_fft: int = 512,
                             win_length: int = 64, hop_length: int = 32,
                             n_mels: int = 32, sample_rate: int = 44100,
                             f_min: float = 20.0, f_max: float = 20000.0) -> torch.Tensor:
    """The plain PyTorch version: mel_spectrogram + log_minmax_per_channel."""
    mel = mel_spectrogram(waveform, n_fft=n_fft, win_length=win_length,
                          hop_length=hop_length, n_mels=n_mels,
                          sample_rate=sample_rate, f_min=f_min, f_max=f_max,
                          dtype=torch.float32)
    return log_minmax_per_channel(mel)


# ---- constants ----------------------------------------------------------------


def sparse_mel_bank(fb: np.ndarray) -> Tuple[int, int, np.ndarray, np.ndarray, np.ndarray]:
    """(first bin, bin count, starts, lengths, weights) of a filterbank
    [n_freq, n_mels]: the bins any filter reads are first .. first + count − 1;
    filter j spans bins starts[j] .. starts[j] + lengths[j] − 1 (its first to
    its last non-zero, so a triangle's bins), and its weights are
    weights[offsets[j] : offsets[j] + lengths[j]] with offsets the running
    sum of lengths."""
    n_freq, n_mels = fb.shape
    starts = np.zeros(n_mels, np.int64)
    lengths = np.zeros(n_mels, np.int64)
    for j in range(n_mels):
        nz = np.nonzero(fb[:, j])[0]
        if nz.size:
            starts[j], lengths[j] = nz[0], nz[-1] - nz[0] + 1
    read = lengths > 0
    first = int(starts[read].min()) if read.any() else 0
    last = int((starts + lengths)[read].max()) if read.any() else 1
    weights = np.concatenate([fb[s:s + n, j] for j, (s, n) in enumerate(zip(starts, lengths))]
                             + [np.zeros(0, fb.dtype)])
    return first, last - first, np.where(read, starts, first), lengths, weights


def interleaved_basis(n_fft: int, win_length: int, first_bin: int, n_bins: int,
                      dtype=np.float32) -> np.ndarray:
    """`stft_basis` [win, 2·n_freq] (cos block | −sin block) cut to bins
    first_bin .. first_bin + n_bins − 1 and interleaved: column 2i is bin
    first_bin + i's cos, column 2i + 1 its −sin."""
    n_freq = n_fft // 2 + 1
    full = stft_basis(n_fft, win_length, dtype)
    out = np.empty((win_length, 2 * n_bins), full.dtype)
    out[:, 0::2] = full[:, first_bin:first_bin + n_bins]
    out[:, 1::2] = full[:, n_freq + first_bin:n_freq + first_bin + n_bins]
    return out


def bf16_pieces(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Three float32 arrays of bf16 values (8 significant bits each, rounded
    to nearest even) whose sum is float64 x to 2^-26 of |x|."""
    pieces, rest = [], np.asarray(x, np.float64)
    for _ in range(3):
        m, e = np.frexp(rest)
        piece = np.ldexp(np.round(m * 256) / 256, e)
        pieces.append(piece.astype(np.float32))  # exact: 8 significant bits
        rest = rest - piece
    return tuple(pieces)


def fragment_order(basis: np.ndarray) -> np.ndarray:
    """float64 [win, cols] → uint32 [n_ntiles, 768], zero-padded to TAPS
    rows and a multiple of 8 columns, in the kernel's B-fragment order of
    mma.m16n8k16 (bf16): lane l holds b0 = rows 16s + 2t, 16s + 2t + 1 and
    b1 = rows 16s + 2t + 8, + 9 of column 8·nt + l // 4 (t = l % 4), the
    lower row in the low half. Per n-tile: [k-step s][lane] words (b0, b1
    of piece 1, b0, b1 of piece 2), then [pair of k-steps][lane] words (b0,
    b1 of piece 3 at step 2·sp, then at 2·sp + 1): each a lane's 16-byte
    load, a warp's 512 contiguous bytes."""
    win, cols = basis.shape
    n_ntiles = -(-cols // 8)
    full = np.zeros((TAPS, 8 * n_ntiles), np.float64)
    full[:win, :cols] = basis
    bits = [p.view(np.uint32) >> np.uint32(16) for p in bf16_pieces(full)]
    nt, s, lane = np.ix_(np.arange(n_ntiles), np.arange(TAPS // 16), np.arange(32))
    col, row = 8 * nt + lane // 4, 16 * s + 2 * (lane % 4)

    def word(p, r):
        return p[r, col] | (p[r + 1, col] << np.uint32(16))

    w12 = np.stack([word(bits[0], row), word(bits[0], row + 8),
                    word(bits[1], row), word(bits[1], row + 8)], axis=-1)
    b0, b1 = word(bits[2], row), word(bits[2], row + 8)
    w3 = np.stack([b0[:, 0::2], b1[:, 0::2], b0[:, 1::2], b1[:, 1::2]], axis=-1)
    return np.concatenate([w12.reshape(n_ntiles, -1), w3.reshape(n_ntiles, -1)], axis=1)


@dataclass(frozen=True)
class Constants:
    """The buffer every block of B1 copies into shared memory, in 4-byte
    words: the fragment-ordered basis pieces (n_ntiles·768 words), the
    filter table at `table_off` (int32 rows of first bin relative to
    `first_bin`, length, weights offset, 0) and the float32 weights at
    `weight_off`."""

    packed: np.ndarray  # uint32
    first_bin: int
    n_bins: int
    n_ntiles: int
    n_mels: int
    nnz: int            # the bank's weights the kernel reads
    table_off: int
    weight_off: int

    @property
    def nbytes(self) -> int:
        return 4 * self.packed.size


def _pad4(a: np.ndarray) -> np.ndarray:
    return np.concatenate([a, np.zeros(-a.size % 4, a.dtype)])


@functools.lru_cache(maxsize=16)
def frontend_constants(n_fft: int = 512, win_length: int = 64, n_mels: int = 32,
                       sample_rate: int = 44100, f_min: float = 20.0,
                       f_max: float = 20000.0) -> Constants:
    """B1's packed constants: the float64 basis in three bf16 pieces, and
    the float32 bank (the plain version's bits) as a sparse table."""
    fb = mel_filterbank(n_fft // 2 + 1, n_mels, sample_rate, f_min, f_max, dtype=np.float32)
    first, n_bins, starts, lengths, weights = sparse_mel_bank(fb)
    basis = fragment_order(interleaved_basis(n_fft, win_length, first, n_bins, np.float64))
    table = np.zeros((n_mels, 4), np.int32)
    table[:, 0] = starts - first
    table[:, 1] = lengths
    table[:, 2] = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    parts = [basis.reshape(-1), table.reshape(-1).view(np.uint32),
             _pad4(weights.astype(np.float32)).view(np.uint32)]
    return Constants(packed=np.concatenate(parts), first_bin=first, n_bins=n_bins,
                     n_ntiles=basis.shape[0], n_mels=n_mels, nnz=int(lengths.sum()),
                     table_off=parts[0].size, weight_off=parts[0].size + parts[1].size)


# ---- the plan -------------------------------------------------------------------


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def smem_bytes(frames_per_block: int, hop_length: int, consts: Constants) -> int:
    """Dynamic shared memory of one block (csrc/fused_frontend.cu:
    SmemLayout): the constants, the tile's waveform segment (4 floats of
    padding after every 32 samples), its magnitudes and the block's
    log-mel."""
    tile = min(TILE, frames_per_block)
    seg_last = (tile - 1) * hop_length + TAPS - 1
    seg = 4 * (seg_last + 4 * (seg_last >> 5) + 1 + 3 & ~3)
    mag = 4 * (tile * (4 * consts.n_ntiles + 1) + 3 & ~3)
    return consts.nbytes + seg + mag + 4 * consts.n_mels * frames_per_block


@dataclass(frozen=True)
class FrontendPlan:
    """How one B1 call runs: each channel is `blocks_per_channel` blocks of
    `frames_per_block` frames in one cluster of `cluster_size` blocks, which
    holds `channels_per_cluster` channels; `n_clusters` clusters run in
    `waves` waves; each block takes `smem_bytes` of dynamic shared memory.
    With `two_pass`, a channel's blocks are consecutive in the grid and may
    span clusters (`channels_per_cluster` is 0), and a second kernel
    normalises each channel."""

    frames_per_block: int
    blocks_per_channel: int
    channels_per_cluster: int
    cluster_size: int
    n_clusters: int
    waves: int
    smem_bytes: int
    two_pass: bool = False

    @property
    def blocks(self) -> int:
        return self.n_clusters * self.cluster_size


def frontend_plan(bc: int, length: int, n_sm: int, max_active_clusters: Mapping[int, int],
                  hop_length: int = 32, consts: Optional[Constants] = None) -> FrontendPlan:
    """B1's plan for bc channels of `length` samples on a card of n_sm SMs
    that runs max_active_clusters[s] clusters of s blocks at once (a size
    it lacks is not used).

    Each wave pays the launch, the constants' copy and the cluster
    barriers, which outweigh a block's frames, so the plan takes the fewest
    waves, then the fewest frames per block, then a portable cluster (≤ 8),
    then the fewest blocks, then the fewest clusters (each cluster reads the
    constants from L2 once)."""
    consts = consts or frontend_constants()
    t_frames = num_frames(length, hop_length)
    best, best_key = None, None
    for fpb in range(FRAME_STEP, FRAME_STEP * _cdiv(t_frames, FRAME_STEP) + 1, FRAME_STEP):
        nb = _cdiv(t_frames, fpb)
        smem = smem_bytes(fpb, hop_length, consts)
        if nb > MAX_CLUSTER or smem > MAX_DYNAMIC_SMEM:
            continue
        for cpc in range(1, MAX_CLUSTER // nb + 1):
            size = nb * cpc
            cap = max_active_clusters.get(size, 0)
            if cap <= 0 or cpc > max(bc, 1):
                continue
            n_clusters = _cdiv(bc, cpc)
            waves = max(_cdiv(n_clusters, cap), _cdiv(n_clusters * size, n_sm))
            key = (waves, fpb, size > PORTABLE_CLUSTER, n_clusters * size, n_clusters)
            if best_key is None or key < best_key:
                best_key = key
                best = FrontendPlan(fpb, nb, cpc, size, n_clusters, waves, smem)
    if best is None:
        best = _two_pass_plan(bc, t_frames, n_sm, max_active_clusters, hop_length, consts)
    return best


def _two_pass_plan(bc: int, t_frames: int, n_sm: int, max_active_clusters: Mapping[int, int],
                   hop_length: int, consts: Constants) -> FrontendPlan:
    """A channel too long for one cluster: bc·nb blocks in grid order, in
    clusters of any size the card runs (they share the constants' copy),
    chosen as in the one-pass plan."""
    best, best_key = None, None
    for fpb in range(FRAME_STEP, FRAME_STEP * _cdiv(t_frames, FRAME_STEP) + 1, FRAME_STEP):
        smem = smem_bytes(fpb, hop_length, consts)
        if smem > MAX_DYNAMIC_SMEM:
            break
        nb = _cdiv(t_frames, fpb)
        for size in range(1, MAX_CLUSTER + 1):
            cap = max_active_clusters.get(size, 0)
            if cap <= 0:
                continue
            n_clusters = _cdiv(bc * nb, size)
            waves = max(_cdiv(n_clusters, cap), _cdiv(n_clusters * size, n_sm))
            key = (waves, fpb, size > PORTABLE_CLUSTER, n_clusters * size, n_clusters)
            if best_key is None or key < best_key:
                best_key = key
                best = FrontendPlan(fpb, nb, 0, size, n_clusters, waves, smem, True)
    if best is None:
        raise ValueError(f"{t_frames} frames: no plan (no cluster size the card runs, or "
                         f"{FRAME_STEP} frames exceed {MAX_DYNAMIC_SMEM} B of shared memory)")
    return best


# ---- the wrapper ----------------------------------------------------------------


def check_waveform(waveform: torch.Tensor, n_fft: int) -> Tuple[int, int, int]:
    """(B, C, L) of a float32 [B, C, L] waveform long enough to reflect-pad."""
    if waveform.dim() != 3:
        raise ValueError(f"waveform must be [B, C, L], got {tuple(waveform.shape)}")
    if waveform.dtype != torch.float32:
        raise TypeError(f"waveform must be float32, got {waveform.dtype}")
    b, c, length = waveform.shape
    if length <= n_fft // 2:
        raise ValueError(f"reflect padding of {n_fft // 2} needs L > {n_fft // 2}, got {length}")
    return b, c, length


def wave_strides(waveform: torch.Tensor) -> Tuple[int, int, int]:
    """(batch stride, channel stride, C) in elements of a [B, C, L] waveform
    whose last axis is contiguous (any row strides: a time-of-flight cut
    stays a view); channel i of B·C lies at (i // C)·stride_b + (i % C)·stride_c."""
    if waveform.shape[-1] > 1 and waveform.stride(-1) != 1:
        raise ValueError(f"the waveform's last axis must be contiguous, got strides "
                         f"{tuple(waveform.stride())}")
    return waveform.stride(0), waveform.stride(1), waveform.shape[1]


@functools.lru_cache(maxsize=16)
def _device_constants(device: torch.device, *args) -> torch.Tensor:
    """`frontend_constants(*args)` on the card, built once."""
    return torch.from_numpy(frontend_constants(*args).packed.view(np.int32)).to(device)


class FusedMelFrontend:
    """Callable wrapper of kernel B1; `launches` counts kernel launches: one
    for a one-pass call, two for a two-pass call (the clusters, then the
    normalising pass); `variant_launches` counts calls by form ("one_pass",
    "two_pass")."""

    name = "fused_mel_frontend"

    def __init__(self, library=None):
        self.launches = 0
        self.variant_launches = Counter()
        self._library = library or _library  # a callable giving the loaded library

    def __call__(self, waveform: torch.Tensor, n_fft: int = 512,
                 win_length: int = 64, hop_length: int = 32, n_mels: int = 32,
                 sample_rate: int = 44100, f_min: float = 20.0,
                 f_max: float = 20000.0) -> torch.Tensor:
        b, c, length = check_waveform(waveform, n_fft)
        if waveform.device.type == "cpu":
            return fused_mel_frontend_plain(waveform, n_fft, win_length, hop_length,
                                            n_mels, sample_rate, f_min, f_max)
        if waveform.device.type != "cuda":
            raise ValueError(f"unsupported device {waveform.device}")
        if win_length > TAPS or win_length % 8 or win_length > n_fft:
            raise ValueError(f"the kernel takes win_length a multiple of 8 up to {TAPS} "
                             f"(and at most n_fft), got {win_length}")
        stride_b, stride_c, n_c = wave_strides(waveform)
        t_frames = num_frames(length, hop_length)
        dev = waveform.device
        out = torch.empty((b, c, n_mels, t_frames), dtype=torch.float32, device=dev)
        if b * c == 0:
            return out
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        args = (n_fft, win_length, n_mels, sample_rate, float(f_min), float(f_max))
        consts = frontend_constants(*args)
        packed = _device_constants(torch.device("cuda", index), *args)
        plan = _device_plan(index, b * c, length, hop_length, args)
        lib = self._library()
        minmax = (torch.empty((b * c, plan.blocks_per_channel, 2), dtype=torch.float32,
                              device=dev) if plan.two_pass else None)
        err = lib.adepth_fused_mel_frontend(
            waveform.data_ptr(), stride_b, stride_c, n_c, packed.data_ptr(), consts.nbytes,
            consts.table_off, consts.weight_off, consts.n_ntiles, n_mels, out.data_ptr(),
            b * c, length, t_frames, hop_length, (n_fft - win_length) // 2 - n_fft // 2,
            plan.frames_per_block, plan.blocks_per_channel, plan.cluster_size,
            plan.n_clusters, plan.smem_bytes, None if minmax is None else minmax.data_ptr(),
            index, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError("fused_mel_frontend launch failed: "
                               + lib.adepth_cuda_error_string(err).decode())
        self.launches += 2 if plan.two_pass else 1
        self.variant_launches["two_pass" if plan.two_pass else "one_pass"] += 1
        return out


@functools.lru_cache(maxsize=256)
def _device_plan(index: int, bc: int, length: int, hop_length: int, args) -> FrontendPlan:
    """`frontend_plan` for card `index`, worked out once per shape."""
    return frontend_plan(bc, length, torch.cuda.get_device_properties(index).multi_processor_count,
                         cluster_capacity(index), hop_length, frontend_constants(*args))


@functools.lru_cache(maxsize=None)
def cluster_capacity(device_index: int) -> Mapping[int, int]:
    """{cluster size: clusters the card runs at once} for B1 at its largest
    shared memory (one block an SM), asked of the card once. A size above
    the portable 8 that the card refuses gets 0."""
    lib = _library()
    caps = {}
    for size in range(1, MAX_CLUSTER + 1):
        count = ctypes.c_int(0)
        err = lib.adepth_fused_mel_max_active_clusters(size, MAX_DYNAMIC_SMEM, device_index,
                                                       ctypes.byref(count))
        if err != 0 and size <= PORTABLE_CLUSTER:
            raise RuntimeError(f"cudaOccupancyMaxActiveClusters({size}) failed: "
                               + lib.adepth_cuda_error_string(err).decode())
        caps[size] = count.value if err == 0 else 0
    return caps


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from ._build import load

    return bind(load("fused_frontend"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points of a library built from
    `csrc/fused_frontend.cu` on it."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.adepth_fused_mel_max_active_clusters.argtypes = [i, i, i, ctypes.POINTER(i)]
    lib.adepth_fused_mel_max_active_clusters.restype = i
    lib.adepth_fused_mel_frontend.argtypes = [p, ll, ll, i, p, i, i, i, i, i, p, i, i, i, i, i,
                                              i, i, i, i, ll, p, i, p]
    lib.adepth_fused_mel_frontend.restype = i
    lib.adepth_cuda_error_string.argtypes = [i]
    lib.adepth_cuda_error_string.restype = ctypes.c_char_p
    return lib


fused_mel_frontend = FusedMelFrontend()


# ---- the registered op ----------------------------------------------------------


@torch.library.custom_op("audiodepth::fused_mel_frontend", mutates_args=(), device_types="cuda")
def fused_mel_frontend_op(waveform: torch.Tensor, n_fft: int = 512, win_length: int = 64,
                          hop_length: int = 32, n_mels: int = 32, sample_rate: int = 44100,
                          f_min: float = 20.0, f_max: float = 20000.0) -> torch.Tensor:
    """B1 as a PyTorch op; on a CUDA tensor, the kernel through `fused_mel_frontend`."""
    return fused_mel_frontend(waveform, n_fft, win_length, hop_length, n_mels, sample_rate,
                              f_min, f_max)


@fused_mel_frontend_op.register_kernel("cpu")
def _fused_mel_frontend_cpu(waveform, n_fft=512, win_length=64, hop_length=32, n_mels=32,
                            sample_rate=44100, f_min=20.0, f_max=20000.0):
    check_waveform(waveform, n_fft)
    # contiguous, as the kernel writes it (the fake's strides)
    return fused_mel_frontend_plain(waveform, n_fft, win_length, hop_length, n_mels,
                                    sample_rate, f_min, f_max).contiguous()


@fused_mel_frontend_op.register_fake
def _fused_mel_frontend_fake(waveform, n_fft=512, win_length=64, hop_length=32, n_mels=32,
                             sample_rate=44100, f_min=20.0, f_max=20000.0):
    b, c, length = check_waveform(waveform, n_fft)
    return waveform.new_empty((b, c, n_mels, num_frames(length, hop_length)))
