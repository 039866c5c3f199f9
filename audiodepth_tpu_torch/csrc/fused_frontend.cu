// Fused mel front end for Hopper (sm_90a): waveform -> log-mel, min-max
// normalised per channel, in one kernel.
//
// Replaces the TPU kernel audiodepth_tpu/ops/pallas/fused_frontend.py
// (_frontend_kernel, via fused_mel_frontend). Same function, per
// (batch*channel):
//   frames [T, win] . windowed real-DFT basis [win, 2F]   (cos | -sin)
//   magnitude sqrt(re^2 + im^2)                           [T, F]
//   . HTK mel bank [F, M]                                  [T, M]
//   log(x + 1e-8), min-max over the whole channel (0 where max == min)
//   stored as [M, T].
// The TPU wrapper reflect-padded the waveform and gathered the frames in
// XLA; here the pad and the gather are folded into the kernel: frame t,
// sample m reads source index s = t*hop + start + m (start = off - n_fft/2,
// -32 for the BatVision settings), reflected at both ends without edge
// repeat.
//
// Bound on the H100 SXM (67 TFLOP/s fp32 on the CUDA cores, 3.35 TB/s):
// per channel T*(win*2F + F*M) multiply-adds, 244*(64*514 + 257*32) ~= 10.0M
// MACs = 20.1 MFLOP at the serving shape; 32 channels (batch 16) ~= 0.64
// GFLOP ~= 9.6 us, against ~2 MB of device traffic ~= 0.6 us. So it is
// bound by fp32 operations. Both products must stay true fp32 (the output
// is held to ~1e-5), so no TF32 tensor cores: plain fp32 FMA, IEEE sqrtf,
// logf and division (no --use_fast_math).
//
// Design. The TPU ran one program per channel, sequentially, with the whole
// channel in VMEM. Here one channel is one thread-block CLUSTER of kCluster
// blocks, each on its own SM: block r computes frames
// [r*ceil(T/kCluster), ...) of the channel, and the channel's min/max is
// reduced across the cluster through distributed shared memory, so it never
// leaves the chip and no second pass or atomics are needed. A block holds
// in dynamic shared memory the basis (131,584 B), the mel bank (33,280 B,
// rows padded to 260 bins), a tile of 32 frames (8,192 B), their magnitudes
// (33,280 B) and its frames' log-mel (4,224 B at 31 frames): 210,560 B of
// the 227 KB a block may use, so one block per SM. In the STFT each thread
// owns one frequency bin for 16 frames (one basis value feeds 16 FMAs); in
// the mel product one mel for 4 frames, reading magnitudes 4 bins at a time.
// Known gaps: every block loads the 165 KB of constants from L2 (a TMA
// multicast could load them once per cluster), and at batch 16 the 32
// clusters of 8 blocks take about three waves of the 132 SMs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;    // blocks per channel (the portable cluster size)
constexpr int kTile = 32;      // frames per tile
constexpr int kBinFrames = 16; // frames per thread in the STFT
constexpr int kMelFrames = 4;  // frames per thread in the mel product
constexpr int kThreads = 576;  // 18 warps: (bin, half tile) pairs for n_freq <= 288

__host__ __device__ inline int align4(int n) { return (n + 3) & ~3; }

// Frames per block of a channel of T frames.
__host__ __device__ inline int frames_per_block(int T) { return (T + kCluster - 1) / kCluster; }

// Offsets (in floats) into dynamic shared memory. Magnitude rows and mel-bank
// rows are padded with zeros to a multiple of 4 bins (float4 reads); log-mel
// rows have an odd stride so that 32 mels written at one frame hit 32 banks.
struct SmemLayout {
  int mag_stride, logmel_stride;
  size_t basis, fb, frames, mag, logmel, total_floats;
  __host__ __device__ SmemLayout(int T, int win, int n_freq, int n_mels) {
    mag_stride = align4(n_freq);
    logmel_stride = frames_per_block(T) | 1;
    basis = 0;
    fb = basis + size_t(align4(win * 2 * n_freq));
    frames = fb + size_t(mag_stride) * n_mels;
    mag = frames + size_t(align4(kTile * win));
    logmel = mag + size_t(kTile) * mag_stride;
    total_floats = logmel + size_t(align4(n_mels * logmel_stride));
  }
};

__device__ __forceinline__ int reflect_index(int s, int L) {
  if (s < 0) s = -s;
  if (s >= L) s = 2 * (L - 1) - s;
  return s;
}

__device__ __forceinline__ void warp_minmax(float& lo, float& hi) {
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
}

// grid (kCluster, channels); cluster (kCluster, 1, 1): one cluster per channel
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
fused_mel_frontend_kernel(const float* __restrict__ wave,   // [BC, L]
                          const float* __restrict__ basis,  // [win, 2F]
                          const float* __restrict__ fb,     // [F, M]
                          float* __restrict__ out,          // [BC, M, T]
                          int L, int T, int win, int n_freq, int n_mels,
                          int hop, int start) {
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  const SmemLayout lay(T, win, n_freq, n_mels);
  float* s_basis = smem + lay.basis;
  float* s_fb = smem + lay.fb;
  float* s_frames = smem + lay.frames;
  float* s_mag = smem + lay.mag;
  float* s_logmel = smem + lay.logmel;
  __shared__ float s_warp[2][32];
  __shared__ float s_block[2];   // this block's min / max, read by the cluster
  __shared__ float s_channel[2]; // the channel's min / max

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int two_f = 2 * n_freq;
  const int ms = lay.mag_stride, ls = lay.logmel_stride, pad = ms - n_freq;
  const int per_block = frames_per_block(T);
  const int f_begin = min(T, int(blockIdx.x) * per_block);
  const int f_end = min(T, f_begin + per_block);
  const float* x = wave + size_t(blockIdx.y) * L;
  float* y = out + size_t(blockIdx.y) * n_mels * T;

  // constants, 16 bytes a thread (win % 4 == 0 and n_mels % 4 == 0)
  for (int i = tid; i < win * two_f / 4; i += blockDim.x)
    reinterpret_cast<float4*>(s_basis)[i] = __ldg(reinterpret_cast<const float4*>(basis) + i);
  for (int i = tid; i < ms * n_mels / 4; i += blockDim.x)
    reinterpret_cast<float4*>(s_fb)[i] = 4 * i < n_freq * n_mels
        ? __ldg(reinterpret_cast<const float4*>(fb) + i) : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = tid; i < kTile * pad; i += blockDim.x)  // padding bins stay 0
    s_mag[(i / pad) * ms + n_freq + i % pad] = 0.f;

  float lo = INFINITY, hi = -INFINITY;
  for (int t0 = f_begin; t0 < f_end; t0 += kTile) {
    const int nt = min(kTile, f_end - t0);
    __syncthreads();  // the previous tile's s_frames / s_mag are consumed
    for (int i = tid; i < kTile * win; i += blockDim.x) {
      const int f = i / win, m = i - f * win;
      s_frames[i] = f < nt ? __ldg(x + reflect_index((t0 + f) * hop + start + m, L)) : 0.f;
    }
    __syncthreads();

    // STFT magnitude: one (bin, group of kBinFrames frames) per thread.
    for (int item = tid; item < n_freq * (kTile / kBinFrames); item += blockDim.x) {
      const int g = item / n_freq, k = item - g * n_freq;
      const float* fr = s_frames + g * kBinFrames * win;
      float re[kBinFrames], im[kBinFrames];
#pragma unroll
      for (int f = 0; f < kBinFrames; ++f) { re[f] = 0.f; im[f] = 0.f; }
      for (int m = 0; m < win; m += 4) {
        float br[4], bi[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          br[q] = s_basis[(m + q) * two_f + k];
          bi[q] = s_basis[(m + q) * two_f + n_freq + k];
        }
#pragma unroll
        for (int f = 0; f < kBinFrames; ++f) {
          const float4 v = *reinterpret_cast<const float4*>(fr + f * win + m);
          re[f] = fmaf(v.x, br[0], re[f]); im[f] = fmaf(v.x, bi[0], im[f]);
          re[f] = fmaf(v.y, br[1], re[f]); im[f] = fmaf(v.y, bi[1], im[f]);
          re[f] = fmaf(v.z, br[2], re[f]); im[f] = fmaf(v.z, bi[2], im[f]);
          re[f] = fmaf(v.w, br[3], re[f]); im[f] = fmaf(v.w, bi[3], im[f]);
        }
      }
      float* mg = s_mag + g * kBinFrames * ms + k;
#pragma unroll
      for (int f = 0; f < kBinFrames; ++f)
        mg[f * ms] = sqrtf(re[f] * re[f] + im[f] * im[f]);
    }
    __syncthreads();

    // Mel product, log, running min/max into this block's log-mel.
    for (int item = tid; item < n_mels * (kTile / kMelFrames); item += blockDim.x) {
      const int g = item / n_mels, j = item - g * n_mels;
      const float* mg = s_mag + g * kMelFrames * ms;
      float acc[kMelFrames];
#pragma unroll
      for (int q = 0; q < kMelFrames; ++q) acc[q] = 0.f;
      for (int k = 0; k < ms; k += 4) {
        const float w0 = s_fb[(k + 0) * n_mels + j], w1 = s_fb[(k + 1) * n_mels + j];
        const float w2 = s_fb[(k + 2) * n_mels + j], w3 = s_fb[(k + 3) * n_mels + j];
#pragma unroll
        for (int q = 0; q < kMelFrames; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(mg + q * ms + k);
          acc[q] = fmaf(v.x, w0, acc[q]);
          acc[q] = fmaf(v.y, w1, acc[q]);
          acc[q] = fmaf(v.z, w2, acc[q]);
          acc[q] = fmaf(v.w, w3, acc[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < kMelFrames; ++q) {
        const int f = g * kMelFrames + q;
        if (f < nt) {
          const float v = logf(acc[q] + 1e-8f);
          s_logmel[j * ls + (t0 - f_begin) + f] = v;
          lo = fminf(lo, v);
          hi = fmaxf(hi, v);
        }
      }
    }
  }

  // This block's min / max, then the channel's across the cluster (DSMEM).
  warp_minmax(lo, hi);
  const int warp = tid >> 5, lane = tid & 31, n_warps = (blockDim.x + 31) >> 5;
  if (lane == 0) { s_warp[0][warp] = lo; s_warp[1][warp] = hi; }
  __syncthreads();
  if (warp == 0) {
    lo = lane < n_warps ? s_warp[0][lane] : INFINITY;
    hi = lane < n_warps ? s_warp[1][lane] : -INFINITY;
    warp_minmax(lo, hi);
    if (lane == 0) { s_block[0] = lo; s_block[1] = hi; }
  }
  cluster.sync();  // every block's s_block is written
  if (warp == 0) {
    const int n_blocks = int(cluster.num_blocks());
    lo = INFINITY;
    hi = -INFINITY;
    if (lane < n_blocks) {
      const float* remote = cluster.map_shared_rank(s_block, lane);
      lo = remote[0];
      hi = remote[1];
    }
    warp_minmax(lo, hi);
    if (lane == 0) { s_channel[0] = lo; s_channel[1] = hi; }
  }
  cluster.sync();  // remote reads are done before any block exits
  lo = s_channel[0];
  hi = s_channel[1];
  const float rng = hi - lo;
  const int nf = f_end - f_begin;
  for (int i = tid; i < n_mels * nf; i += blockDim.x) {
    const int j = i / nf, f = i - j * nf;
    y[size_t(j) * T + f_begin + f] = rng > 0.f ? (s_logmel[j * ls + f] - lo) / rng : 0.f;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs for a channel of T frames.
size_t adepth_fused_mel_smem_bytes(int T, int win, int n_freq, int n_mels) {
  return SmemLayout(T, win, n_freq, n_mels).total_floats * sizeof(float);
}

// Launches on `stream` of `device`; returns cudaGetLastError() (0 on
// success). The caller checks shapes: win % 4 == n_mels % 4 == 0, L > -start,
// smem within the limit.
int adepth_fused_mel_frontend(const void* wave, const void* basis, const void* fb,
                              void* out, int n_channels, int L, int T, int win,
                              int n_freq, int n_mels, int hop, int start,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = adepth_fused_mel_smem_bytes(T, win, n_freq, n_mels);
  err = cudaFuncSetAttribute(
      fused_mel_frontend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_mel_frontend_kernel<<<dim3(kCluster, n_channels), kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wave), static_cast<const float*>(basis),
      static_cast<const float*>(fb), static_cast<float*>(out), L, T, win,
      n_freq, n_mels, hop, start);
  return static_cast<int>(cudaGetLastError());
}

const char* adepth_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
