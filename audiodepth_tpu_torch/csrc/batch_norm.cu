// Train-mode BatchNorm for Hopper (sm_90a) over a bf16 channels-last
// activation, statistics in fp32: the forward (bn_fwd_*) and the backward
// (bn_bwd_*), each a C call of three kernels.
//
// Replaces no TPU kernel. On the TPU, XLA fused the casts around the
// JAX package's fp32 BatchNorm (models/layers.py) and the normalisation
// into their neighbours. Eager PyTorch runs them as separate passes: a
// bf16 -> fp32 copy of the conv's output, cuDNN's fp32 BatchNorm (which
// keeps that copy for the backward), the fp32 -> bf16 copy back, and the
// same chain reversed in the backward, about 44 bytes of device traffic an
// element. This pair reads and writes only bf16 activations and never
// writes an fp32 copy of one.
//
// Function (x is [rows, C] with rows = N*H*W, each row `ld` elements
// apart, C innermost; statistics per channel over the rows):
//   forward   mean, var = batch mean and biased variance (Welford + Chan)
//             invstd = 1 / sqrt(var + eps)
//             scale = gamma*invstd, shift = beta - mean*scale
//             y = bf16(fma(x, scale, shift)), through a ReLU where asked
//             running_mean, running_var folded in place with `momentum`
//             and the unbiased variance (not while remat recomputes)
//   backward  g = dy, zeroed where the forward's ReLU was (the same fp32
//             fma, recomputed from the saved bf16 x: the mask agrees bit
//             for bit)
//             S1 = sum g, S2 = sum g*(x - mean)
//             dbeta = S1, dgamma = S2*invstd
//             dx = bf16(c1*g + c2*(x - mean) + c3), with c1 = gamma*invstd,
//             c2 = -c1*invstd^2*S2/rows, c3 = -c1*S1/rows
//
// What bounds it on the H100 SXM: bytes. The work needs x read and y
// written once in the forward (4 B an element) and x, dy read and dx
// written once in the backward (6 B): 10 B an element at 3.35 TB/s. The
// statistics must be complete before the first output, so each direction
// reads its inputs twice: 6 and 10 B an element, 62.5 % of the bound at
// best on a layer larger than L2.
//
// Design.
// * One wave. A call's plan (ops/cuda/batch_norm.py, bn_plan) cuts the
//   rows into `row_blocks` contiguous chunks of `rows_per_block` rows, at
//   most kMinBlocksPerSm blocks an SM, so every block of a pass is resident
//   at once. A block takes `group_tile` groups of kVec = 8 channels (one
//   16-byte load a row; C a multiple of 8, which the caller checks) and
//   kThreads / group_tile rows at a time; neighbouring threads read
//   neighbouring 16 bytes of a row, a warp 512 contiguous bytes at C = 64.
//   Each thread keeps kUnroll rows (forward) or kUnrollBwd rows of x and dy
//   (backward) in flight.
// * Statistics in one read at two-pass accuracy: each thread runs Welford
//   over its rows in fp32 registers; the threads of a channel merge by
//   Chan's formula in a fixed tree in shared memory; each block writes its
//   chunk's (mean, M2) to a partials buffer, and bn_fwd_finalize_kernel
//   merges the chunks in a fixed order (32 channels a block, 8 slices of
//   the chunks each merged in order, then a fixed tree). No atomics: the
//   result is the same bits in every run (sequence-parallel training runs
//   under torch's deterministic mode). The one-pass E[x^2] - E[x]^2 loses
//   fp32 precision on bf16 activations and is not used.
// * The second read hits L2 where it can: a pass over a chunk reads its
//   rows first to last; the following pass (apply after the statistics,
//   dx after the sums) reads each chunk last to first, so what the first
//   pass left in the 50 MB L2 (the chunks' tails) is read first. A layer
//   under ~20 MB is read from L2 entirely.
// * The backward's sums are plain fp32 sums in a fixed order (thread, then
//   a fixed tree, then the finalize's slices), likewise without atomics;
//   g*(x - mean) and not g*x - mean*g, which cancels.
// * One expression for the affine map: affine() and normalized() use
//   explicitly rounded intrinsics, so no contraction choice of the
//   compiler can make the backward's recomputed ReLU mask differ from the
//   forward's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;             // channels a thread loads at once: 16 bytes of bf16
constexpr int kMinBlocksPerSm = 2;  // ops/cuda/batch_norm.py BLOCKS_PER_SM
constexpr int kUnroll = 8;          // rows a forward thread has in flight
constexpr int kUnrollBwd = 4;       // rows of x and of dy a backward thread has in flight
constexpr int kFinalLanes = 32;     // channels of a finalize block
constexpr int kFinalSlices = kThreads / kFinalLanes;

struct Shape {
  long long rows;            // N*H*W
  long long rows_per_block;  // a multiple of rows_per_iter
  int channels;
  int groups;                // channels / kVec
  int group_tile;            // groups a block takes
  int rows_per_iter;         // kThreads / group_tile
};

// ---- bf16 packs --------------------------------------------------------------------

__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ void unpack(const uint4& r, float (&f)[8]) {
  f[0] = bf_lo(r.x); f[1] = bf_hi(r.x); f[2] = bf_lo(r.y); f[3] = bf_hi(r.y);
  f[4] = bf_lo(r.z); f[5] = bf_hi(r.z); f[6] = bf_lo(r.w); f[7] = bf_hi(r.w);
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // a in the low half
  uint32_t u;
  memcpy(&u, &h, sizeof(u));
  return u;
}

__device__ __forceinline__ void pack(const float (&f)[8], uint4& r) {
  r.x = pack2(f[0], f[1]); r.y = pack2(f[2], f[3]);
  r.z = pack2(f[4], f[5]); r.w = pack2(f[6], f[7]);
}

__device__ __forceinline__ uint4 load_row(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// ---- the one affine map -----------------------------------------------------------------

__device__ __forceinline__ void affine(float gamma, float beta, float mean, float invstd,
                                       float& scale, float& shift) {
  scale = __fmul_rn(gamma, invstd);
  shift = __fmaf_rn(-mean, scale, beta);
}

__device__ __forceinline__ float normalized(float x, float scale, float shift) {
  return __fmaf_rn(x, scale, shift);
}

// (n, mean, M2) <- (n, mean, M2) merged with (nb, mb, m2b) by Chan's formula;
// nb == 0 leaves it, n == 0 takes the other's exactly.
template <int N>
__device__ __forceinline__ void chan_merge(float& n, float (&mean)[N], float (&m2)[N], float nb,
                                           const float (&mb)[N], const float (&m2b)[N]) {
  if (nb == 0.f) return;
  const float nn = n + nb;
  const float w = nb / nn;
  const float cross = n * w;  // n * nb / nn
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float d = mb[j] - mean[j];
    mean[j] = fmaf(d, w, mean[j]);
    m2[j] = m2[j] + m2b[j] + d * d * cross;
  }
  n = nn;
}

struct Slot {  // where a thread sits in its block
  int g, r;          // group in the tile, row slot
  int c0;            // first channel
  bool active;
  long long start, end;  // the block's rows
};

__device__ __forceinline__ Slot slot_of(const Shape& s) {
  Slot t;
  t.g = threadIdx.x % s.group_tile;
  t.r = threadIdx.x / s.group_tile;
  const int group = blockIdx.y * s.group_tile + t.g;
  t.c0 = group * kVec;
  t.active = t.r < s.rows_per_iter && group < s.groups;
  t.start = blockIdx.x * s.rows_per_block;
  t.end = min(s.rows, t.start + s.rows_per_block);
  return t;
}

__device__ __forceinline__ int pow2_ceil(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// ---- forward --------------------------------------------------------------------------------

// Welford over the thread's rows, Chan's merge over the block's row slots
// in a fixed tree; the chunk's (mean, M2) to part_mean / part_m2 [blocks][C].
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
bn_fwd_stats_kernel(const __nv_bfloat16* __restrict__ x, long long ld, Shape s,
                    float* __restrict__ part_mean, float* __restrict__ part_m2) {
  __shared__ float sh_n[kThreads];
  __shared__ float sh_mean[kVec][kThreads];
  __shared__ float sh_m2[kVec][kThreads];
  const Slot t = slot_of(s);
  float n = 0.f, mean[kVec], m2[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) mean[j] = m2[j] = 0.f;
  if (t.active) {
    const __nv_bfloat16* base = x + t.c0;
    const long long step = (long long)s.rows_per_iter;
    for (long long row = t.start + t.r; row < t.end; row += kUnroll * step) {
      uint4 raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (row + u * step < t.end) raw[u] = load_row(base + (row + u * step) * ld);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (row + u * step >= t.end) break;
        float f[kVec];
        unpack(raw[u], f);
        n += 1.f;
        const float inv = __frcp_rn(n);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float d = f[j] - mean[j];
          mean[j] = fmaf(d, inv, mean[j]);
          m2[j] = fmaf(d, f[j] - mean[j], m2[j]);
        }
      }
    }
  }
  sh_n[threadIdx.x] = n;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    sh_mean[j][threadIdx.x] = mean[j];
    sh_m2[j][threadIdx.x] = m2[j];
  }
  __syncthreads();
  for (int half = pow2_ceil(s.rows_per_iter) >> 1; half > 0; half >>= 1) {
    if (t.active && t.r < half && t.r + half < s.rows_per_iter) {
      const int o = threadIdx.x + half * s.group_tile;
      float mb[kVec], m2b[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        mb[j] = sh_mean[j][o];
        m2b[j] = sh_m2[j][o];
      }
      chan_merge<kVec>(n, mean, m2, sh_n[o], mb, m2b);
      sh_n[threadIdx.x] = n;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        sh_mean[j][threadIdx.x] = mean[j];
        sh_m2[j][threadIdx.x] = m2[j];
      }
    }
    __syncthreads();
  }
  if (t.active && t.r == 0) {
    float* pm = part_mean + (long long)blockIdx.x * s.channels + t.c0;
    float* pq = part_m2 + (long long)blockIdx.x * s.channels + t.c0;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      pm[j] = mean[j];
      pq[j] = m2[j];
    }
  }
}

// The chunks' partials merged in a fixed order: mean, invstd; the running
// buffers folded where `fold`.
__global__ void __launch_bounds__(kThreads)
bn_fwd_finalize_kernel(const float* __restrict__ part_mean, const float* __restrict__ part_m2,
                       int blocks, long long rows, long long rows_per_block, int channels,
                       float eps, float momentum, int fold, float* __restrict__ mean_out,
                       float* __restrict__ invstd_out, float* __restrict__ running_mean,
                       float* __restrict__ running_var) {
  __shared__ float sh_n[kFinalSlices][kFinalLanes];
  __shared__ float sh_mean[kFinalSlices][kFinalLanes];
  __shared__ float sh_m2[kFinalSlices][kFinalLanes];
  const int lane = threadIdx.x % kFinalLanes, slice = threadIdx.x / kFinalLanes;
  const int c = blockIdx.x * kFinalLanes + lane;
  float n = 0.f, mean[1] = {0.f}, m2[1] = {0.f};
  if (c < channels) {
    const int per = (blocks + kFinalSlices - 1) / kFinalSlices;
    const int last = min(blocks, (slice + 1) * per);
    for (int p = slice * per; p < last; ++p) {
      const float np = static_cast<float>(min(rows_per_block, rows - p * rows_per_block));
      const float mb[1] = {part_mean[(long long)p * channels + c]};
      const float m2b[1] = {part_m2[(long long)p * channels + c]};
      chan_merge<1>(n, mean, m2, np, mb, m2b);
    }
  }
  sh_n[slice][lane] = n;
  sh_mean[slice][lane] = mean[0];
  sh_m2[slice][lane] = m2[0];
  __syncthreads();
  for (int half = kFinalSlices / 2; half > 0; half >>= 1) {
    if (slice < half) {
      const float mb[1] = {sh_mean[slice + half][lane]};
      const float m2b[1] = {sh_m2[slice + half][lane]};
      chan_merge<1>(n, mean, m2, sh_n[slice + half][lane], mb, m2b);
      sh_n[slice][lane] = n;
      sh_mean[slice][lane] = mean[0];
      sh_m2[slice][lane] = m2[0];
    }
    __syncthreads();
  }
  if (slice != 0 || c >= channels) return;
  const float var = m2[0] / static_cast<float>(rows);
  mean_out[c] = mean[0];
  invstd_out[c] = 1.f / sqrtf(var + eps);
  if (fold) {
    const float unbiased = m2[0] / static_cast<float>(rows - 1);
    running_mean[c] = (1.f - momentum) * running_mean[c] + momentum * mean[0];
    running_var[c] = (1.f - momentum) * running_var[c] + momentum * unbiased;
  }
}

// y = fma(x, scale, shift) [ReLU], each chunk read last row first.
template <bool RELU>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
bn_fwd_apply_kernel(const __nv_bfloat16* __restrict__ x, long long ld, Shape s,
                    const float* __restrict__ gamma, const float* __restrict__ beta,
                    const float* __restrict__ mean, const float* __restrict__ invstd,
                    __nv_bfloat16* __restrict__ y) {
  const Slot t = slot_of(s);
  if (!t.active) return;
  float scale[kVec], shift[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j)
    affine(gamma[t.c0 + j], beta[t.c0 + j], mean[t.c0 + j], invstd[t.c0 + j], scale[j], shift[j]);
  const __nv_bfloat16* src = x + t.c0;
  __nv_bfloat16* dst = y + t.c0;
  const long long step = (long long)s.rows_per_iter;
  const long long iters = (t.end - t.start + step - 1) / step;
  for (long long it = iters - 1; it >= 0; it -= kUnroll) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long row = t.start + (it - u) * step + t.r;
      if (it - u >= 0 && row < t.end) raw[u] = load_row(src + row * ld);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long row = t.start + (it - u) * step + t.r;
      if (it - u < 0 || row >= t.end) continue;
      float f[kVec];
      unpack(raw[u], f);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float v = normalized(f[j], scale[j], shift[j]);
        f[j] = RELU ? (v > 0.f ? v : 0.f) : v;
      }
      uint4 out;
      pack(f, out);
      *reinterpret_cast<uint4*>(dst + row * s.channels) = out;
    }
  }
}

// ---- backward -------------------------------------------------------------------------------

// Per-channel S1 = sum g and S2 = sum g*(x - mean) of the chunk, to
// part [2][blocks][C].
template <bool RELU>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
bn_bwd_reduce_kernel(const __nv_bfloat16* __restrict__ dy, long long ld_dy,
                     const __nv_bfloat16* __restrict__ x, long long ld_x, Shape s,
                     const float* __restrict__ gamma, const float* __restrict__ beta,
                     const float* __restrict__ mean, const float* __restrict__ invstd,
                     float* __restrict__ part) {
  __shared__ float sh_s1[kVec][kThreads];
  __shared__ float sh_s2[kVec][kThreads];
  const Slot t = slot_of(s);
  float s1[kVec], s2[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) s1[j] = s2[j] = 0.f;
  if (t.active) {
    float mu[kVec], scale[kVec], shift[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      mu[j] = mean[t.c0 + j];
      affine(gamma[t.c0 + j], beta[t.c0 + j], mu[j], invstd[t.c0 + j], scale[j], shift[j]);
    }
    const __nv_bfloat16* xs = x + t.c0;
    const __nv_bfloat16* gs = dy + t.c0;
    const long long step = (long long)s.rows_per_iter;
    for (long long row = t.start + t.r; row < t.end; row += kUnrollBwd * step) {
      uint4 rx[kUnrollBwd], rg[kUnrollBwd];
#pragma unroll
      for (int u = 0; u < kUnrollBwd; ++u) {
        const long long rr = row + u * step;
        if (rr < t.end) {
          rx[u] = load_row(xs + rr * ld_x);
          rg[u] = load_row(gs + rr * ld_dy);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnrollBwd; ++u) {
        if (row + u * step >= t.end) break;
        float fx[kVec], fg[kVec];
        unpack(rx[u], fx);
        unpack(rg[u], fg);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float g = (!RELU || normalized(fx[j], scale[j], shift[j]) > 0.f) ? fg[j] : 0.f;
          s1[j] += g;
          s2[j] = fmaf(g, fx[j] - mu[j], s2[j]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    sh_s1[j][threadIdx.x] = s1[j];
    sh_s2[j][threadIdx.x] = s2[j];
  }
  __syncthreads();
  for (int half = pow2_ceil(s.rows_per_iter) >> 1; half > 0; half >>= 1) {
    if (t.active && t.r < half && t.r + half < s.rows_per_iter) {
      const int o = threadIdx.x + half * s.group_tile;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        s1[j] += sh_s1[j][o];
        s2[j] += sh_s2[j][o];
        sh_s1[j][threadIdx.x] = s1[j];
        sh_s2[j][threadIdx.x] = s2[j];
      }
    }
    __syncthreads();
  }
  if (t.active && t.r == 0) {
    const long long plane = (long long)gridDim.x * s.channels;
    float* p1 = part + (long long)blockIdx.x * s.channels + t.c0;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      p1[j] = s1[j];
      p1[plane + j] = s2[j];
    }
  }
}

// The chunks' sums added in a fixed order: dgamma, dbeta, and dx's
// coefficients coef [3][C] = (c1, c2, c3).
__global__ void __launch_bounds__(kThreads)
bn_bwd_finalize_kernel(const float* __restrict__ part, int blocks, long long rows, int channels,
                       const float* __restrict__ gamma, const float* __restrict__ invstd,
                       float* __restrict__ dgamma, float* __restrict__ dbeta,
                       float* __restrict__ coef) {
  __shared__ float sh_s1[kFinalSlices][kFinalLanes];
  __shared__ float sh_s2[kFinalSlices][kFinalLanes];
  const int lane = threadIdx.x % kFinalLanes, slice = threadIdx.x / kFinalLanes;
  const int c = blockIdx.x * kFinalLanes + lane;
  const long long plane = (long long)blocks * channels;
  float s1 = 0.f, s2 = 0.f;
  if (c < channels) {
    const int per = (blocks + kFinalSlices - 1) / kFinalSlices;
    const int last = min(blocks, (slice + 1) * per);
    for (int p = slice * per; p < last; ++p) {
      s1 += part[(long long)p * channels + c];
      s2 += part[plane + (long long)p * channels + c];
    }
  }
  sh_s1[slice][lane] = s1;
  sh_s2[slice][lane] = s2;
  __syncthreads();
  for (int half = kFinalSlices / 2; half > 0; half >>= 1) {
    if (slice < half) {
      s1 += sh_s1[slice + half][lane];
      s2 += sh_s2[slice + half][lane];
      sh_s1[slice][lane] = s1;
      sh_s2[slice][lane] = s2;
    }
    __syncthreads();
  }
  if (slice != 0 || c >= channels) return;
  const float is = invstd[c], m = static_cast<float>(rows);
  const float c1 = gamma[c] * is;
  dbeta[c] = s1;
  dgamma[c] = s2 * is;
  coef[c] = c1;
  coef[channels + c] = -(c1 * is * is * s2) / m;
  coef[2 * channels + c] = -(c1 * s1) / m;
}

// dx = c1*g + c2*(x - mean) + c3, each chunk read last row first.
template <bool RELU>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
bn_bwd_dx_kernel(const __nv_bfloat16* __restrict__ dy, long long ld_dy,
                 const __nv_bfloat16* __restrict__ x, long long ld_x, Shape s,
                 const float* __restrict__ gamma, const float* __restrict__ beta,
                 const float* __restrict__ mean, const float* __restrict__ invstd,
                 const float* __restrict__ coef, __nv_bfloat16* __restrict__ dx) {
  const Slot t = slot_of(s);
  if (!t.active) return;
  float mu[kVec], scale[kVec], shift[kVec], c1[kVec], c2[kVec], c3[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int c = t.c0 + j;
    mu[j] = mean[c];
    affine(gamma[c], beta[c], mu[j], invstd[c], scale[j], shift[j]);
    c1[j] = coef[c];
    c2[j] = coef[s.channels + c];
    c3[j] = coef[2 * s.channels + c];
  }
  const __nv_bfloat16* xs = x + t.c0;
  const __nv_bfloat16* gs = dy + t.c0;
  __nv_bfloat16* dst = dx + t.c0;
  const long long step = (long long)s.rows_per_iter;
  const long long iters = (t.end - t.start + step - 1) / step;
  for (long long it = iters - 1; it >= 0; it -= kUnrollBwd) {
    uint4 rx[kUnrollBwd], rg[kUnrollBwd];
#pragma unroll
    for (int u = 0; u < kUnrollBwd; ++u) {
      const long long row = t.start + (it - u) * step + t.r;
      if (it - u >= 0 && row < t.end) {
        rx[u] = load_row(xs + row * ld_x);
        rg[u] = load_row(gs + row * ld_dy);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnrollBwd; ++u) {
      const long long row = t.start + (it - u) * step + t.r;
      if (it - u < 0 || row >= t.end) continue;
      float fx[kVec], fg[kVec];
      unpack(rx[u], fx);
      unpack(rg[u], fg);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float g = (!RELU || normalized(fx[j], scale[j], shift[j]) > 0.f) ? fg[j] : 0.f;
        fx[j] = fmaf(c1[j], g, fmaf(c2[j], fx[j] - mu[j], c3[j]));
      }
      uint4 out;
      pack(fx, out);
      *reinterpret_cast<uint4*>(dst + row * s.channels) = out;
    }
  }
}

// ---- launches -------------------------------------------------------------------------------

bool plan_ok(const Shape& s, int channel_tiles, int row_blocks) {
  return s.channels > 0 && s.channels % kVec == 0 && s.group_tile > 0 &&
         s.group_tile <= kThreads && s.rows_per_iter == kThreads / s.group_tile &&
         channel_tiles > 0 && channel_tiles <= 65535 &&
         (long long)channel_tiles * s.group_tile >= s.groups &&
         (long long)(channel_tiles - 1) * s.group_tile < s.groups && s.rows > 1 &&
         s.rows_per_block > 0 && s.rows_per_block % s.rows_per_iter == 0 && row_blocks > 0 &&
         (long long)row_blocks * s.rows_per_block >= s.rows &&
         (long long)(row_blocks - 1) * s.rows_per_block < s.rows;
}

bool rows_ok(const void* p, long long ld, const Shape& s) {
  return p != nullptr && ld >= s.channels && ld % kVec == 0 &&
         reinterpret_cast<uintptr_t>(p) % sizeof(uint4) == 0;
}

Shape make_shape(long long rows, int channels, int group_tile, long long rows_per_block) {
  Shape s;
  s.rows = rows;
  s.rows_per_block = rows_per_block;
  s.channels = channels;
  s.groups = channels / kVec;
  s.group_tile = group_tile;
  s.rows_per_iter = group_tile > 0 ? kThreads / group_tile : 0;
  return s;
}

int finalize_blocks(int channels) { return (channels + kFinalLanes - 1) / kFinalLanes; }

template <bool RELU>
cudaError_t launch_fwd(const __nv_bfloat16* x, long long ld, __nv_bfloat16* y, const float* gamma,
                       const float* beta, float* running_mean, float* running_var, float* mean,
                       float* invstd, float* part, const Shape& s, dim3 grid, float momentum,
                       float eps, int fold, cudaStream_t stream) {
  float* part_mean = part;
  float* part_m2 = part + (long long)grid.x * s.channels;
  bn_fwd_stats_kernel<<<grid, kThreads, 0, stream>>>(x, ld, s, part_mean, part_m2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_fwd_finalize_kernel<<<finalize_blocks(s.channels), kThreads, 0, stream>>>(
      part_mean, part_m2, static_cast<int>(grid.x), s.rows, s.rows_per_block, s.channels, eps,
      momentum, fold, mean, invstd, running_mean, running_var);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_fwd_apply_kernel<RELU><<<grid, kThreads, 0, stream>>>(x, ld, s, gamma, beta, mean, invstd, y);
  return cudaGetLastError();
}

template <bool RELU>
cudaError_t launch_bwd(const __nv_bfloat16* dy, long long ld_dy, const __nv_bfloat16* x,
                       long long ld_x, const float* gamma, const float* beta, const float* mean,
                       const float* invstd, __nv_bfloat16* dx, float* dgamma, float* dbeta,
                       float* part, const Shape& s, dim3 grid, cudaStream_t stream) {
  float* coef = part + 2LL * grid.x * s.channels;
  bn_bwd_reduce_kernel<RELU><<<grid, kThreads, 0, stream>>>(dy, ld_dy, x, ld_x, s, gamma, beta,
                                                            mean, invstd, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_bwd_finalize_kernel<<<finalize_blocks(s.channels), kThreads, 0, stream>>>(
      part, static_cast<int>(grid.x), s.rows, s.channels, gamma, invstd, dgamma, dbeta, coef);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_bwd_dx_kernel<RELU><<<grid, kThreads, 0, stream>>>(dy, ld_dy, x, ld_x, s, gamma, beta, mean,
                                                        invstd, coef, dx);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The forward on `stream` of `device` with the wrapper's plan; returns the
// CUDA error (0 on success). x is bf16 [rows, C] with rows `ld` apart (C
// and ld multiples of 8, x 16-byte aligned); y is written [rows, C]
// contiguous; gamma, beta, the running buffers, mean and invstd are fp32
// [C]; part is fp32 scratch of 2 * row_blocks * C.
// The running buffers are folded in place where `fold`.
int adepth_bn_fwd(const void* x, long long ld, void* y, const void* gamma, const void* beta,
                  void* running_mean, void* running_var, void* mean, void* invstd, void* part,
                  long long rows, int channels, int group_tile, int channel_tiles,
                  long long rows_per_block, int row_blocks, float momentum, float eps, int relu,
                  int fold, int device, void* stream) {
  const Shape s = make_shape(rows, channels, group_tile, rows_per_block);
  if (!plan_ok(s, channel_tiles, row_blocks) || !rows_ok(x, ld, s) ||
      !rows_ok(y, channels, s) || !gamma || !beta || !mean || !invstd || !part ||
      (fold && (!running_mean || !running_var)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(row_blocks, channel_tiles);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  const auto* g = static_cast<const float*>(gamma);
  const auto* b = static_cast<const float*>(beta);
  auto* rm = static_cast<float*>(running_mean);
  auto* rv = static_cast<float*>(running_var);
  auto* mu = static_cast<float*>(mean);
  auto* is = static_cast<float*>(invstd);
  auto* pt = static_cast<float*>(part);
  const auto st = static_cast<cudaStream_t>(stream);
  err = relu ? launch_fwd<true>(xb, ld, yb, g, b, rm, rv, mu, is, pt, s, grid, momentum, eps,
                                fold, st)
             : launch_fwd<false>(xb, ld, yb, g, b, rm, rv, mu, is, pt, s, grid, momentum, eps,
                                 fold, st);
  return static_cast<int>(err);
}

// The backward likewise: dy and x bf16 [rows, C] with rows ld_dy and ld_x
// apart; dx written [rows, C] contiguous; dgamma, dbeta fp32 [C]; part is
// fp32 scratch of 2 * row_blocks * C + 3 * C.
int adepth_bn_bwd(const void* dy, long long ld_dy, const void* x, long long ld_x,
                  const void* gamma, const void* beta, const void* mean, const void* invstd,
                  void* dx, void* dgamma, void* dbeta, void* part, long long rows, int channels,
                  int group_tile, int channel_tiles, long long rows_per_block, int row_blocks,
                  int relu, int device, void* stream) {
  const Shape s = make_shape(rows, channels, group_tile, rows_per_block);
  if (!plan_ok(s, channel_tiles, row_blocks) || !rows_ok(dy, ld_dy, s) ||
      !rows_ok(x, ld_x, s) || !rows_ok(dx, channels, s) || !gamma || !beta || !mean ||
      !invstd || !dgamma || !dbeta || !part)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(row_blocks, channel_tiles);
  const auto* gb = static_cast<const __nv_bfloat16*>(dy);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* g = static_cast<const float*>(gamma);
  const auto* b = static_cast<const float*>(beta);
  const auto* mu = static_cast<const float*>(mean);
  const auto* is = static_cast<const float*>(invstd);
  auto* out = static_cast<__nv_bfloat16*>(dx);
  auto* dg = static_cast<float*>(dgamma);
  auto* db = static_cast<float*>(dbeta);
  auto* pt = static_cast<float*>(part);
  const auto st = static_cast<cudaStream_t>(stream);
  err = relu ? launch_bwd<true>(gb, ld_dy, xb, ld_x, g, b, mu, is, out, dg, db, pt, s, grid, st)
             : launch_bwd<false>(gb, ld_dy, xb, ld_x, g, b, mu, is, out, dg, db, pt, s, grid, st);
  return static_cast<int>(err);
}

const char* adepth_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
