// AdaBins' soft binning for Hopper (sm_90a) over the class head's bf16
// logits in channels-last memory: the forward (soft_bin_fwd_*) and the
// backward (soft_bin_bwd_*), each a C call of two kernels.
//
// Replaces no TPU kernel. On the TPU, XLA fused the JAX package's float32
// cast, softmax over the bins, product with the centres, sum and the KL
// term's spatial mean (models/adabins.py, losses/distillation.py) into a
// few passes over the logits. Eager PyTorch runs them as separate passes
// over [B, K, H, W]: a float32 copy of the logits, the softmax's float32
// probabilities (kept for the backward), their product with the centres,
// the sum, the mean, and in the backward the mirror image, about 36 bytes
// of device traffic an element. This pair reads the bf16 logits once each
// way and never writes a float32 tensor of that shape.
//
// Function (z = logits[b, :, p] over the K bins of pixel p of image b,
// c = centers[b, :], HW pixels an image):
//   forward   base[b, p] = sum_k softmax(z)_k * c_k        (fp32)
//             logit_mean[b, k] = sum_p z_k / HW            (fp32)
//   backward  grad_logits[b, k, p] = bf16(g * p_k * (c_k - base[b, p])
//                                         + g_mean[b, k] / HW)
//             grad_centers[b, k] = sum_p g * p_k           (fp32)
//             with g = g_base[b, p] and p_k = softmax(z)_k recomputed
//
// What bounds it on the H100 SXM: bytes. The forward has to read the
// logits once (2 B an element; base is 4 B a pixel, K times fewer), the
// backward to read them once and write the gradient once (4 B an element):
// at [64, 128, 256, 256], 1.07 GB and 2.15 GB, 0.32 and 0.64 ms at
// 3.35 TB/s. At that rate an SM has ~140 cycles for a warp's 32 pixels'
// 8-bin loads (2 KB), so the arithmetic is kept to ~7 instructions an
// element: the unpack, the max, one fma and one ex2 on the SFU for the
// exponential, its sum, the product with the centre, the logit sum; the
// masks are applied once a pixel, not once a bin.
//
// Design.
// * A pixel's K bins are contiguous (channels-last). A group of G lanes of
//   one warp takes a pixel, one 16-byte load (8 bins) a lane: G is the
//   power of two at or above K / 8 (K = 128: 16 lanes, two pixels a warp
//   reading 512 contiguous bytes); lanes past K / 8 (K not 8 times a power
//   of two) hold no bins. The max, the sum of exponentials and sum e*c are
//   fp32 in registers, combined over the group by xor shuffles, which give
//   every lane the same bits.
// * A block takes `pixels_per_block` consecutive pixels of one image (the
//   plan in ops/cuda/soft_binning.py, sb_plan), its 256 / G pixel slots
//   kUnrollFwd (kUnrollBwd) pixels at a time, all lanes of a warp running
//   the same iterations (shuffles need the whole warp); each thread keeps its 8
//   bins' running sums (the forward's logit sums, the backward's g * p_k).
//   At the end a block adds its slots' sums in a fixed order in shared
//   memory and writes one partial row per (image, block); the finalize
//   kernel adds an image's partial rows in a fixed order. No atomics: every
//   run gives the same bits.
// * The backward recomputes the softmax from its one read of the logits
//   and takes base from the forward; its output is rounded to bf16 once,
//   after the fp32 sum of the two terms, as the cast's backward rounds it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;             // bins a lane loads at once: 16 bytes of bf16
constexpr int kMaxLanes = 32;       // a pixel's bins in one warp: K <= 256
// pixels a slot has in flight, and blocks an SM (at most 64 registers a
// thread, no spill): the fastest spill-free pair of each measured on the
// H100 at [64, 128, 256, 256] (forward 80 %, backward 80 % of the bound)
constexpr int kUnrollFwd = 4;
constexpr int kUnrollBwd = 2;
constexpr int kMinBlocksPerSm = 4;
constexpr float kLog2e = 1.4426950408889634f;

struct Shape {
  long long hw;                // pixels an image
  long long pixels_per_block;  // a multiple of the block's pixel slots
  int bins;                    // K, a multiple of kVec
  int vecs;                    // K / kVec
};

// ---- bf16 packs --------------------------------------------------------------------

__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ void unpack(const uint4& r, float (&f)[kVec]) {
  f[0] = bf_lo(r.x); f[1] = bf_hi(r.x); f[2] = bf_lo(r.y); f[3] = bf_hi(r.y);
  f[4] = bf_lo(r.z); f[5] = bf_hi(r.z); f[6] = bf_lo(r.w); f[7] = bf_hi(r.w);
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // a in the low half
  uint32_t u;
  memcpy(&u, &h, sizeof(u));
  return u;
}

__device__ __forceinline__ void pack(const float (&f)[kVec], uint4& r) {
  r.x = pack2(f[0], f[1]); r.y = pack2(f[2], f[3]);
  r.z = pack2(f[4], f[5]); r.w = pack2(f[6], f[7]);
}

// ---- a pixel's group of G lanes -----------------------------------------------------------

template <int G>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 2^x on the SFU (one MUFU.EX2; results below 2^-126 flush to 0, which
// a sum over the bins with the largest at 2^0 cannot see).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The softmax's exponentials of one pixel's bins on this lane, e_k =
// exp(z_k - max) = 2^(z_k log2(e) - max log2(e)) (one fma and one ex2 a
// bin), and their sum over the group. A lane without bins (`active`
// false) gives nothing to the max or the sum; its e_k are left unused.
template <int G>
__device__ __forceinline__ float exponentials(const float (&f)[kVec], bool active,
                                              float (&e)[kVec]) {
  float m = f[0];
#pragma unroll
  for (int j = 1; j < kVec; ++j) m = fmaxf(m, f[j]);
  m = group_max<G>(active ? m : -INFINITY);
  const float ml = m * kLog2e;
  float se = 0.f;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    e[j] = exp2_approx(fmaf(f[j], kLog2e, -ml));
    se += e[j];
  }
  return group_sum<G>(active ? se : 0.f);
}

struct Slot {  // where a thread sits in its block
  int lane, slot;          // lane of the pixel's group, the group's pixel slot
  int k0;                  // first bin
  bool active;             // the lane holds bins (lane < K / 8)
  long long start, end;    // the block's pixels
  long long iters;         // U pixels a slot an iteration, the same for the block
};

template <int G, int U>
__device__ __forceinline__ Slot slot_of(const Shape& s) {
  constexpr int kSlots = kThreads / G;
  Slot t;
  t.lane = threadIdx.x % G;
  t.slot = threadIdx.x / G;
  t.k0 = t.lane * kVec;
  t.active = t.lane < s.vecs;
  t.start = (long long)blockIdx.x * s.pixels_per_block;
  t.end = min(s.hw, t.start + s.pixels_per_block);
  const long long step = (long long)U * kSlots;
  t.iters = (t.end - t.start + step - 1) / step;
  return t;
}

// The block's per-bin sums (a thread's 8 bins in `acc`) added over its
// pixel slots in a fixed order, to part[(b * blocks + block) * K + k].
template <int G>
__device__ __forceinline__ void block_sums(const float (&acc)[kVec], const Shape& s,
                                           float* __restrict__ part) {
  constexpr int kSlots = kThreads / G;
  __shared__ float sh[kThreads * kVec];  // [slot][lane * 8 + j]
#pragma unroll
  for (int j = 0; j < kVec; ++j) sh[threadIdx.x * kVec + j] = acc[j];
  __syncthreads();
  if (threadIdx.x < s.bins) {
    float total = 0.f;
    for (int sl = 0; sl < kSlots; ++sl) total += sh[sl * (G * kVec) + threadIdx.x];
    part[((long long)blockIdx.y * gridDim.x + blockIdx.x) * s.bins + threadIdx.x] = total;
  }
}

// ---- forward --------------------------------------------------------------------------------

template <int G>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
soft_bin_fwd_kernel(const __nv_bfloat16* __restrict__ logits, const float* __restrict__ centers,
                    Shape s, float* __restrict__ base, float* __restrict__ part) {
  constexpr int kSlots = kThreads / G;
  const Slot t = slot_of<G, kUnrollFwd>(s);
  const int b = blockIdx.y;
  float c[kVec], acc[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    c[j] = t.active ? centers[(long long)b * s.bins + t.k0 + j] : 0.f;
    acc[j] = 0.f;
  }
  const __nv_bfloat16* img = logits + (long long)b * s.hw * s.bins + t.k0;
  float* out = base + (long long)b * s.hw;
  for (long long it = 0; it < t.iters; ++it) {
    const long long p0 = t.start + it * kUnrollFwd * kSlots + t.slot;
    uint4 raw[kUnrollFwd];
#pragma unroll
    for (int u = 0; u < kUnrollFwd; ++u) {
      const long long p = p0 + u * kSlots;
      raw[u] = (t.active && p < t.end) ? *reinterpret_cast<const uint4*>(img + p * s.bins)
                                       : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kUnrollFwd; ++u) {
      // a pixel past the block's end reads zeros: its sums are finite and unused
      const long long p = p0 + u * kSlots;
      float f[kVec], e[kVec];
      unpack(raw[u], f);
      const float se = exponentials<G>(f, t.active, e);
      float sec = 0.f;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        sec = fmaf(e[j], c[j], sec);
        acc[j] += f[j];  // 0 past the end and on a lane without bins
      }
      sec = group_sum<G>(t.active ? sec : 0.f);
      if (t.lane == 0 && p < t.end) out[p] = sec / se;
    }
  }
  block_sums<G>(acc, s, part);
}

// ---- backward -------------------------------------------------------------------------------

template <int G>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
soft_bin_bwd_kernel(const float* __restrict__ g_base, const float* __restrict__ g_mean,
                    const __nv_bfloat16* __restrict__ logits, const float* __restrict__ centers,
                    const float* __restrict__ base, Shape s,
                    __nv_bfloat16* __restrict__ grad_logits, float* __restrict__ part) {
  constexpr int kSlots = kThreads / G;
  const Slot t = slot_of<G, kUnrollBwd>(s);
  const int b = blockIdx.y;
  const float hw = static_cast<float>(s.hw);
  float c[kVec], gm[kVec], acc[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const long long k = (long long)b * s.bins + t.k0 + j;
    c[j] = t.active ? centers[k] : 0.f;
    gm[j] = t.active ? g_mean[k] / hw : 0.f;
    acc[j] = 0.f;
  }
  const long long img_off = (long long)b * s.hw * s.bins + t.k0;
  const __nv_bfloat16* img = logits + img_off;
  __nv_bfloat16* dst = grad_logits + img_off;
  const float* gb = g_base + (long long)b * s.hw;
  const float* bs = base + (long long)b * s.hw;
  for (long long it = 0; it < t.iters; ++it) {
    const long long p0 = t.start + it * kUnrollBwd * kSlots + t.slot;
    uint4 raw[kUnrollBwd];
    float g[kUnrollBwd], mu[kUnrollBwd];
#pragma unroll
    for (int u = 0; u < kUnrollBwd; ++u) {
      const long long p = p0 + u * kSlots;
      const bool in = p < t.end;
      raw[u] = (t.active && in) ? *reinterpret_cast<const uint4*>(img + p * s.bins)
                                : make_uint4(0u, 0u, 0u, 0u);
      g[u] = in ? gb[p] : 0.f;
      mu[u] = in ? bs[p] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnrollBwd; ++u) {
      const long long p = p0 + u * kSlots;
      float f[kVec], e[kVec];
      unpack(raw[u], f);
      const float se = exponentials<G>(f, t.active, e);
      if (!t.active || p >= t.end) continue;  // after the group's shuffles
      const float gr = g[u] / se;  // g * p_k = e_k * (g / sum e)
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float gp = e[j] * gr;
        acc[j] += gp;
        f[j] = fmaf(gp, c[j] - mu[u], gm[j]);
      }
      uint4 o;
      pack(f, o);
      *reinterpret_cast<uint4*>(dst + p * s.bins) = o;
    }
  }
  block_sums<G>(acc, s, part);
}

// ---- the finalize --------------------------------------------------------------------------

// out[b, k] = (sum over an image's partial rows, in order) / divisor; one
// block an image, a thread a bin.
__global__ void __launch_bounds__(kThreads)
soft_bin_finalize_kernel(const float* __restrict__ part, int blocks, int bins, float divisor,
                         float* __restrict__ out) {
  const int b = blockIdx.x;
  for (int k = threadIdx.x; k < bins; k += blockDim.x) {
    const float* row = part + (long long)b * blocks * bins + k;
    float total = 0.f;
    for (int p = 0; p < blocks; ++p) total += row[(long long)p * bins];
    out[(long long)b * bins + k] = total / divisor;
  }
}

// ---- launches -------------------------------------------------------------------------------

bool plan_ok(int batch, const Shape& s, int lanes, int blocks) {
  if (batch < 1 || batch > 65535 || s.hw < 1 || s.bins < kVec || s.bins % kVec ||
      s.vecs != s.bins / kVec || lanes < 1 || lanes > kMaxLanes || (lanes & (lanes - 1)) ||
      lanes < s.vecs || 2 * s.vecs <= lanes || blocks < 1 || s.pixels_per_block < 1)
    return false;
  const int slots = kThreads / lanes;
  return s.pixels_per_block % slots == 0 && (long long)blocks * s.pixels_per_block >= s.hw &&
         (long long)(blocks - 1) * s.pixels_per_block < s.hw;
}

bool aligned(const void* p) {
  return p != nullptr && reinterpret_cast<uintptr_t>(p) % sizeof(uint4) == 0;
}

Shape make_shape(long long hw, int bins, long long pixels_per_block) {
  Shape s;
  s.hw = hw;
  s.pixels_per_block = pixels_per_block;
  s.bins = bins;
  s.vecs = bins / kVec;
  return s;
}

template <int G>
cudaError_t launch_fwd(const __nv_bfloat16* logits, const float* centers, float* base,
                       float* part, const Shape& s, dim3 grid, cudaStream_t stream) {
  soft_bin_fwd_kernel<G><<<grid, kThreads, 0, stream>>>(logits, centers, s, base, part);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_bwd(const float* g_base, const float* g_mean, const __nv_bfloat16* logits,
                       const float* centers, const float* base, __nv_bfloat16* grad_logits,
                       float* part, const Shape& s, dim3 grid, cudaStream_t stream) {
  soft_bin_bwd_kernel<G><<<grid, kThreads, 0, stream>>>(g_base, g_mean, logits, centers, base, s,
                                                        grad_logits, part);
  return cudaGetLastError();
}

cudaError_t finalize(const float* part, int batch, int blocks, int bins, float divisor,
                     float* out, cudaStream_t stream) {
  soft_bin_finalize_kernel<<<batch, kThreads, 0, stream>>>(part, blocks, bins, divisor, out);
  return cudaGetLastError();
}

#define SB_BY_LANES(lanes, call) \
  switch (lanes) {                \
    case 1: { constexpr int G = 1; err = call; break; }   \
    case 2: { constexpr int G = 2; err = call; break; }   \
    case 4: { constexpr int G = 4; err = call; break; }   \
    case 8: { constexpr int G = 8; err = call; break; }   \
    case 16: { constexpr int G = 16; err = call; break; } \
    case 32: { constexpr int G = 32; err = call; break; } \
    default: err = cudaErrorInvalidValue;                 \
  }

}  // namespace

extern "C" {

// The forward on `stream` of `device` with the wrapper's plan; returns the
// CUDA error (0 on success). logits is bf16 [batch, hw, bins] (channels-last
// [B, K, H, W]), 16-byte aligned; centers fp32 [batch, bins]; base is
// written fp32 [batch, hw], logit_mean fp32 [batch, bins]; part is fp32
// scratch of batch * blocks * bins.
int adepth_sb_fwd(const void* logits, const void* centers, void* base, void* logit_mean,
                  void* part, int batch, long long hw, int bins, int lanes,
                  long long pixels_per_block, int blocks, int device, void* stream) {
  const Shape s = make_shape(hw, bins, pixels_per_block);
  if (!plan_ok(batch, s, lanes, blocks) || !aligned(logits) || !centers || !base ||
      !logit_mean || !part)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(blocks, batch);
  const auto* z = static_cast<const __nv_bfloat16*>(logits);
  const auto* c = static_cast<const float*>(centers);
  auto* out = static_cast<float*>(base);
  auto* pt = static_cast<float*>(part);
  const auto st = static_cast<cudaStream_t>(stream);
  SB_BY_LANES(lanes, launch_fwd<G>(z, c, out, pt, s, grid, st));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(finalize(pt, batch, blocks, bins, static_cast<float>(hw),
                                   static_cast<float*>(logit_mean), st));
}

// The backward likewise: g_base and base fp32 [batch, hw], g_mean fp32
// [batch, bins], logits as the forward's; grad_logits is written bf16
// [batch, hw, bins] (16-byte aligned), grad_centers fp32 [batch, bins];
// part is fp32 scratch of batch * blocks * bins.
int adepth_sb_bwd(const void* g_base, const void* g_mean, const void* logits,
                  const void* centers, const void* base, void* grad_logits, void* grad_centers,
                  void* part, int batch, long long hw, int bins, int lanes,
                  long long pixels_per_block, int blocks, int device, void* stream) {
  const Shape s = make_shape(hw, bins, pixels_per_block);
  if (!plan_ok(batch, s, lanes, blocks) || !aligned(logits) || !aligned(grad_logits) ||
      !g_base || !g_mean || !centers || !base || !grad_centers || !part)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(blocks, batch);
  const auto* gb = static_cast<const float*>(g_base);
  const auto* gm = static_cast<const float*>(g_mean);
  const auto* z = static_cast<const __nv_bfloat16*>(logits);
  const auto* c = static_cast<const float*>(centers);
  const auto* mu = static_cast<const float*>(base);
  auto* dz = static_cast<__nv_bfloat16*>(grad_logits);
  auto* pt = static_cast<float*>(part);
  const auto st = static_cast<cudaStream_t>(stream);
  SB_BY_LANES(lanes, launch_bwd<G>(gb, gm, z, c, mu, dz, pt, s, grid, st));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(finalize(pt, batch, blocks, bins, 1.f,
                                   static_cast<float*>(grad_centers), st));
}

const char* adepth_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
