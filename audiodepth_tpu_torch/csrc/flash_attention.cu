// Flash cross-attention for Hopper (sm_90a): kernel B2 (the forward) and
// kernel B3 (the backward, from "Kernel B3" on, with its own note).
//
// B2 replaces the TPU kernel audiodepth_tpu/ops/pallas/flash_attention.py:103
// (_fwd_kernel, via _flash_fwd). Same function:
//   o   = softmax(q.k^T.scale).v          [B, N, dv], in the input dtype
//   lse = log sum_m exp(q.k^T.scale)      [B, N] fp32 (natural log)
// with q [B, N, dk], k [B, M, dk], v [B, M, dv], all bf16 or all fp32, and
// an online base-2 softmax with fp32 running max and sum. There the k axis
// was a sequential grid dimension with the statistics in VMEM scratch; here
// it is a loop inside the block. The scale is not folded into a bf16 copy
// of q (a rounding the TPU kernel paid to save a VPU pass): the fp32 score s
// enters the softmax as exp2(s*c - m*c), c = scale*log2(e). P is rounded to
// bf16 before P.V; statistics, accumulators and lse stay fp32.
//
// Bound on the H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s; the exp2 unit
// (MUFU) does 16 ex2 a clock per SM, 132 SMs at 1.98 GHz = 4.18e12 ex2/s).
// At the binaural level-2 shape (2B = 32, N = M = 16384, dk = 16, dv = 128)
// the products are 2*32*16384^2*(16 + 128) = 2.47e12 FLOP = 2.50 ms, the
// softmax 8.6e9 ex2 = 2.05 ms, the bytes (q, k, v, o, lse once) ~0.3 GB =
// 0.09 ms: bound by tensor operations, with ex2 close behind. Level 5
// (N = 256) is bound by bytes.
//
// Design (bf16; the plan in ops/cuda/flash_attention.py picks the tiles).
// One warpgroup (128 threads) owns 64 q rows and a dv slice of DVS <= 256
// columns (dv <= 256: one slice; dv 512: two of 256). The earlier mma.sync
// design lost most of its time to shared-memory traffic: each of its four
// warps re-read every K and V fragment with its own ldmatrix (~256 B of
// shared memory per MMA). Here S = Q.K^T (m64n64) and O += P.V (m64nDVS)
// run as wgmma, which reads each B operand once per warpgroup, straight
// from the tiles TMA wrote (128/64/32-byte swizzle; V read MN-major). P goes
// from the S accumulators to the register A operand of P.V without touching
// shared memory. K/V tiles of 64 keys stream through a ring of 2-3 stages
// guarded by mbarriers; one thread issues every copy, so no thread spends
// instructions on addresses. The exp2 and the rest of the softmax of tile
// i+1 run while the tensor cores do P.V of tile i (S of tile i+1 is issued
// first, then P.V of tile i; waiting for one group leaves P.V in flight),
// and 2-3 blocks share an SM, whose products and softmax also interleave.
// No atomics: an answer is bit-reproducible from run to run. Ragged N and
// M: TMA reads rows past the end as zeros, keys past M get -inf.
// Measured by chip_smoke.py on an H100 80GB HBM3 at its 700 W limit: 5.73
// ms at the level-2 shape (2.3x the bound, 432 TFLOP/s; the mma.sync design
// took 11.5 ms), 0.73 ms at level 3 (1.59 before); PyTorch's fused SDPA (its
// memory-efficient backend, the only one that takes dk != dv) takes 19.2 ms
// at level 2. Removing the exp2 altogether would save 7-10 % at level 2 and
// the O rescale 11 % (tools/flash_ablation.py, same card): neither alone is
// the limit; the chain of waits inside each warpgroup is (PERF.md).
//
// Widths. The TPU kernel zero-pads dk to 128 lanes and takes any width.
// Here the wrapper zero-pads q, k (and v) to a multiple of 8 columns, since
// a TMA row stride must be a multiple of 16 bytes (zero columns change no
// score), and dk is padded again in the tile to DKP = 16, 32, 64 or 128
// (QkRows): up to 64 a q/k row is one swizzle span, at 128 a tile is two
// 64-column boxes with the k-steps crossing from one to the other, the
// layout V's sub-tiles already had. dv is sliced (<= 256 a block), so it
// has no limit.
//
// fp32 runs a CUDA-core tiling (256 threads, 4 q rows x 4 keys of S and 4
// rows x 8 columns of O a thread, P through shared memory, dk in chunks of
// 64 through shared memory): it serves the parity checks only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kBQ = 64;    // q rows per block (wgmma's M; also the fp32 path's)
constexpr int kBK = 64;    // keys per k/v tile
constexpr int kDVS = 128;  // dv columns per block of the fp32 forward
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// q/k rows: dk padded to DKP = 16, 32, 64 or 128 columns. Up to 64 a row is
// one swizzle span of 2*DKP bytes and a 64-row tile one TMA box; at 128 a
// row is wider than the 128-byte swizzle, so a tile is two boxes of 64
// columns, 64 rows x 128 bytes = 8 KB apart (the layout of V's sub-tiles).
template <int DKP>
struct QkRows {
  static constexpr int SW = DKP <= 64 ? 2 * DKP : 128;  // swizzle span, bytes
  static constexpr int BOXES = 2 * DKP / SW;            // boxes of SW / 2 columns a tile
  static constexpr int BOX_BYTES = 64 * SW;             // one box of a 64-row tile
  // bytes from a K-major descriptor's start to k-step ks (16 columns)
  __host__ __device__ static constexpr uint32_t kstep(int ks) { return (32 * ks / SW) * BOX_BYTES + (32 * ks) % SW; }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The accumulator layout of a 64-column wgmma (32 floats a thread: columns
// 8j + 2t, +1 of rows g and g + 8 in d[4j..4j+3]) as the four A fragments
// of the next product's k-steps of 16, rounded to bf16.
__device__ __forceinline__ void acc_to_a(const float (&d)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
    a[kk][1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
    a[kk][2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
    a[kk][3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
  }
}

// ---------------------------------------------------------------------------
// B2, bf16: wgmma + TMA
// ---------------------------------------------------------------------------

// Shared memory of the forward, in bytes from the 1024-aligned base: the Q
// tile, `stages` K tiles, `stages` V tiles (DVS / 64 sub-tiles of 64 x 64,
// 8 KB each), then 1 + stages mbarriers. The plan mirrors this.
struct FwdLayout {
  int k_off, v_off, bar_off, k_stage, v_stage;
  size_t bytes;
};

__host__ __device__ inline FwdLayout fwd_layout(int dkp, int dvs, int stages) {
  FwdLayout L;
  L.k_stage = kBK * dkp * 2;  // 2, 4 or 8 KB
  L.v_stage = kBK * dvs * 2;  // a multiple of 8 KB
  L.k_off = kBQ * dkp * 2;
  L.v_off = L.k_off + stages * L.k_stage;
  L.bar_off = L.v_off + stages * L.v_stage;
  L.bytes = size_t(L.bar_off) + 8 * (1 + stages) + 1024;  // + slack to align the base
  return L;
}

// grid (q_tiles * n_slices, B); block 128 (one warpgroup). DKP = dk padded
// to 16, 32, 64 or 128 (QkRows), DVS = the dv slice padded to a multiple of
// 64.
template <int DKP, int DVS>
__global__ void __launch_bounds__(128, DVS <= 128 ? 3 : 2)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int N, int M, int dv, int n_slices, int stages,
                       float c /* scale * log2(e) */) {
  using namespace sm90;
  using R = QkRows<DKP>;
  constexpr int SW = R::SW;
  constexpr uint32_t kTileBytes = kBK * DKP * 2, vTileBytes = kBK * DVS * 2;
  const FwdLayout L = fwd_layout(DKP, DVS, stages);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L.bar_off);  // [0] Q, [1 + s] stage s

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int slice = blockIdx.x % n_slices;
  const int q0 = (blockIdx.x / n_slices) * kBQ;
  const int col0 = slice * DVS;
  const int b = blockIdx.y;
  const int n_tiles = (M + kBK - 1) / kBK;

  auto issue = [&](int tile, int st) {
    uint64_t* bar = bars + 1 + st;
    mbar_arrive_expect_tx(bar, kTileBytes + vTileBytes);
#pragma unroll
    for (int h = 0; h < R::BOXES; ++h)
      tma_load_3d(sm + L.k_off + st * L.k_stage + h * R::BOX_BYTES, &tk, bar, h * SW / 2,
                  tile * kBK, b);
#pragma unroll
    for (int j = 0; j < DVS / 64; ++j)
      tma_load_3d(sm + L.v_off + st * L.v_stage + j * 8192, &tv, bar, col0 + 64 * j, tile * kBK, b);
  };
  if (tid == 0) {
    for (int s = 0; s <= stages; ++s) mbar_init(bars + s, 1);
    fence_mbar_init();
    mbar_arrive_expect_tx(bars, kBQ * DKP * 2);
    for (int h = 0; h < R::BOXES; ++h) tma_load_3d(sm + h * R::BOX_BYTES, &tq, bars, h * SW / 2, q0, b);
    for (int s = 0; s < stages && s < n_tiles; ++s) issue(s, s);
  }
  __syncthreads();

  const uint64_t q_desc = make_desc(sm, 16, 8 * SW, SW);
  // S = Q.K^T: both K-major, one k-step of 16 per 32 bytes of row
  auto qk = [&](float (&s)[32], int st) {
    const uint64_t k_desc = make_desc(sm + L.k_off + st * L.k_stage, 16, 8 * SW, SW);
#pragma unroll
    for (int ks = 0; ks < DKP / 16; ++ks)
      wgmma_ss<64, 0, 0>(s, desc_advance(q_desc, R::kstep(ks)), desc_advance(k_desc, R::kstep(ks)),
                         ks > 0);
  };
  float acc[DVS / 2];
#pragma unroll
  for (int i = 0; i < DVS / 2; ++i) acc[i] = 0.f;
  // O += P.V: V read MN-major, 16 keys (2 KB of rows) a k-step, sub-tiles 8 KB apart
  auto pv = [&](const uint32_t (&pa)[4][4], int st) {
    const uint64_t v_desc = make_desc(sm + L.v_off + st * L.v_stage, 8192, 1024, 128);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<DVS, 1>(acc, pa[kk], desc_advance(v_desc, 2048 * kk), 1);
  };

  float m_lo = -INFINITY, m_hi = -INFINITY;  // running max of the raw scores (rows g, g + 8)
  float l_lo = 0.f, l_hi = 0.f;              // this thread's part of the running sum
  // online softmax of tile `tile` in place (s becomes p); returns the factors
  // that rescale what the accumulator held before this tile
  auto softmax = [&](float (&s)[32], int tile, float& alpha_lo, float& alpha_hi) {
    if ((tile + 1) * kBK > M) {  // ragged last tile: keys past M get no weight
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = tile * kBK + j * 8 + 2 * t;
        if (key >= M) s[4 * j] = s[4 * j + 2] = -INFINITY;
        if (key + 1 >= M) s[4 * j + 1] = s[4 * j + 3] = -INFINITY;
      }
    }
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[4 * j], s[4 * j + 1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    // a row's 64 scores lie on the 4 threads of a quad
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
    // every tile holds at least one key < M, so mx is finite
    const float sc_lo = mx_lo * c, sc_hi = mx_hi * c;
    alpha_lo = fast_exp2(m_lo * c - sc_lo);  // 0 on the first tile
    alpha_hi = fast_exp2(m_hi * c - sc_hi);
    m_lo = mx_lo;
    m_hi = mx_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[4 * j] = fast_exp2(fmaf(s[4 * j], c, -sc_lo));
      s[4 * j + 1] = fast_exp2(fmaf(s[4 * j + 1], c, -sc_lo));
      s[4 * j + 2] = fast_exp2(fmaf(s[4 * j + 2], c, -sc_hi));
      s[4 * j + 3] = fast_exp2(fmaf(s[4 * j + 3], c, -sc_hi));
      sum_lo += s[4 * j] + s[4 * j + 1];
      sum_hi += s[4 * j + 2] + s[4 * j + 3];
    }
    l_lo = l_lo * alpha_lo + sum_lo;
    l_hi = l_hi * alpha_hi + sum_hi;
  };

  uint32_t pa[4][4];  // P of the tile whose P.V is next, bf16 A fragments
  mbar_wait(bars, 0);
  {
    float s[32], alo, ahi;
    mbar_wait(bars + 1, 0);
    wgmma_fence();
    qk(s, 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    softmax(s, 0, alo, ahi);  // acc is zero: nothing to rescale
    acc_to_a(s, pa);
  }
  for (int it = 1; it < n_tiles; ++it) {
    const int st = it % stages, prev = (it - 1) % stages;
    mbar_wait(bars + 1 + st, (it / stages) & 1);
    float s[32], alpha_lo, alpha_hi;
    fence_regs(acc);
    wgmma_fence();
    qk(s, st);  // S of this tile first ...
    wgmma_commit();
    pv(pa, prev);  // ... then P.V of the last one
    wgmma_commit();
    wgmma_wait<1>();  // S has landed; P.V runs on under the softmax
    fence_regs(s);
    softmax(s, it, alpha_lo, alpha_hi);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
    __syncthreads();  // every warp is done with stage `prev`
    if (tid == 0 && it - 1 + stages < n_tiles) issue(it - 1 + stages, prev);
#pragma unroll
    for (int j = 0; j < DVS / 8; ++j) {
      acc[4 * j] *= alpha_lo;
      acc[4 * j + 1] *= alpha_lo;
      acc[4 * j + 2] *= alpha_hi;
      acc[4 * j + 3] *= alpha_hi;
    }
    acc_to_a(s, pa);
  }
  fence_regs(acc);
  wgmma_fence();
  pv(pa, (n_tiles - 1) % stages);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);

  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
  const int r_lo = q0 + warp * 16 + g, r_hi = r_lo + 8;
  __nv_bfloat16* ob = o + size_t(b) * N * dv;
#pragma unroll
  for (int j = 0; j < DVS / 8; ++j) {
    const int col = col0 + j * 8 + 2 * t;
    if (col < dv) {
      if (r_lo < N)
        *reinterpret_cast<uint32_t*>(ob + size_t(r_lo) * dv + col) =
            pack_bf16(acc[4 * j] * inv_lo, acc[4 * j + 1] * inv_lo);
      if (r_hi < N)
        *reinterpret_cast<uint32_t*>(ob + size_t(r_hi) * dv + col) =
            pack_bf16(acc[4 * j + 2] * inv_hi, acc[4 * j + 3] * inv_hi);
    }
  }
  if (slice == 0 && t == 0) {
    if (r_lo < N) lse[size_t(b) * N + r_lo] = (m_lo * c + log2f(l_lo)) * kLn2;
    if (r_hi < N) lse[size_t(b) * N + r_hi] = (m_hi * c + log2f(l_hi)) * kLn2;
  }
}

template <int DKP, int DVS>
cudaError_t launch_fwd_wgmma(dim3 grid, size_t smem, cudaStream_t stream, const void* q,
                             const void* k, const void* v, void* o, float* lse, int B, int N,
                             int M, int dk, int dv, int n_slices, int stages, float c) {
  constexpr int SW = QkRows<DKP>::SW;
  CUtensorMap tq, tk, tv;
  cudaError_t err = sm90::make_map_bf16(&tq, q, B, N, dk, kBQ, SW / 2, SW);
  if (err == cudaSuccess) err = sm90::make_map_bf16(&tk, k, B, M, dk, kBK, SW / 2, SW);
  if (err == cudaSuccess) err = sm90::make_map_bf16(&tv, v, B, M, dv, kBK, 64, 128);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<DKP, DVS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  flash_fwd_wgmma_kernel<DKP, DVS><<<grid, 128, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, N, M, dv, n_slices, stages, c);
  return cudaGetLastError();
}

template <int DKP>
cudaError_t launch_fwd_wgmma_dvs(int dvs, dim3 grid, size_t smem, cudaStream_t stream,
                                 const void* q, const void* k, const void* v, void* o, float* lse,
                                 int B, int N, int M, int dk, int dv, int n_slices, int stages,
                                 float c) {
  switch (dvs) {
    case 64: return launch_fwd_wgmma<DKP, 64>(grid, smem, stream, q, k, v, o, lse, B, N, M, dk, dv, n_slices, stages, c);
    case 128: return launch_fwd_wgmma<DKP, 128>(grid, smem, stream, q, k, v, o, lse, B, N, M, dk, dv, n_slices, stages, c);
    case 192: return launch_fwd_wgmma<DKP, 192>(grid, smem, stream, q, k, v, o, lse, B, N, M, dk, dv, n_slices, stages, c);
    case 256: return launch_fwd_wgmma<DKP, 256>(grid, smem, stream, q, k, v, o, lse, B, N, M, dk, dv, n_slices, stages, c);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// B2, fp32: a tiling on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreadsF32 = 256;  // 16 x 16: ty owns rows 4ty..4ty+3
constexpr int kDkChunk = 64;      // q/k columns a shared-memory tile holds (fp32 paths)
constexpr int kRowStride = kDkChunk + 1;  // q/k/p rows in floats (odd: no bank conflicts)
constexpr int kMaxHeadDk = 128;   // the largest dk: the wgmma paths' dkp

struct F32Smem {
  static constexpr int q = 0;
  static constexpr int k = q + kBQ * kRowStride;
  static constexpr int p = k + kBK * kRowStride;
  static constexpr int v = p + kBQ * kRowStride;
  static constexpr size_t bytes = size_t(v + kBK * kDVS) * sizeof(float);
};

// rows [r0, r0 + rows) x columns [d0, d0 + kDkChunk) of a row-major [n, dk]
// matrix into s[rows][kRowStride], zeros outside it
__device__ __forceinline__ void load_chunk(float* s, const float* x, int rows, int r0, int n,
                                           int d0, int dk, int tid, int threads) {
  const int w = min(kDkChunk, dk - d0);
  for (int i = tid; i < rows * kDkChunk; i += threads) {
    const int r = i / kDkChunk, d = i - r * kDkChunk;
    s[r * kRowStride + d] = r0 + r < n && d < w ? x[size_t(r0 + r) * dk + d0 + d] : 0.f;
  }
}

// S sums over dk in chunks of 64 columns (the q tile stays in shared memory
// when dk <= 64, else each chunk of q is loaded again beside k's).
__global__ void __launch_bounds__(kThreadsF32)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int N, int M, int dk, int dv, int n_slices,
                     float c) {
  extern __shared__ float smem_f[];
  float* qs = smem_f + F32Smem::q;
  float* kts = smem_f + F32Smem::k;
  float* ps = smem_f + F32Smem::p;
  float* vts = smem_f + F32Smem::v;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int slice = blockIdx.x % n_slices;
  const int q0 = (blockIdx.x / n_slices) * kBQ;
  const int col0 = slice * kDVS;
  const size_t b = blockIdx.y;
  const float* qb = q + b * N * dk;
  const float* kb = k + b * M * dk;
  const float* vb = v + b * M * dv;
  const bool one_chunk = dk <= kDkChunk;

  if (one_chunk) load_chunk(qs, qb, kBQ, q0, N, 0, dk, tid, kThreadsF32);

  float acc[4][8];
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  for (int kv0 = 0; kv0 < M; kv0 += kBK) {
    // S: rows 4ty+i, keys tx+16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d0 = 0; d0 < dk; d0 += kDkChunk) {
      __syncthreads();  // the previous chunk (and tile's k, v and p) is consumed
      if (!one_chunk) load_chunk(qs, qb, kBQ, q0, N, d0, dk, tid, kThreadsF32);
      load_chunk(kts, kb, kBK, kv0, M, d0, dk, tid, kThreadsF32);
      if (d0 == 0) {
        for (int i = tid; i < kBK * kDVS; i += kThreadsF32) {
          const int r = i / kDVS, cc = i - r * kDVS;
          vts[i] = kv0 + r < M && col0 + cc < dv ? vb[size_t(kv0 + r) * dv + col0 + cc] : 0.f;
        }
      }
      __syncthreads();
      const int w = min(kDkChunk, dk - d0);
      for (int d = 0; d < w; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = qs[(4 * ty + i) * kRowStride + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = kts[(tx + 16 * j) * kRowStride + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (kv0 + tx + 16 * j >= M)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = -INFINITY;

    // online softmax; a row's 64 scores lie on 16 lanes of one warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = m_run[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // the accurate exp2f, and no rescale while the max holds: with
      // ex2.approx's rounding compounding once a tile, lse at M = 16384 was
      // 3.2e-4 off float64 on an H100 (4.5e-6 now; the plain fp32
      // version's 3.2e-6)
      const float sc = mx * c;
      const float alpha = mx == m_run[i] ? 1.f : exp2f(m_run[i] * c - sc);
      m_run[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(fmaf(s[i][j], c, -sc));
        ps[(4 * ty + i) * kRowStride + tx + 16 * j] = p;
        sum += p;
      }
      l_run[i] = l_run[i] * alpha + sum;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // O += P.V: rows 4ty+i, columns col0 + tx + 16j; the tile's 64 keys sum
    // apart first, so that no sum runs over more than 64 terms in sequence
    float part[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) part[i][j] = 0.f;
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], vv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(4 * ty + i) * kRowStride + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) vv[j] = vts[kk * kDVS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) part[i][j] = fmaf(pv[i], vv[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] += part[i][j];
  }

  float* ob = o + b * N * dv;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float l = l_run[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    const int r = q0 + 4 * ty + i;
    if (r < N) {
      const float inv = 1.f / l;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = col0 + tx + 16 * j;
        if (col < dv) ob[size_t(r) * dv + col] = acc[i][j] * inv;
      }
      if (slice == 0 && tx == 0) lse[b * N + r] = (m_run[i] * c + log2f(l)) * kLn2;
    }
  }
}

// ===========================================================================
// Kernel B3: the backward.
//
// Replaces the TPU kernel audiodepth_tpu/ops/pallas/flash_attention.py:148
// (_bwd_kernel, via _flash_bwd). With D = rowsum(do*o) in fp32:
//   p  = exp(q.k^T.scale - lse)       dv = p^T.do
//   ds = p*(do.v^T - D)               dk = ds^T.q.scale     dq = ds.k.scale
// p is recomputed as exp2(s*c - lse*log2e) on the fp32 scores (c =
// scale*log2e); p and ds are rounded to bf16 before their products, as the
// TPU kernel does; dq, dk, dv accumulate in fp32 and are cast to the input
// dtype.
//
// Bound on the H100 SXM. At the level-2 shape (2B = 32, N = M = 16384,
// dk = 16, dv = 128) the five products (s, p^T.do, do.v^T, ds^T.q, ds.k) are
// 2*32*16384^2*(3*16 + 2*128) = 5.22e12 FLOP = 5.28 ms at 989 TFLOP/s, the
// exp2 of p 8.6e9 = 2.05 ms, the bytes ~0.5 GB = 0.15 ms: bound by tensor
// operations. Level 3 is 6.5e11 FLOP = 0.66 ms; level 5 is bound by bytes.
//
// Design (flash_bwd_wgmma_kernel, bf16). The first port's mma.sync kernel
// lost its time to shared-memory traffic (its four warps each re-read every
// B operand with ldmatrix, ~300 B of shared memory per MMA), to 2.1e9
// scalar fp32 atomics for dq at level 2, to two __syncthreads and no
// overlap per q tile, and at dv 256 and 512 to further blocks per key tile
// that recomputed S and exp2 for their dv slices. Here one warpgroup owns 64
// keys and all of dv (two warpgroups share dv above 256), and sweeps the q
// tiles:
//   - K and V load once by TMA and stay in shared memory; each q tile's Q,
//     dO (TMA, zero past N) and its lse*log2e and D (one bulk copy of a
//     padded [B, q_tiles, 2, 64] fp32 buffer) stream through a ring of 1-2
//     stages guarded by mbarriers, issued by one thread.
//   - S^T = K.Q^T and dP^T = V.dO^T run as wgmma (m64n64, both K-major) and
//     are issued together; the exp2 of P^T runs while dP^T is in flight.
//   - dV += P^T.dO and dK += dS^T.Q run as wgmma with P^T and dS^T as
//     register A operands (the accumulators of S^T and dP^T, rounded to
//     bf16), dO and Q read MN-major; dk and dv stay in fp32 registers for
//     the sweep. dv <= 256 fits one warpgroup's registers, so no S or exp2
//     is computed twice there. Above 256 (levels 4-5, dv 512) two
//     warpgroups each take half of dv over the same keys, both compute S^T
//     and P^T, the second hands its part of dP^T to the first through
//     shared memory, the first computes dS and dQ and the second dK.
//   - dQ = dS.K reads dS^T from shared memory (written in the 128-byte
//     swizzle, read MN-major) and K (MN-major) with one wgmma per k-step;
//     the 64 x dk fp32 tile goes to shared memory and is added to the
//     zeroed fp32 [B, N, dk] dq with one cp.reduce.async.bulk .add.f32 per
//     tile, double-buffered, in place of 64*dk scalar atomics. The order of
//     those adds across key tiles varies, so dq's last bits vary from run
//     to run; dk and dv do not.
// D = rowsum(do*o) and lse*log2e come from flash_bwd_prep_kernel, which
// also writes the padding (zeros: q rows past N get p = 1 from zero q rows
// but dp = ds = 0 from zero dO rows, and add nothing).
// Measured by chip_smoke.py on an H100 80GB HBM3 at its 700 W limit: 12.15
// ms at level 2 (2.3x the bound, 430 TFLOP/s; the mma.sync design took 29.0
// ms), 1.64 / 0.39 / 0.060 ms at levels 3-5 (6.49 / 1.08 / 0.144 before);
// SDPA's memory-efficient backward takes 72.4 ms at level 2. Without its
// exp2 B3 would save 2 % at level 2, without the dq reduce 3 % (9 % at
// level 3; tools/flash_ablation.py).
//
// Beyond dkp 64 or dv 512 a block cannot hold dK, dV and the score tiles in
// registers: flash_bwd_split_kernel (below) splits a key tile's work over
// dV blocks and one dK/dQ block. bwd_plan picks the design by shape.
//
// fp32 runs on the CUDA cores in full fp32 (flash_bwd_f32_kernel, any
// width): a 256-thread block owns 32 keys and 64 output columns, sweeps
// 32-row q tiles, and passes P and dS through shared memory; dq takes
// scalar atomics.
// ===========================================================================

constexpr int kBwdBK = 64;        // keys per block
constexpr int kBwdBQ = 64;        // q rows per sweep step
constexpr int kBwdThreads = 128;  // 4 warps (one warpgroup)
constexpr int kBwdMaxDv = 512;
constexpr int kStatBytes = 2 * kBwdBQ * 4;  // lse*log2e and D of one q tile

// D = rowsum(do*o) and lse*log2e of every q row into stat [B, q_tiles, 2,
// 64], zero past N. grid (q_tiles, B); block 256: a warp per row, 8 at once.
__global__ void __launch_bounds__(256)
flash_bwd_prep_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse, float* __restrict__ stat, int N, int dv) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t b = blockIdx.y;
  float* st = stat + (b * gridDim.x + blockIdx.x) * (2 * kBwdBQ);
  for (int r = warp; r < kBwdBQ; r += 8) {
    const int row = blockIdx.x * kBwdBQ + r;
    float d = 0.f;
    if (row < N) {
      const uint4* ob = reinterpret_cast<const uint4*>(o + (b * N + row) * dv);
      const uint4* db = reinterpret_cast<const uint4*>(dout + (b * N + row) * dv);
      for (int i = lane; i < dv / 8; i += 32) {
        const uint4 x = ob[i], y = db[i];
        const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&x);
        const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 xf = __bfloat1622float2(xs[j]), yf = __bfloat1622float2(ys[j]);
          d = fmaf(xf.x, yf.x, fmaf(xf.y, yf.y, d));
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
    if (lane == 0) {
      st[r] = row < N ? lse[b * N + row] * kLog2e : 0.f;
      st[kBwdBQ + r] = d;
    }
  }
}

// Shared memory of the wgmma backward, in bytes from the 1024-aligned base:
// K, V (dvt / 64 sub-tiles of 8 KB, dvt = WGS * DVS), `stages` Q and dO
// tiles, dS^T (64 x 64 bf16), two fp32 dq tiles of 64 x dk, `stages` lse/D
// tiles, with two warpgroups the 64 x 64 fp32 exchange of dP^T, then 1 +
// stages mbarriers. The plan mirrors this.
struct BwdWgLayout {
  int v_off, q_off, do_off, ds_off, dq_off, xp_off, stat_off, bar_off, q_stage, do_stage, dq_buf;
  size_t bytes;
};

__host__ __device__ inline BwdWgLayout bwd_wg_layout(int dkp, int dvt, int dk, int stages,
                                                     int wgs) {
  BwdWgLayout L;
  L.q_stage = kBwdBQ * dkp * 2;
  L.do_stage = kBwdBQ * dvt * 2;
  L.dq_buf = kBwdBQ * dk * 4;
  L.v_off = kBwdBK * dkp * 2;
  L.q_off = L.v_off + kBwdBK * dvt * 2;
  L.do_off = L.q_off + stages * L.q_stage;
  L.ds_off = L.do_off + stages * L.do_stage;
  L.dq_off = L.ds_off + kBwdBK * kBwdBQ * 2;
  L.xp_off = L.dq_off + 2 * L.dq_buf;
  L.stat_off = L.xp_off + (wgs == 2 ? kBwdBK * kBwdBQ * 4 : 0);
  L.bar_off = L.stat_off + stages * kStatBytes;
  L.bytes = size_t(L.bar_off) + 8 * (1 + stages) + 1024;  // + slack to align the base
  return L;
}

// grid (key_tiles, B); block 128 * WGS. DKP = dk padded to 16, 32 or 64;
// DVS = the dv columns of one warpgroup, padded to a multiple of 64 (<= 256).
// WGS = 2 splits dv across two warpgroups over the same 64 keys: each one
// computes S^T, P^T, its part of dP^T and its half of dV; the second hands
// its part of dP^T to the first through shared memory; the first computes
// dS and dQ, the second dK from dS^T in shared memory (so neither holds dv,
// dk and dP^T at once beyond what one warpgroup of dv 256 holds).
template <int DKP, int DVS, int WGS>
__global__ void __launch_bounds__(kBwdThreads * WGS, WGS == 1 ? 2 : 1)
flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                       const float* __restrict__ stat, float* __restrict__ dq,
                       __nv_bfloat16* __restrict__ dk_out, __nv_bfloat16* __restrict__ dv_out, int N,
                       int M, int dk, int dv, int stages, float c, float scale) {
  using namespace sm90;
  constexpr int SW = 2 * DKP;
  constexpr int SUB = DVS / 64;  // 64-column sub-tiles of one warpgroup's dv
  constexpr uint32_t qBytes = kBwdBQ * DKP * 2, doBytes = kBwdBQ * DVS * WGS * 2;
  const BwdWgLayout L = bwd_wg_layout(DKP, DVS * WGS, dk, stages, WGS);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  uint8_t* ds_s = sm + L.ds_off;
  float* xp = reinterpret_cast<float*>(sm + L.xp_off);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L.bar_off);  // [0] K/V, [1 + s] stage s

  const int wg = WGS == 1 ? 0 : threadIdx.x / kBwdThreads;  // this warpgroup
  const bool lead = wg == 0;                                // computes dS and dQ
  const bool dk_owner = WGS == 1 || wg == 1;                // accumulates dK
  const int tid = threadIdx.x % kBwdThreads, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kBwdBK;
  const int b = blockIdx.y;
  const int n_qt = (N + kBwdBQ - 1) / kBwdBQ;
  const float* statb = stat + size_t(b) * n_qt * (2 * kBwdBQ);

  auto issue = [&](int tile, int st) {
    uint64_t* bar = bars + 1 + st;
    mbar_arrive_expect_tx(bar, qBytes + doBytes + kStatBytes);
    tma_load_3d(sm + L.q_off + st * L.q_stage, &tq, bar, 0, tile * kBwdBQ, b);
#pragma unroll
    for (int j = 0; j < SUB * WGS; ++j)
      tma_load_3d(sm + L.do_off + st * L.do_stage + j * 8192, &tdo, bar, 64 * j, tile * kBwdBQ, b);
    bulk_load(sm + L.stat_off + st * kStatBytes, statb + size_t(tile) * (2 * kBwdBQ), kStatBytes,
              bar);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s <= stages; ++s) mbar_init(bars + s, 1);
    fence_mbar_init();
    mbar_arrive_expect_tx(bars, kBwdBK * (DKP + DVS * WGS) * 2);
    tma_load_3d(sm, &tk, bars, 0, k0, b);
#pragma unroll
    for (int j = 0; j < SUB * WGS; ++j)
      tma_load_3d(sm + L.v_off + j * 8192, &tv, bars, 64 * j, k0, b);
    for (int s = 0; s < stages && s < n_qt; ++s) issue(s, s);
  }
  __syncthreads();

  // K: A of S^T (K-major, k-steps of 32 bytes) and B of dQ (MN-major,
  // k-steps of 16 rows) share one descriptor; V (this warpgroup's columns):
  // A of dP^T (K-major, 64-column sub-tiles); dS^T: A of dQ (MN-major, 16
  // rows = 2 KB a k-step)
  const uint64_t k_desc = make_desc(sm, 16, 8 * SW, SW);
  const uint64_t v_desc = make_desc(sm + L.v_off + wg * SUB * 8192, 16, 1024, 128);
  const uint64_t ds_desc = make_desc(ds_s, 16, 1024, 128);
  const int krow = warp * 16 + g;  // this thread's keys: krow, krow + 8
  const bool key_lo_ok = k0 + krow < M, key_hi_ok = k0 + krow + 8 < M;

  float dv_acc[DVS / 2], dk_acc[DKP / 2];
#pragma unroll
  for (int i = 0; i < DVS / 2; ++i) dv_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DKP / 2; ++i) dk_acc[i] = 0.f;

  mbar_wait(bars, 0);
  for (int it = 0; it < n_qt; ++it) {
    const int st = it % stages;
    mbar_wait(bars + 1 + st, (it / stages) & 1);
    const uint8_t* q_s = sm + L.q_off + st * L.q_stage;
    const uint8_t* do_s = sm + L.do_off + st * L.do_stage + wg * SUB * 8192;
    const float* l2 = reinterpret_cast<const float*>(sm + L.stat_off + st * kStatBytes);
    const float* dd = l2 + kBwdBQ;
    const uint64_t q_desc = make_desc(q_s, 16, 8 * SW, SW);
    const uint64_t do_kdesc = make_desc(do_s, 16, 1024, 128);
    const uint64_t do_mndesc = make_desc(do_s, 8192, 1024, 128);

    // S^T = K.Q^T and (this warpgroup's part of) dP^T = V.dO^T, issued together
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DKP / 16; ++ks)
      wgmma_ss<64, 0, 0>(s, desc_advance(k_desc, 32 * ks), desc_advance(q_desc, 32 * ks), ks > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DVS / 16; ++kk) {
      const uint32_t off = (kk / 4) * 8192 + (kk % 4) * 32;
      wgmma_ss<64, 0, 0>(dp, desc_advance(v_desc, off), desc_advance(do_kdesc, off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);
    // P^T = exp2(S^T*c - lse*log2e) while dP^T is in flight; keys past M get none
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j * 8 + 2 * t;
      const float l0 = l2[col], l1 = l2[col + 1];
      s[4 * j] = key_lo_ok ? fast_exp2(fmaf(s[4 * j], c, -l0)) : 0.f;
      s[4 * j + 1] = key_lo_ok ? fast_exp2(fmaf(s[4 * j + 1], c, -l1)) : 0.f;
      s[4 * j + 2] = key_hi_ok ? fast_exp2(fmaf(s[4 * j + 2], c, -l0)) : 0.f;
      s[4 * j + 3] = key_hi_ok ? fast_exp2(fmaf(s[4 * j + 3], c, -l1)) : 0.f;
    }
    wgmma_wait<0>();
    fence_regs(dp);
    if (WGS == 2) {  // dP^T = the sum of both warpgroups' parts, in the lead one
      if (!lead) {
#pragma unroll
        for (int i = 0; i < 32; ++i) xp[i * kBwdThreads + tid] = dp[i];
      }
      __syncthreads();
      if (lead) {
#pragma unroll
        for (int i = 0; i < 32; ++i) dp[i] += xp[i * kBwdThreads + tid];
      }
    }
    if (lead) {
      // dS^T = P^T (dP^T - D)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = j * 8 + 2 * t;
        const float d0 = dd[col], d1 = dd[col + 1];
        dp[4 * j] = s[4 * j] * (dp[4 * j] - d0);
        dp[4 * j + 1] = s[4 * j + 1] * (dp[4 * j + 1] - d1);
        dp[4 * j + 2] = s[4 * j + 2] * (dp[4 * j + 2] - d0);
        dp[4 * j + 3] = s[4 * j + 3] * (dp[4 * j + 3] - d1);
      }
    }
    uint32_t pa[4][4], da[4][4];
    acc_to_a(s, pa);
    if (lead) acc_to_a(dp, da);

    // dV += P^T.dO and, with one warpgroup, dK += dS^T.Q from registers (dO
    // and Q MN-major, 16 q rows a k-step)
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<DVS, 1>(dv_acc, pa[kk], desc_advance(do_mndesc, 2048 * kk), 1);
    if (WGS == 1) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<DKP, 1>(dk_acc, da[kk], desc_advance(q_desc, 16 * SW * kk), 1);
    }
    wgmma_commit();

    if (lead) {
      // dS^T (keys x 64 q, bf16) to shared memory in the 128-byte swizzle:
      // the 16-byte chunk j of row r sits at chunk j ^ (r % 8)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = 2 * kk + h;
          const int r0 = krow, r1 = krow + 8;
          *reinterpret_cast<uint32_t*>(ds_s + r0 * 128 + ((j ^ (r0 & 7)) << 4) + 4 * t) =
              da[kk][2 * h];
          *reinterpret_cast<uint32_t*>(ds_s + r1 * 128 + ((j ^ (r1 & 7)) << 4) + 4 * t) =
              da[kk][2 * h + 1];
        }
      }
      fence_proxy_async();
    }
    __syncthreads();  // dS^T of every warp is in shared memory

    float dqa[DKP / 2];
    if (lead) {  // dQ = dS.K over the block's 64 keys
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<DKP, 1, 1>(dqa, desc_advance(ds_desc, 2048 * kk),
                            desc_advance(k_desc, 16 * SW * kk), kk > 0);
      wgmma_commit();
    } else if (WGS == 2) {  // dK += dS^T.Q, dS^T read K-major from shared memory
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<DKP, 0, 1>(dk_acc, desc_advance(ds_desc, 32 * kk),
                            desc_advance(q_desc, 16 * SW * kk), 1);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(dqa);
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_regs(pa);
    fence_regs(da);

    // the 64 x dk fp32 tile of dq (scaled) to shared memory, then one bulk add
    float* dq_s = reinterpret_cast<float*>(sm + L.dq_off + (it & 1) * L.dq_buf);
    if (lead) {
      const int qr = warp * 16 + g;
#pragma unroll
      for (int j = 0; j < DKP / 8; ++j) {
        const int col = j * 8 + 2 * t;
        if (col < dk) {
          *reinterpret_cast<float2*>(dq_s + qr * dk + col) =
              make_float2(dqa[4 * j] * scale, dqa[4 * j + 1] * scale);
          *reinterpret_cast<float2*>(dq_s + (qr + 8) * dk + col) =
              make_float2(dqa[4 * j + 2] * scale, dqa[4 * j + 3] * scale);
        }
      }
      fence_proxy_async();
    }
    __syncthreads();  // the dq tile is written; stage `st`, dS^T and the exchange are consumed
    if (threadIdx.x == 0) {
      const int rows = min(kBwdBQ, N - it * kBwdBQ);
      bulk_reduce_add_f32(dq + (size_t(b) * N + size_t(it) * kBwdBQ) * dk, dq_s,
                          uint32_t(rows * dk * 4));
      bulk_commit();
      bulk_wait_read<1>();  // the other dq buffer is free for the next tile
      if (it + stages < n_qt) issue(it + stages, st);
    }
  }
  if (threadIdx.x == 0) bulk_wait_all();

  const int key_lo = k0 + krow, key_hi = key_lo + 8;
  if (dk_owner) {
    __nv_bfloat16* dkb = dk_out + size_t(b) * M * dk;
#pragma unroll
    for (int j = 0; j < DKP / 8; ++j) {
      const int col = j * 8 + 2 * t;
      if (col < dk) {
        if (key_lo < M)
          *reinterpret_cast<uint32_t*>(dkb + size_t(key_lo) * dk + col) =
              pack_bf16(dk_acc[4 * j] * scale, dk_acc[4 * j + 1] * scale);
        if (key_hi < M)
          *reinterpret_cast<uint32_t*>(dkb + size_t(key_hi) * dk + col) =
              pack_bf16(dk_acc[4 * j + 2] * scale, dk_acc[4 * j + 3] * scale);
      }
    }
  }
  __nv_bfloat16* dvb = dv_out + size_t(b) * M * dv;
#pragma unroll
  for (int j = 0; j < DVS / 8; ++j) {
    const int col = wg * DVS + j * 8 + 2 * t;
    if (col < dv) {
      if (key_lo < M)
        *reinterpret_cast<uint32_t*>(dvb + size_t(key_lo) * dv + col) =
            pack_bf16(dv_acc[4 * j], dv_acc[4 * j + 1]);
      if (key_hi < M)
        *reinterpret_cast<uint32_t*>(dvb + size_t(key_hi) * dv + col) =
            pack_bf16(dv_acc[4 * j + 2], dv_acc[4 * j + 3]);
    }
  }
}

template <int DKP, int DVS, int WGS>
cudaError_t launch_bwd_wgmma(dim3 grid, size_t smem, cudaStream_t stream, const void* q,
                             const void* k, const void* v, const void* dout, const float* stat,
                             float* dq, void* dk_out, void* dv_out, int B, int N, int M, int dk,
                             int dv, int stages, float c, float scale) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = sm90::make_map_bf16(&tq, q, B, N, dk, kBwdBQ, DKP, 2 * DKP);
  if (err == cudaSuccess) err = sm90::make_map_bf16(&tk, k, B, M, dk, kBwdBK, DKP, 2 * DKP);
  if (err == cudaSuccess) err = sm90::make_map_bf16(&tv, v, B, M, dv, kBwdBK, 64, 128);
  if (err == cudaSuccess) err = sm90::make_map_bf16(&tdo, dout, B, N, dv, kBwdBQ, 64, 128);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_wgmma_kernel<DKP, DVS, WGS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  flash_bwd_wgmma_kernel<DKP, DVS, WGS><<<grid, kBwdThreads * WGS, smem, stream>>>(
      tq, tk, tv, tdo, stat, dq, static_cast<__nv_bfloat16*>(dk_out),
      static_cast<__nv_bfloat16*>(dv_out), N, M, dk, dv, stages, c, scale);
  return cudaGetLastError();
}

// one warpgroup for dv <= 256 (DVS 64..256), two above (DVS 192 or 256 each)
template <int DKP>
cudaError_t launch_bwd_wgmma_dvs(int dvs, int wgs, dim3 grid, size_t smem, cudaStream_t stream,
                                 const void* q, const void* k, const void* v, const void* dout,
                                 const float* stat, float* dq, void* dk_out, void* dv_out, int B,
                                 int N, int M, int dk, int dv, int stages, float c, float scale) {
  switch (wgs * 1000 + dvs) {
    case 1064: return launch_bwd_wgmma<DKP, 64, 1>(grid, smem, stream, q, k, v, dout, stat, dq, dk_out, dv_out, B, N, M, dk, dv, stages, c, scale);
    case 1128: return launch_bwd_wgmma<DKP, 128, 1>(grid, smem, stream, q, k, v, dout, stat, dq, dk_out, dv_out, B, N, M, dk, dv, stages, c, scale);
    case 1192: return launch_bwd_wgmma<DKP, 192, 1>(grid, smem, stream, q, k, v, dout, stat, dq, dk_out, dv_out, B, N, M, dk, dv, stages, c, scale);
    case 1256: return launch_bwd_wgmma<DKP, 256, 1>(grid, smem, stream, q, k, v, dout, stat, dq, dk_out, dv_out, B, N, M, dk, dv, stages, c, scale);
    case 2192: return launch_bwd_wgmma<DKP, 192, 2>(grid, smem, stream, q, k, v, dout, stat, dq, dk_out, dv_out, B, N, M, dk, dv, stages, c, scale);
    case 2256: return launch_bwd_wgmma<DKP, 256, 2>(grid, smem, stream, q, k, v, dout, stat, dq, dk_out, dv_out, B, N, M, dk, dv, stages, c, scale);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// B3, bf16, split: q/k rows of 128 columns, or dv above 512
// ---------------------------------------------------------------------------
//
// flash_bwd_wgmma_kernel keeps dK, dV (all of dv, over one or two
// warpgroups) and the score tiles in registers at once, which holds up to
// dkp 64 and dv 512. Past either, the work of a key tile is split over
// blocks of two classes (grid (key_tiles * (n_slices + 1), B), one
// warpgroup each), so that no block holds more than one of dK and dV:
//   - n_slices dV blocks, one per dv slice of DVS <= 256 columns: each
//     recomputes S^T = K.Q^T and P^T for every q tile and adds P^T.dO of its
//     slice into dV (the forward's structure with keys and q rows swapped);
//   - one dK/dQ block: S^T and P^T likewise, dP^T = V.dO^T as a loop over
//     dv in chunks of 64 columns (V and dO chunks streamed through a TMA ring
//     of kChunkStages, so no width of dv needs more shared memory or
//     registers), then dS^T, dK += dS^T.Q, and dQ = dS.K by halves of <= 64
//     columns into the bulk reduce-add of flash_bwd_wgmma_kernel.
// S^T and P^T are computed n_slices + 1 times per key tile: the price of
// any width. The q/k operand layouts at dkp 128 are those of V and dO
// (QkRows: two 64-column boxes, K-major k-steps across the pair, MN-major
// with the 8 KB box step as the leading byte offset).

constexpr int kChunkStages = 2;
constexpr int kChunkBytes = 2 * kBwdBK * 64 * 2;  // one V chunk, one dO chunk

struct BwdSplitLayout {
  int q_off, x_off, ds_off, dq_off, stat_off, bar_off, q_stage, do_stage, dq_buf;
  size_t bytes;
};

// Shared memory of the split backward, in bytes from the 1024-aligned base:
// K, `stages` Q tiles, then the class's own part (a dV block's `stages` dO
// slices; a dK/dQ block's chunk ring, dS^T and two fp32 dq tiles), `stages`
// lse/D tiles, and the mbarriers: [0] K, [1 + s] q stage s, [1 + stages + r]
// chunk stage r. The plan mirrors this.
__host__ __device__ inline BwdSplitLayout bwd_split_layout(int dkp, int dvs, int dk, int stages) {
  BwdSplitLayout L;
  L.q_stage = kBwdBQ * dkp * 2;
  L.do_stage = kBwdBQ * dvs * 2;
  L.dq_buf = kBwdBQ * dk * 4;
  L.q_off = kBwdBK * dkp * 2;
  L.x_off = L.q_off + stages * L.q_stage;
  L.ds_off = L.x_off + kChunkStages * kChunkBytes;
  L.dq_off = L.ds_off + kBwdBK * kBwdBQ * 2;
  const int dv_end = L.x_off + stages * L.do_stage, dq_end = L.dq_off + 2 * L.dq_buf;
  L.stat_off = dv_end > dq_end ? dv_end : dq_end;
  L.bar_off = L.stat_off + stages * kStatBytes;
  L.bytes = size_t(L.bar_off) + 8 * (1 + stages + kChunkStages) + 1024;
  return L;
}

template <int DKP, int DVS>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_split_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                       const float* __restrict__ stat, float* __restrict__ dq,
                       __nv_bfloat16* __restrict__ dk_out, __nv_bfloat16* __restrict__ dv_out, int N,
                       int M, int dk, int dv, int n_slices, int stages, float c, float scale) {
  using namespace sm90;
  using R = QkRows<DKP>;
  constexpr int SW = R::SW;
  constexpr int DKH = DKP / R::BOXES;  // dQ's columns a product: one box
  constexpr uint32_t qBytes = kBwdBQ * DKP * 2, doBytes = kBwdBQ * DVS * 2;
  const BwdSplitLayout L = bwd_split_layout(DKP, DVS, dk, stages);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L.bar_off);
  uint64_t* chunk_bars = bars + 1 + stages;

  const int role = blockIdx.x % (n_slices + 1);  // < n_slices: dV of that slice; else dK and dQ
  const bool dv_block = role < n_slices;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = (blockIdx.x / (n_slices + 1)) * kBwdBK;
  const int b = blockIdx.y;
  const int col0 = role * DVS;
  const int n_qt = (N + kBwdBQ - 1) / kBwdBQ;
  const int n_ch = (dv + 63) / 64;
  const int n_seq = n_qt * n_ch;  // the dK/dQ block's chunk loads
  const float* statb = stat + size_t(b) * n_qt * (2 * kBwdBQ);

  auto issue = [&](int tile, int st) {  // Q, lse/D and (dV blocks) the dO slice of q tile `tile`
    uint64_t* bar = bars + 1 + st;
    mbar_arrive_expect_tx(bar, qBytes + kStatBytes + (dv_block ? doBytes : 0));
#pragma unroll
    for (int h = 0; h < R::BOXES; ++h)
      tma_load_3d(sm + L.q_off + st * L.q_stage + h * R::BOX_BYTES, &tq, bar, h * SW / 2,
                  tile * kBwdBQ, b);
    if (dv_block) {
#pragma unroll
      for (int j = 0; j < DVS / 64; ++j)
        tma_load_3d(sm + L.x_off + st * L.do_stage + j * 8192, &tdo, bar, col0 + 64 * j,
                    tile * kBwdBQ, b);
    }
    bulk_load(sm + L.stat_off + st * kStatBytes, statb + size_t(tile) * (2 * kBwdBQ), kStatBytes,
              bar);
  };
  auto issue_chunk = [&](int seq, int r) {  // V and dO columns 64 * (seq % n_ch) of q tile seq / n_ch
    uint64_t* bar = chunk_bars + r;
    uint8_t* dst = sm + L.x_off + r * kChunkBytes;
    mbar_arrive_expect_tx(bar, kChunkBytes);
    tma_load_3d(dst, &tv, bar, 64 * (seq % n_ch), k0, b);
    tma_load_3d(dst + 8192, &tdo, bar, 64 * (seq % n_ch), (seq / n_ch) * kBwdBQ, b);
  };
  if (tid == 0) {
    for (int s = 0; s < 1 + stages + kChunkStages; ++s) mbar_init(bars + s, 1);
    fence_mbar_init();
    mbar_arrive_expect_tx(bars, kBwdBK * DKP * 2);
    for (int h = 0; h < R::BOXES; ++h)
      tma_load_3d(sm + h * R::BOX_BYTES, &tk, bars, h * SW / 2, k0, b);
    for (int s = 0; s < stages && s < n_qt; ++s) issue(s, s);
    if (!dv_block)
      for (int r = 0; r < kChunkStages && r < n_seq; ++r) issue_chunk(r, r);
  }
  __syncthreads();

  const uint64_t k_desc = make_desc(sm, 16, 8 * SW, SW);
  const int krow = warp * 16 + g;  // this thread's keys: krow, krow + 8
  const bool key_lo_ok = k0 + krow < M, key_hi_ok = k0 + krow + 8 < M;
  const int key_lo = k0 + krow, key_hi = key_lo + 8;

  // S^T = K.Q^T of the q tile in stage st (issued, not waited for), both K-major
  auto scores = [&](float (&s)[32], const uint8_t* q_s) {
    const uint64_t q_desc = make_desc(q_s, 16, 8 * SW, SW);
#pragma unroll
    for (int ks = 0; ks < DKP / 16; ++ks)
      wgmma_ss<64, 0, 0>(s, desc_advance(k_desc, R::kstep(ks)), desc_advance(q_desc, R::kstep(ks)),
                         ks > 0);
  };
  // P^T = exp2(S^T*c - lse*log2e) in place; keys past M get none
  auto probs = [&](float (&s)[32], const float* l2) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j * 8 + 2 * t;
      const float l0 = l2[col], l1 = l2[col + 1];
      s[4 * j] = key_lo_ok ? fast_exp2(fmaf(s[4 * j], c, -l0)) : 0.f;
      s[4 * j + 1] = key_lo_ok ? fast_exp2(fmaf(s[4 * j + 1], c, -l1)) : 0.f;
      s[4 * j + 2] = key_hi_ok ? fast_exp2(fmaf(s[4 * j + 2], c, -l0)) : 0.f;
      s[4 * j + 3] = key_hi_ok ? fast_exp2(fmaf(s[4 * j + 3], c, -l1)) : 0.f;
    }
  };

  mbar_wait(bars, 0);
  if (dv_block) {
    float dv_acc[DVS / 2];
#pragma unroll
    for (int i = 0; i < DVS / 2; ++i) dv_acc[i] = 0.f;
    for (int it = 0; it < n_qt; ++it) {
      const int st = it % stages;
      mbar_wait(bars + 1 + st, (it / stages) & 1);
      const float* l2 = reinterpret_cast<const float*>(sm + L.stat_off + st * kStatBytes);
      float s[32];
      wgmma_fence();
      scores(s, sm + L.q_off + st * L.q_stage);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      probs(s, l2);
      uint32_t pa[4][4];
      acc_to_a(s, pa);
      // dV += P^T.dO of this slice (dO MN-major, 16 q rows a k-step)
      const uint64_t do_desc = make_desc(sm + L.x_off + st * L.do_stage, 8192, 1024, 128);
      fence_regs(dv_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<DVS, 1>(dv_acc, pa[kk], desc_advance(do_desc, 2048 * kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(pa);
      __syncthreads();  // stage `st` is consumed
      if (tid == 0 && it + stages < n_qt) issue(it + stages, st);
    }
    __nv_bfloat16* dvb = dv_out + size_t(b) * M * dv;
#pragma unroll
    for (int j = 0; j < DVS / 8; ++j) {
      const int col = col0 + j * 8 + 2 * t;
      if (col < dv) {
        if (key_lo < M)
          *reinterpret_cast<uint32_t*>(dvb + size_t(key_lo) * dv + col) =
              pack_bf16(dv_acc[4 * j], dv_acc[4 * j + 1]);
        if (key_hi < M)
          *reinterpret_cast<uint32_t*>(dvb + size_t(key_hi) * dv + col) =
              pack_bf16(dv_acc[4 * j + 2], dv_acc[4 * j + 3]);
      }
    }
    return;
  }

  // the dK/dQ block
  uint8_t* ds_s = sm + L.ds_off;
  const uint64_t ds_desc = make_desc(ds_s, 16, 1024, 128);
  float dk_acc[DKP / 2];
#pragma unroll
  for (int i = 0; i < DKP / 2; ++i) dk_acc[i] = 0.f;
  int seq = 0;
  for (int it = 0; it < n_qt; ++it) {
    const int st = it % stages;
    mbar_wait(bars + 1 + st, (it / stages) & 1);
    const uint8_t* q_s = sm + L.q_off + st * L.q_stage;
    const float* l2 = reinterpret_cast<const float*>(sm + L.stat_off + st * kStatBytes);
    const float* dd = l2 + kBwdBQ;

    float s[32], dp[32];
    wgmma_fence();
    scores(s, q_s);
    wgmma_commit();
    // dP^T = V.dO^T over dv, a 64-column chunk of each at a time (both K-major)
    for (int ch = 0; ch < n_ch; ++ch, ++seq) {
      const int r = seq % kChunkStages;
      mbar_wait(chunk_bars + r, (seq / kChunkStages) & 1);
      const uint8_t* v_c = sm + L.x_off + r * kChunkBytes;
      const uint64_t v_desc = make_desc(v_c, 16, 1024, 128);
      const uint64_t do_desc = make_desc(v_c + 8192, 16, 1024, 128);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<64, 0, 0>(dp, desc_advance(v_desc, 32 * kk), desc_advance(do_desc, 32 * kk),
                           ch > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dp);
      __syncthreads();  // chunk stage r is consumed
      if (tid == 0 && seq + kChunkStages < n_seq) issue_chunk(seq + kChunkStages, r);
    }
    fence_regs(s);
    probs(s, l2);
    // dS^T = P^T (dP^T - D)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j * 8 + 2 * t;
      const float d0 = dd[col], d1 = dd[col + 1];
      dp[4 * j] = s[4 * j] * (dp[4 * j] - d0);
      dp[4 * j + 1] = s[4 * j + 1] * (dp[4 * j + 1] - d1);
      dp[4 * j + 2] = s[4 * j + 2] * (dp[4 * j + 2] - d0);
      dp[4 * j + 3] = s[4 * j + 3] * (dp[4 * j + 3] - d1);
    }
    uint32_t da[4][4];
    acc_to_a(dp, da);
    // dK += dS^T.Q from registers (Q MN-major, 16 q rows a k-step; at dkp
    // 128 its two boxes are 8 KB apart along N)
    const uint64_t q_mn = make_desc(q_s, DKP <= 64 ? 16 : R::BOX_BYTES, 8 * SW, SW);
    fence_regs(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<DKP, 1>(dk_acc, da[kk], desc_advance(q_mn, 16 * SW * kk), 1);
    wgmma_commit();
    // dS^T (keys x 64 q, bf16) to shared memory in the 128-byte swizzle
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = 2 * kk + h;
        const int r0 = krow, r1 = krow + 8;
        *reinterpret_cast<uint32_t*>(ds_s + r0 * 128 + ((j ^ (r0 & 7)) << 4) + 4 * t) = da[kk][2 * h];
        *reinterpret_cast<uint32_t*>(ds_s + r1 * 128 + ((j ^ (r1 & 7)) << 4) + 4 * t) =
            da[kk][2 * h + 1];
      }
    }
    fence_proxy_async();
    __syncthreads();  // dS^T of every warp is in shared memory

    // dQ = dS.K over the block's 64 keys, one box of K's columns at a time
    // (dS^T and K MN-major), scaled into this tile's fp32 dq buffer
    float* dq_s = reinterpret_cast<float*>(sm + L.dq_off + (it & 1) * L.dq_buf);
    const int qr = warp * 16 + g;
#pragma unroll
    for (int h = 0; h < R::BOXES; ++h) {
      float dqa[DKH / 2];
      const uint64_t k_mn = make_desc(sm + h * R::BOX_BYTES, 16, 8 * SW, SW);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<DKH, 1, 1>(dqa, desc_advance(ds_desc, 2048 * kk), desc_advance(k_mn, 16 * SW * kk),
                            kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dqa);
#pragma unroll
      for (int j = 0; j < DKH / 8; ++j) {
        const int col = h * DKH + j * 8 + 2 * t;
        if (col < dk) {
          *reinterpret_cast<float2*>(dq_s + qr * dk + col) =
              make_float2(dqa[4 * j] * scale, dqa[4 * j + 1] * scale);
          *reinterpret_cast<float2*>(dq_s + (qr + 8) * dk + col) =
              make_float2(dqa[4 * j + 2] * scale, dqa[4 * j + 3] * scale);
        }
      }
    }
    fence_regs(dk_acc);
    fence_regs(da);
    fence_proxy_async();
    __syncthreads();  // the dq tile is written; stage `st` and dS^T are consumed
    if (tid == 0) {
      const int rows = min(kBwdBQ, N - it * kBwdBQ);
      float* dq_tile = dq + (size_t(b) * N + size_t(it) * kBwdBQ) * dk;
      bulk_reduce_add_f32(dq_tile, dq_s, uint32_t(rows * dk * 4));
      bulk_commit();
      bulk_wait_read<1>();  // the other dq buffer is free for the next tile
      if (it + stages < n_qt) issue(it + stages, st);
    }
  }
  if (tid == 0) bulk_wait_all();

  __nv_bfloat16* dkb = dk_out + size_t(b) * M * dk;
#pragma unroll
  for (int j = 0; j < DKP / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (col < dk) {
      if (key_lo < M)
        *reinterpret_cast<uint32_t*>(dkb + size_t(key_lo) * dk + col) =
            pack_bf16(dk_acc[4 * j] * scale, dk_acc[4 * j + 1] * scale);
      if (key_hi < M)
        *reinterpret_cast<uint32_t*>(dkb + size_t(key_hi) * dk + col) =
            pack_bf16(dk_acc[4 * j + 2] * scale, dk_acc[4 * j + 3] * scale);
    }
  }
}

template <int DKP, int DVS>
cudaError_t launch_bwd_split(dim3 grid, size_t smem, cudaStream_t stream, const void* q,
                             const void* k, const void* v, const void* dout, const float* stat,
                             float* dq, void* dk_out, void* dv_out, int B, int N, int M, int dk,
                             int dv, int n_slices, int stages, float c, float scale) {
  constexpr int SW = QkRows<DKP>::SW;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = sm90::make_map_bf16(&tq, q, B, N, dk, kBwdBQ, SW / 2, SW);
  if (err == cudaSuccess) err = sm90::make_map_bf16(&tk, k, B, M, dk, kBwdBK, SW / 2, SW);
  if (err == cudaSuccess) err = sm90::make_map_bf16(&tv, v, B, M, dv, kBwdBK, 64, 128);
  if (err == cudaSuccess) err = sm90::make_map_bf16(&tdo, dout, B, N, dv, kBwdBQ, 64, 128);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_split_kernel<DKP, DVS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  flash_bwd_split_kernel<DKP, DVS><<<grid, kBwdThreads, smem, stream>>>(
      tq, tk, tv, tdo, stat, dq, static_cast<__nv_bfloat16*>(dk_out),
      static_cast<__nv_bfloat16*>(dv_out), N, M, dk, dv, n_slices, stages, c, scale);
  return cudaGetLastError();
}

// the (dkp, dv slice) pairs the plan gives the split design: dkp 128 at any
// slice; dkp <= 64 only above dv 512, where three or more slices of <= 256
// are each wider than 170 columns
cudaError_t launch_bwd_split_any(int dkp, int dvs, dim3 grid, size_t smem, cudaStream_t stream,
                                 const void* q, const void* k, const void* v, const void* dout,
                                 const float* stat, float* dq, void* dk_out, void* dv_out, int B,
                                 int N, int M, int dk, int dv, int n_slices, int stages, float c,
                                 float scale) {
#define ADEPTH_SPLIT(P, S) \
  case P * 1000 + S: return launch_bwd_split<P, S>(grid, smem, stream, q, k, v, dout, stat, dq, dk_out, dv_out, B, N, M, dk, dv, n_slices, stages, c, scale);
  switch (dkp * 1000 + dvs) {
    ADEPTH_SPLIT(16, 192) ADEPTH_SPLIT(16, 256) ADEPTH_SPLIT(32, 192) ADEPTH_SPLIT(32, 256)
    ADEPTH_SPLIT(64, 192) ADEPTH_SPLIT(64, 256) ADEPTH_SPLIT(128, 64) ADEPTH_SPLIT(128, 128)
    ADEPTH_SPLIT(128, 192) ADEPTH_SPLIT(128, 256)
    default: return cudaErrorInvalidValue;
  }
#undef ADEPTH_SPLIT
}

// ---------------------------------------------------------------------------
// B3, fp32: the CUDA cores, any width
// ---------------------------------------------------------------------------
//
// A 256-thread block owns 32 keys and one output slice of 64 columns: a
// slice of dV (slices 0 .. n_dv - 1) or of dK (the rest); slice 0 also adds
// dQ by scalar atomics. For every 32-row q tile it computes S (over dk) and
// dP (over dv) in chunks of 64 columns through shared memory, then P and dS,
// then its slice. The scores are recomputed for every slice: the simplest
// route at every width; it serves the parity checks only.
constexpr int kBwdF32BK = 32;   // keys per block
constexpr int kBwdF32BQ = 32;   // q rows per sweep step
constexpr int kPStride = kBwdF32BQ + 1;

struct BwdF32Smem {
  static constexpr int k = 0;                                  // [32][kRowStride], a dk chunk
  static constexpr int q = k + kBwdF32BK * kRowStride;         // [32][kRowStride]
  static constexpr int v = q + kBwdF32BQ * kRowStride;         // [32][kRowStride], a dv chunk
  static constexpr int d = v + kBwdF32BK * kRowStride;         // [32][kRowStride], dO's
  static constexpr int p = d + kBwdF32BQ * kRowStride;         // [q][key]
  static constexpr int ds = p + kBwdF32BQ * kPStride;          // [q][key]
  static constexpr int l2 = ds + kBwdF32BQ * kPStride;
  static constexpr int dd = l2 + kBwdF32BQ;
  static constexpr size_t bytes = size_t(dd + kBwdF32BQ) * sizeof(float);
};

// grid (key_tiles * n_slices, B); block 256: ty = tid / 16 owns rows 2ty,
// 2ty + 1 (q rows of S, P, dS and dq; keys of the slice), tx the keys tx,
// tx + 16 of S and the columns tx + 16j of the slice
__global__ void __launch_bounds__(kThreadsF32)
flash_bwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ dsum,
                     float* __restrict__ dq, float* __restrict__ dk_out,
                     float* __restrict__ dv_out, int N, int M, int dk, int dv, int n_slices,
                     float c, float scale) {
  extern __shared__ float smem_f[];
  float* ks = smem_f + BwdF32Smem::k;
  float* qs = smem_f + BwdF32Smem::q;
  float* vs = smem_f + BwdF32Smem::v;
  float* dos = smem_f + BwdF32Smem::d;
  float* ps = smem_f + BwdF32Smem::p;
  float* dss = smem_f + BwdF32Smem::ds;
  float* l2s = smem_f + BwdF32Smem::l2;
  float* dds = smem_f + BwdF32Smem::dd;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int slice = blockIdx.x % n_slices;
  const int k0 = (blockIdx.x / n_slices) * kBwdF32BK;
  const int n_dv = (dv + kDkChunk - 1) / kDkChunk;
  const bool dv_slice = slice < n_dv;
  const int c0 = (dv_slice ? slice : slice - n_dv) * kDkChunk;  // the slice's first column
  const size_t b = blockIdx.y;
  const float* qb = q + b * N * dk;
  const float* kb = k + b * M * dk;
  const float* vb = v + b * M * dv;
  const float* dob = dout + b * N * dv;

  float acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int q0 = 0; q0 < N; q0 += kBwdF32BQ) {
    float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, dp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    for (int d0 = 0; d0 < dk; d0 += kDkChunk) {  // S: q rows 2ty + i, keys tx + 16jj
      __syncthreads();  // the last chunk (or tile) is consumed
      load_chunk(ks, kb, kBwdF32BK, k0, M, d0, dk, tid, kThreadsF32);
      load_chunk(qs, qb, kBwdF32BQ, q0, N, d0, dk, tid, kThreadsF32);
      if (d0 == 0 && tid < kBwdF32BQ) {
        l2s[tid] = q0 + tid < N ? lse[b * N + q0 + tid] * kLog2e : 0.f;
        dds[tid] = q0 + tid < N ? dsum[b * N + q0 + tid] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
          for (int d = 0; d < kDkChunk; ++d)
            s[i][jj] = fmaf(qs[(2 * ty + i) * kRowStride + d], ks[(tx + 16 * jj) * kRowStride + d],
                            s[i][jj]);
    }
    for (int d0 = 0; d0 < dv; d0 += kDkChunk) {  // dP = dO.V^T likewise
      __syncthreads();
      load_chunk(vs, vb, kBwdF32BK, k0, M, d0, dv, tid, kThreadsF32);
      load_chunk(dos, dob, kBwdF32BQ, q0, N, d0, dv, tid, kThreadsF32);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
          for (int d = 0; d < kDkChunk; ++d)
            dp[i][jj] = fmaf(dos[(2 * ty + i) * kRowStride + d], vs[(tx + 16 * jj) * kRowStride + d],
                             dp[i][jj]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qr = 2 * ty + i;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int key = tx + 16 * jj;
        const float p = k0 + key < M ? exp2f(fmaf(s[i][jj], c, -l2s[qr])) : 0.f;
        ps[qr * kPStride + key] = p;
        dss[qr * kPStride + key] = p * (dp[i][jj] - dds[qr]);
      }
    }
    // the slice's operand: dO (for dV) or Q (for dK) at columns c0 .. c0 + 63
    __syncthreads();
    if (dv_slice)
      load_chunk(dos, dob, kBwdF32BQ, q0, N, c0, dv, tid, kThreadsF32);
    else
      load_chunk(qs, qb, kBwdF32BQ, q0, N, c0, dk, tid, kThreadsF32);
    __syncthreads();
    const float* w = dv_slice ? ps : dss;
    const float* x = dv_slice ? dos : qs;
    float part[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};  // this q tile's sum
    for (int qq = 0; qq < kBwdF32BQ; ++qq) {
      const float w0 = w[qq * kPStride + 2 * ty], w1 = w[qq * kPStride + 2 * ty + 1];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float xv = x[qq * kRowStride + tx + 16 * j];
        part[0][j] = fmaf(w0, xv, part[0][j]);
        part[1][j] = fmaf(w1, xv, part[1][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
    if (slice == 0) {  // dq rows 2ty + i: dS.K over the block's keys, chunk by chunk of dk
      for (int d0 = 0; d0 < dk; d0 += kDkChunk) {
        __syncthreads();
        load_chunk(ks, kb, kBwdF32BK, k0, M, d0, dk, tid, kThreadsF32);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int qr = 2 * ty + i;
          if (q0 + qr >= N) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int d = d0 + tx + 16 * j;
            if (d < dk) {
              float a = 0.f;
              for (int key = 0; key < kBwdF32BK; ++key)
                a = fmaf(dss[qr * kPStride + key], ks[key * kRowStride + tx + 16 * j], a);
              atomicAdd(dq + (b * N + q0 + qr) * dk + d, a * scale);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + 2 * ty + i;
    if (key >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + tx + 16 * j;
      if (dv_slice && col < dv) dv_out[(b * M + key) * dv + col] = acc[i][j];
      if (!dv_slice && col < dk) dk_out[(b * M + key) * dk + col] = acc[i][j] * scale;
    }
  }
}

// ---------------------------------------------------------------------------
// Layout probe: the q/k operand layouts alone
// ---------------------------------------------------------------------------
//
// On no path. One 64-row tile of q and of k, loaded as B2 and B3 load them
// (QkRows<DKP>), and the three products that read them with the kernels'
// descriptors: S = Q.K^T (both K-major: B2's scores, B3's S^T), X =
// bf16(S).Q (Q MN-major: B3's dK += dS^T.Q) and Y = bf16(S).K (K MN-major a
// box at a time: B3's dQ = dS.K). chip_smoke.py holds them against
// torch.matmul, so that a wrong swizzle or descriptor at a dkp shows alone,
// before the kernels that use it.
template <int DKP>
__global__ void __launch_bounds__(128)
flash_layout_probe_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                          float* __restrict__ s_out, float* __restrict__ x_out,
                          float* __restrict__ y_out, int dk) {
  using namespace sm90;
  using R = QkRows<DKP>;
  constexpr int SW = R::SW;
  constexpr int DKH = DKP / R::BOXES;
  constexpr int kTile = 64 * DKP * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + 2 * kTile);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  if (tid == 0) {
    mbar_init(bar, 1);
    fence_mbar_init();
    mbar_arrive_expect_tx(bar, 2 * kTile);
    for (int h = 0; h < R::BOXES; ++h) {
      tma_load_3d(sm + h * R::BOX_BYTES, &tq, bar, h * SW / 2, 0, 0);
      tma_load_3d(sm + kTile + h * R::BOX_BYTES, &tk, bar, h * SW / 2, 0, 0);
    }
  }
  __syncthreads();
  mbar_wait(bar, 0);

  float s[32];
  const uint64_t q_desc = make_desc(sm, 16, 8 * SW, SW);
  const uint64_t k_desc = make_desc(sm + kTile, 16, 8 * SW, SW);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < DKP / 16; ++ks)
    wgmma_ss<64, 0, 0>(s, desc_advance(q_desc, R::kstep(ks)), desc_advance(k_desc, R::kstep(ks)),
                       ks > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  uint32_t a[4][4];
  acc_to_a(s, a);

  float x[DKP / 2];
#pragma unroll
  for (int i = 0; i < DKP / 2; ++i) x[i] = 0.f;
  const uint64_t q_mn = make_desc(sm, DKP <= 64 ? 16 : R::BOX_BYTES, 8 * SW, SW);
  fence_regs(x);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<DKP, 1>(x, a[kk], desc_advance(q_mn, 16 * SW * kk), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(x);

  const int r_lo = warp * 16 + g, r_hi = r_lo + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = j * 8 + 2 * t;
    s_out[r_lo * 64 + col] = s[4 * j];
    s_out[r_lo * 64 + col + 1] = s[4 * j + 1];
    s_out[r_hi * 64 + col] = s[4 * j + 2];
    s_out[r_hi * 64 + col + 1] = s[4 * j + 3];
  }
#pragma unroll
  for (int j = 0; j < DKP / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (col < dk) {
      x_out[r_lo * dk + col] = x[4 * j];
      x_out[r_lo * dk + col + 1] = x[4 * j + 1];
      x_out[r_hi * dk + col] = x[4 * j + 2];
      x_out[r_hi * dk + col + 1] = x[4 * j + 3];
    }
  }
#pragma unroll
  for (int h = 0; h < R::BOXES; ++h) {
    float y[DKH / 2];
#pragma unroll
    for (int i = 0; i < DKH / 2; ++i) y[i] = 0.f;
    const uint64_t k_mn = make_desc(sm + kTile + h * R::BOX_BYTES, 16, 8 * SW, SW);
    fence_regs(y);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs<DKH, 1>(y, a[kk], desc_advance(k_mn, 16 * SW * kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(y);
#pragma unroll
    for (int j = 0; j < DKH / 8; ++j) {
      const int col = h * DKH + j * 8 + 2 * t;
      if (col < dk) {
        y_out[r_lo * dk + col] = y[4 * j];
        y_out[r_lo * dk + col + 1] = y[4 * j + 1];
        y_out[r_hi * dk + col] = y[4 * j + 2];
        y_out[r_hi * dk + col + 1] = y[4 * j + 3];
      }
    }
  }
  fence_regs(a);
}

template <int DKP>
cudaError_t launch_layout_probe(cudaStream_t stream, const void* q, const void* k, float* s,
                                float* x, float* y, int dk) {
  constexpr int SW = QkRows<DKP>::SW;
  CUtensorMap tq, tk;
  cudaError_t err = sm90::make_map_bf16(&tq, q, 1, kBQ, dk, kBQ, SW / 2, SW);
  if (err == cudaSuccess) err = sm90::make_map_bf16(&tk, k, 1, kBK, dk, kBK, SW / 2, SW);
  if (err != cudaSuccess) return err;
  const size_t smem = 2 * 64 * DKP * 2 + 8 + 1024;  // two tiles, the mbarrier, alignment slack
  flash_layout_probe_kernel<DKP><<<1, 128, smem, stream>>>(tq, tk, s, x, y, dk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernel B2. The plan (ops/cuda/flash_attention.py) picks the variant (0:
// fp32 CUDA cores, 1: bf16 wgmma), dkp, dvs, the block, stages, the shared
// memory bytes and grid.x; they are checked here against the kernel's own layout
// and a mismatch returns cudaErrorInvalidValue. Launches on `stream` of
// `device`; returns cudaGetLastError() (0 on success). The caller checks
// shapes: dk and dv multiples of 8 (the wrapper zero-pads them), dk <= 128,
// 16-byte aligned contiguous tensors, B <= 65535.
int adepth_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                               int B, int N, int M, int dk, int dv, float scale, int variant,
                               int dkp, int dvs, int block, int stages, long long smem,
                               int grid_x, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dk <= 0 || dk > kMaxHeadDk || dk % 8 || dv <= 0 || dv % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const float c = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const int q_tiles = (N + kBQ - 1) / kBQ;
  if (variant == 0) {
    const int n_slices = (dv + kDVS - 1) / kDVS;
    if (block != kThreadsF32 || size_t(smem) != F32Smem::bytes || grid_x != q_tiles * n_slices)
      return static_cast<int>(cudaErrorInvalidValue);
    err = cudaFuncSetAttribute(flash_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_fwd_f32_kernel<<<dim3(grid_x, B), kThreadsF32, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), l, N, M, dk, dv, n_slices, c);
    return static_cast<int>(cudaGetLastError());
  }
  const int n_slices = (dv + 255) / 256;
  if (variant != 1 || block != 128 || dkp < dk || dvs * n_slices < dv || dvs % 64 || dvs > 256 ||
      stages < 1 ||
      size_t(smem) != fwd_layout(dkp, dvs, stages).bytes || grid_x != q_tiles * n_slices)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(grid_x, B);
  switch (dkp) {
    case 16: err = launch_fwd_wgmma_dvs<16>(dvs, grid, smem, st, q, k, v, o, l, B, N, M, dk, dv, n_slices, stages, c); break;
    case 32: err = launch_fwd_wgmma_dvs<32>(dvs, grid, smem, st, q, k, v, o, l, B, N, M, dk, dv, n_slices, stages, c); break;
    case 64: err = launch_fwd_wgmma_dvs<64>(dvs, grid, smem, st, q, k, v, o, l, B, N, M, dk, dv, n_slices, stages, c); break;
    case 128: err = launch_fwd_wgmma_dvs<128>(dvs, grid, smem, st, q, k, v, o, l, B, N, M, dk, dv, n_slices, stages, c); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Kernel B3. dq is a zeroed fp32 [B, N, dk] buffer the kernel adds into;
// dk and dv are written in the input dtype; lse is fp32 [B, N]. Variant 0
// (fp32) reads D from dsum [B, N]; variants 2 (bf16 wgmma, one warpgroup a
// block for dv <= 256, two above, dkp <= 64 and dv <= 512) and 3 (bf16
// split: dV blocks per dv slice beside a dK/dQ block per key tile) first
// run flash_bwd_prep_kernel from o, dout and lse into `stat` [B, q_tiles,
// 2, 64] fp32. The plan's dkp, dvs (the dv columns of one warpgroup),
// block, stages, smem and grid_x are checked as in the forward. The caller
// checks shapes: dk and dv multiples of 8, dk <= 128, 16-byte aligned
// contiguous tensors, B <= 65535.
int adepth_flash_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                               const void* o, const void* lse, const void* dsum, void* stat,
                               void* dq, void* dk_out, void* dv_out, int B, int N, int M, int dk,
                               int dv, float scale, int variant, int dkp, int dvs, int block,
                               int stages, long long smem, int grid_x, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dk <= 0 || dk > kMaxHeadDk || dk % 8 || dv <= 0 || dv % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const float c = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dqf = static_cast<float*>(dq);
  const dim3 grid(grid_x, B);
  const int key_tiles = (M + kBwdBK - 1) / kBwdBK;
  if (variant == 0) {
    const int n_slices = (dv + kDkChunk - 1) / kDkChunk + (dk + kDkChunk - 1) / kDkChunk;
    if (block != kThreadsF32 || size_t(smem) != BwdF32Smem::bytes ||
        grid_x != (M + kBwdF32BK - 1) / kBwdF32BK * n_slices)
      return static_cast<int>(cudaErrorInvalidValue);
    err = cudaFuncSetAttribute(flash_bwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_f32_kernel<<<grid, kThreadsF32, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), l, static_cast<const float*>(dsum), dqf,
        static_cast<float*>(dk_out), static_cast<float*>(dv_out), N, M, dk, dv, n_slices, c,
        scale);
    return static_cast<int>(cudaGetLastError());
  }
  const int q_tiles = (N + kBwdBQ - 1) / kBwdBQ;
  const int wgs = block / kBwdThreads;
  bool ok;
  if (variant == 2) {
    ok = (wgs == 1 || wgs == 2) && block % kBwdThreads == 0 && dkp >= dk && dkp <= 64 &&
         dvs * wgs >= dv && dv <= kBwdMaxDv && !(wgs == 2 && dv <= 256) && dvs % 64 == 0 &&
         dvs <= 256 && stages >= 1 &&
         size_t(smem) == bwd_wg_layout(dkp, dvs * wgs, dk, stages, wgs).bytes &&
         grid_x == key_tiles;
  } else {
    const int n_slices = (dv + 255) / 256;
    ok = variant == 3 && block == kBwdThreads && dkp >= dk && dvs * n_slices >= dv &&
         dvs % 64 == 0 && dvs <= 256 && stages >= 1 &&
         size_t(smem) == bwd_split_layout(dkp, dvs, dk, stages).bytes &&
         grid_x == key_tiles * (n_slices + 1);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  float* stf = static_cast<float*>(stat);
  flash_bwd_prep_kernel<<<dim3(q_tiles, B), 256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), l, stf, N, dv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (variant == 3)
    return static_cast<int>(launch_bwd_split_any(dkp, dvs, grid, smem, st, q, k, v, dout, stf, dqf,
                                                 dk_out, dv_out, B, N, M, dk, dv,
                                                 (dv + 255) / 256, stages, c, scale));
  switch (dkp) {
    case 16: err = launch_bwd_wgmma_dvs<16>(dvs, wgs, grid, smem, st, q, k, v, dout, stf, dqf, dk_out, dv_out, B, N, M, dk, dv, stages, c, scale); break;
    case 32: err = launch_bwd_wgmma_dvs<32>(dvs, wgs, grid, smem, st, q, k, v, dout, stf, dqf, dk_out, dv_out, B, N, M, dk, dv, stages, c, scale); break;
    case 64: err = launch_bwd_wgmma_dvs<64>(dvs, wgs, grid, smem, st, q, k, v, dout, stf, dqf, dk_out, dv_out, B, N, M, dk, dv, stages, c, scale); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The layout probe (flash_layout_probe_kernel): q and k bf16 [64, dk]
// contiguous, dk a multiple of 8 up to dkp; s fp32 [64, 64], x and y fp32
// [64, dk]. Returns cudaGetLastError() (0 on success).
int adepth_flash_layout_probe(const void* q, const void* k, void* s, void* x, void* y, int dk,
                              int dkp, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dk <= 0 || dk % 8 || dk > dkp) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float *sf = static_cast<float*>(s), *xf = static_cast<float*>(x), *yf = static_cast<float*>(y);
  switch (dkp) {
    case 16: err = launch_layout_probe<16>(st, q, k, sf, xf, yf, dk); break;
    case 32: err = launch_layout_probe<32>(st, q, k, sf, xf, yf, dk); break;
    case 64: err = launch_layout_probe<64>(st, q, k, sf, xf, yf, dk); break;
    case 128: err = launch_layout_probe<128>(st, q, k, sf, xf, yf, dk); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* adepth_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
