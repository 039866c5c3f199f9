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
// fp32 runs a CUDA-core tiling (256 threads, 4 q rows x 4 keys of S and 4
// rows x 8 columns of O a thread, P through shared memory), unchanged from
// the first port: it serves the parity checks only.

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
// to 16, 32 or 64 (the q/k swizzle is one row: 2*DKP bytes), DVS = the dv
// slice padded to a multiple of 64.
template <int DKP, int DVS>
__global__ void __launch_bounds__(128, DVS <= 128 ? 3 : 2)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int N, int M, int dv, int n_slices, int stages,
                       float c /* scale * log2(e) */) {
  using namespace sm90;
  constexpr int SW = 2 * DKP;
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
    tma_load_3d(sm + L.k_off + st * L.k_stage, &tk, bar, 0, tile * kBK, b);
#pragma unroll
    for (int j = 0; j < DVS / 64; ++j)
      tma_load_3d(sm + L.v_off + st * L.v_stage + j * 8192, &tv, bar, col0 + 64 * j, tile * kBK, b);
  };
  if (tid == 0) {
    for (int s = 0; s <= stages; ++s) mbar_init(bars + s, 1);
    fence_mbar_init();
    mbar_arrive_expect_tx(bars, kBQ * DKP * 2);
    tma_load_3d(sm, &tq, bars, 0, q0, b);
    for (int s = 0; s < stages && s < n_tiles; ++s) issue(s, s);
  }
  __syncthreads();

  const uint64_t q_desc = make_desc(sm, 16, 8 * SW, SW);
  // S = Q.K^T: both K-major, one k-step of 16 per 32 bytes of row
  auto qk = [&](float (&s)[32], int st) {
    const uint64_t k_desc = make_desc(sm + L.k_off + st * L.k_stage, 16, 8 * SW, SW);
#pragma unroll
    for (int ks = 0; ks < DKP / 16; ++ks)
      wgmma_ss<64, 0, 0>(s, desc_advance(q_desc, 32 * ks), desc_advance(k_desc, 32 * ks), ks > 0);
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
  CUtensorMap tq, tk, tv;
  cudaError_t err = sm90::make_map_bf16(&tq, q, B, N, dk, kBQ, DKP, 2 * DKP);
  if (err == cudaSuccess) err = sm90::make_map_bf16(&tk, k, B, M, dk, kBK, DKP, 2 * DKP);
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
constexpr int kMaxDk = 64;
constexpr int kRowStride = kMaxDk + 1;  // q/k/p rows in floats (odd: no bank conflicts)

struct F32Smem {
  static constexpr int q = 0;
  static constexpr int k = q + kBQ * kRowStride;
  static constexpr int p = k + kBK * kRowStride;
  static constexpr int v = p + kBQ * kRowStride;
  static constexpr size_t bytes = size_t(v + kBK * kDVS) * sizeof(float);
};

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

  for (int i = tid; i < kBQ * dk; i += kThreadsF32) {
    const int r = i / dk, d = i - r * dk;
    qs[r * kRowStride + d] = q0 + r < N ? qb[size_t(q0 + r) * dk + d] : 0.f;
  }

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
    __syncthreads();  // the previous tile's k, v and p are consumed
    for (int i = tid; i < kBK * dk; i += kThreadsF32) {
      const int r = i / dk, d = i - r * dk;
      kts[r * kRowStride + d] = kv0 + r < M ? kb[size_t(kv0 + r) * dk + d] : 0.f;
    }
    for (int i = tid; i < kBK * kDVS; i += kThreadsF32) {
      const int r = i / kDVS, cc = i - r * kDVS;
      vts[i] = kv0 + r < M && col0 + cc < dv ? vb[size_t(kv0 + r) * dv + col0 + cc] : 0.f;
    }
    __syncthreads();

    // S: rows 4ty+i, keys tx+16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dk; ++d) {
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
      const float sc = mx * c;
      const float alpha = fast_exp2(m_run[i] * c - sc);
      m_run[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = fast_exp2(fmaf(s[i][j], c, -sc));
        ps[(4 * ty + i) * kRowStride + tx + 16 * j] = p;
        sum += p;
      }
      l_run[i] = l_run[i] * alpha + sum;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // O += P.V: rows 4ty+i, columns col0 + tx + 16j
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], vv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(4 * ty + i) * kRowStride + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) vv[j] = vts[kk * kDVS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
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
// fp32 runs on the CUDA cores in full fp32: a 256-thread block owns 32 keys
// and the whole of dv, sweeps 32-row q tiles, and passes P and dS through
// shared memory; dq takes scalar atomics.
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

// fp32 backward on the CUDA cores
constexpr int kBwdF32BK = 32;   // keys per block
constexpr int kBwdF32BQ = 32;   // q rows per sweep step
constexpr int kPStride = kBwdF32BQ + 1;

inline size_t bwd_f32_bytes(int dv) {
  const int vstr = dv + 1;
  return sizeof(float) * size_t(2 * kBwdF32BK * kRowStride + 2 * kBwdF32BK * vstr +
                                2 * kBwdF32BQ * kPStride + 2 * kBwdF32BQ);
}

// grid (key_tiles, B); block 256: ty = tid / 16 owns rows 2ty, 2ty + 1 (q rows
// of S, P, dS and dq; keys of dk and dv), tx the columns tx + 16j
__global__ void __launch_bounds__(kThreadsF32)
flash_bwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ dsum,
                     float* __restrict__ dq, float* __restrict__ dk_out,
                     float* __restrict__ dv_out, int N, int M, int dk, int dv, float c,
                     float scale) {
  extern __shared__ float smem_f[];
  const int vstr = dv + 1;  // odd: no bank conflicts along keys
  float* ks = smem_f;                          // [32][kRowStride]
  float* qs = ks + kBwdF32BK * kRowStride;     // [32][kRowStride]
  float* vs = qs + kBwdF32BQ * kRowStride;     // [32][vstr]
  float* dos = vs + kBwdF32BK * vstr;          // [32][vstr]
  float* ps = dos + kBwdF32BQ * vstr;          // [q][key]
  float* dss = ps + kBwdF32BQ * kPStride;      // [q][key]
  float* l2s = dss + kBwdF32BQ * kPStride;
  float* dds = l2s + kBwdF32BQ;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int k0 = blockIdx.x * kBwdF32BK;
  const size_t b = blockIdx.y;
  const float* qb = q + b * N * dk;
  const float* kb = k + b * M * dk;
  const float* vb = v + b * M * dv;
  const float* dob = dout + b * N * dv;

  for (int i = tid; i < kBwdF32BK * dk; i += kThreadsF32) {
    const int r = i / dk, d = i - r * dk;
    ks[r * kRowStride + d] = k0 + r < M ? kb[size_t(k0 + r) * dk + d] : 0.f;
  }
  for (int i = tid; i < kBwdF32BK * dv; i += kThreadsF32) {
    const int r = i / dv, d = i - r * dv;
    vs[r * vstr + d] = k0 + r < M ? vb[size_t(k0 + r) * dv + d] : 0.f;
  }

  float dva[2][kBwdMaxDv / 16];
  float dka[2][kMaxDk / 16];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < kBwdMaxDv / 16; ++j) dva[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxDk / 16; ++j) dka[i][j] = 0.f;
  }

  for (int q0 = 0; q0 < N; q0 += kBwdF32BQ) {
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kBwdF32BQ * dk; i += kThreadsF32) {
      const int r = i / dk, d = i - r * dk;
      qs[r * kRowStride + d] = q0 + r < N ? qb[size_t(q0 + r) * dk + d] : 0.f;
    }
    for (int i = tid; i < kBwdF32BQ * dv; i += kThreadsF32) {
      const int r = i / dv, d = i - r * dv;
      dos[r * vstr + d] = q0 + r < N ? dob[size_t(q0 + r) * dv + d] : 0.f;
    }
    if (tid < kBwdF32BQ) {
      l2s[tid] = q0 + tid < N ? lse[b * N + q0 + tid] * kLog2e : 0.f;
      dds[tid] = q0 + tid < N ? dsum[b * N + q0 + tid] : 0.f;
    }
    __syncthreads();

    // P and dS: q rows 2ty + i, keys tx + 16jj
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qr = 2 * ty + i;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int key = tx + 16 * jj;
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < dk; ++d) s = fmaf(qs[qr * kRowStride + d], ks[key * kRowStride + d], s);
        for (int d = 0; d < dv; ++d) dp = fmaf(dos[qr * vstr + d], vs[key * vstr + d], dp);
        const float p = k0 + key < M ? fast_exp2(fmaf(s, c, -l2s[qr])) : 0.f;
        ps[qr * kPStride + key] = p;
        dss[qr * kPStride + key] = p * (dp - dds[qr]);
      }
    }
    __syncthreads();

    // dv += P^T.dO and dk += dS^T.Q for keys 2ty + i
    for (int qq = 0; qq < kBwdF32BQ; ++qq) {
      const float p0 = ps[qq * kPStride + 2 * ty], p1 = ps[qq * kPStride + 2 * ty + 1];
      const float s0 = dss[qq * kPStride + 2 * ty], s1 = dss[qq * kPStride + 2 * ty + 1];
#pragma unroll
      for (int j = 0; j < kBwdMaxDv / 16; ++j) {
        if (tx + 16 * j < dv) {
          const float o = dos[qq * vstr + tx + 16 * j];
          dva[0][j] = fmaf(p0, o, dva[0][j]);
          dva[1][j] = fmaf(p1, o, dva[1][j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kMaxDk / 16; ++j) {
        if (tx + 16 * j < dk) {
          const float qv = qs[qq * kRowStride + tx + 16 * j];
          dka[0][j] = fmaf(s0, qv, dka[0][j]);
          dka[1][j] = fmaf(s1, qv, dka[1][j]);
        }
      }
    }
    // dq rows 2ty + i: dS.K over the block's keys
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qr = 2 * ty + i;
      if (q0 + qr >= N) continue;
#pragma unroll
      for (int j = 0; j < kMaxDk / 16; ++j) {
        const int d = tx + 16 * j;
        if (d < dk) {
          float acc = 0.f;
          for (int key = 0; key < kBwdF32BK; ++key)
            acc = fmaf(dss[qr * kPStride + key], ks[key * kRowStride + d], acc);
          atomicAdd(dq + (b * N + q0 + qr) * dk + d, acc * scale);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + 2 * ty + i;
    if (key >= M) continue;
#pragma unroll
    for (int j = 0; j < kBwdMaxDv / 16; ++j)
      if (tx + 16 * j < dv) dv_out[(b * M + key) * dv + tx + 16 * j] = dva[i][j];
#pragma unroll
    for (int j = 0; j < kMaxDk / 16; ++j)
      if (tx + 16 * j < dk) dk_out[(b * M + key) * dk + tx + 16 * j] = dka[i][j] * scale;
  }
}

}  // namespace

extern "C" {

// Kernel B2. The plan (ops/cuda/flash_attention.py) picks the variant (0:
// fp32 CUDA cores, 1: bf16 wgmma), dkp, dvs, the block, stages, the shared
// memory bytes and grid.x; they are checked here against the kernel's own layout
// and a mismatch returns cudaErrorInvalidValue. Launches on `stream` of
// `device`; returns cudaGetLastError() (0 on success). The caller checks
// shapes: dk % 8 == 0, dk <= 64, dv % 8 == 0, 16-byte aligned contiguous
// tensors, B <= 65535.
int adepth_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                               int B, int N, int M, int dk, int dv, float scale, int variant,
                               int dkp, int dvs, int block, int stages, long long smem,
                               int grid_x, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dk <= 0 || dk > kMaxDk || dk % 8 || dv % 8) return static_cast<int>(cudaErrorInvalidValue);
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
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Kernel B3. dq is a zeroed fp32 [B, N, dk] buffer the kernel adds into;
// dk and dv are written in the input dtype; lse is fp32 [B, N]. Variant 0
// (fp32) reads D from dsum [B, N]; variant 2 (bf16 wgmma, one warpgroup a
// block for dv <= 256, two above) first runs flash_bwd_prep_kernel from o,
// dout and lse into `stat` [B, q_tiles, 2, 64] fp32. The plan's dkp, dvs
// (the dv columns of one warpgroup), block, stages, smem and grid_x are
// checked as in the forward. The caller checks shapes: dk % 8 == 0, dk <=
// 64, dv % 8 == 0, dv <= 512, 16-byte aligned contiguous tensors, B <=
// 65535.
int adepth_flash_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                               const void* o, const void* lse, const void* dsum, void* stat,
                               void* dq, void* dk_out, void* dv_out, int B, int N, int M, int dk,
                               int dv, float scale, int variant, int dkp, int dvs, int block,
                               int stages, long long smem, int grid_x, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dk <= 0 || dk > kMaxDk || dk % 8 || dv <= 0 || dv % 8 || dv > kBwdMaxDv)
    return static_cast<int>(cudaErrorInvalidValue);
  const float c = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dqf = static_cast<float*>(dq);
  const dim3 grid(grid_x, B);
  if (variant == 0) {
    if (block != kThreadsF32 || size_t(smem) != bwd_f32_bytes(dv) ||
        grid_x != (M + kBwdF32BK - 1) / kBwdF32BK)
      return static_cast<int>(cudaErrorInvalidValue);
    err = cudaFuncSetAttribute(flash_bwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_bwd_f32_kernel<<<grid, kThreadsF32, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), l, static_cast<const float*>(dsum), dqf,
        static_cast<float*>(dk_out), static_cast<float*>(dv_out), N, M, dk, dv, c, scale);
    return static_cast<int>(cudaGetLastError());
  }
  const int q_tiles = (N + kBwdBQ - 1) / kBwdBQ;
  const int wgs = block / kBwdThreads;
  if (variant != 2 || (wgs != 1 && wgs != 2) || block % kBwdThreads || dkp < dk ||
      dvs * wgs < dv || (wgs == 2 && dv <= 256) || dvs % 64 || dvs > 256 || stages < 1 ||
      size_t(smem) != bwd_wg_layout(dkp, dvs * wgs, dk, stages, wgs).bytes ||
      grid_x != (M + kBwdBK - 1) / kBwdBK)
    return static_cast<int>(cudaErrorInvalidValue);
  float* stf = static_cast<float*>(stat);
  flash_bwd_prep_kernel<<<dim3(q_tiles, B), 256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), l, stf, N, dv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (dkp) {
    case 16: err = launch_bwd_wgmma_dvs<16>(dvs, wgs, grid, smem, st, q, k, v, dout, stf, dqf, dk_out, dv_out, B, N, M, dk, dv, stages, c, scale); break;
    case 32: err = launch_bwd_wgmma_dvs<32>(dvs, wgs, grid, smem, st, q, k, v, dout, stf, dqf, dk_out, dv_out, B, N, M, dk, dv, stages, c, scale); break;
    case 64: err = launch_bwd_wgmma_dvs<64>(dvs, wgs, grid, smem, st, q, k, v, dout, stf, dqf, dk_out, dv_out, B, N, M, dk, dv, stages, c, scale); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

const char* adepth_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
