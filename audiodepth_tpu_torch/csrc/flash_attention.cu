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
// fp32 (`--compute_dtype float32`, the reference's own numerics) runs the
// same design on the tensor cores with every operand in three bf16 pieces
// (x = x1 + x2 + x3 exactly: 8 + 8 + 8 significant bits, B1's split) and
// every product as six piece products, smallest first (a3.b1, a1.b3, a2.b2,
// a2.b1, a1.b2, a1.b1; the three dropped ones are below 2^-26 of it), into
// fp32 accumulators: products exact, sums fp32. The tensor core's fp32 adds
// truncate, and the bias of many tiles summed into one accumulator put o
// past its tolerance at M = 4096 on the H100, so each key tile's
// P.V sums in a fresh accumulator `tacc` that is added to O in fp32
// (tests/test_torch_attention_numerics.py emulates both). The pieces of q,
// k and v come from flash_split3_kernel, launched by the same call into a
// bf16 [3, B, rows, cols] scratch buffer a tensor (6 bytes an element, TMA
// boxes as in bf16); P is split in registers where it is made. The
// accurate exp2f, and the O rescale only when a row's max moves
// (ex2.approx compounding once a tile put lse 3.2e-4 off float64 at M =
// 16384). Tripled tiles need 3x the shared memory and the fresh
// accumulator registers, so dv slices are 64 columns and the plan picks
// the stages. Bound: six bf16 passes at 989 TFLOP/s (15.0 ms at level 2,
// 2B = 32; the CUDA cores' 67 TFLOP/s would take 36.9 ms for one fp32
// pass; PERF.md has the card's times). 3xTF32 was not taken: TF32 wgmma
// reads only K-major operands, and B3 reads four MN-major ones.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kBQ = 64;    // q rows per block (wgmma's M)
constexpr int kBK = 64;    // keys per k/v tile
constexpr int kMaxHeadDk = 128;  // the largest dk: the wgmma paths' dkp
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

// x = p1 + p2 + p3 exactly, for both x0 (low halves) and x1 (high halves):
// each piece holds the next 8 significant bits, each subtraction is exact
// (fused_frontend.cu's split)
__device__ __forceinline__ void split3_bf16(float x0, float x1, uint32_t& p1, uint32_t& p2,
                                            uint32_t& p3) {
  p1 = pack_bf16(x0, x1);
  x0 -= __uint_as_float(p1 << 16);
  x1 -= __uint_as_float(p1 & 0xffff0000u);
  p2 = pack_bf16(x0, x1);
  x0 -= __uint_as_float(p2 << 16);
  x1 -= __uint_as_float(p2 & 0xffff0000u);
  p3 = pack_bf16(x0, x1);
}

// The products of one operand pair in P pieces each: P = 1, the bf16 product;
// P = 3, six piece products smallest first (a3.b1, a1.b3, a2.b2, a2.b1,
// a1.b2, a1.b1), product i reading A piece a(i) and B piece b(i).
template <int P>
struct Pieces {
  static_assert(P == 1 || P == 3, "one piece (bf16) or three (fp32)");
  static constexpr int kProducts = P == 3 ? 6 : 1;
  __host__ __device__ static constexpr int a(int i) { return P == 1 ? 0 : i == 0 ? 2 : i == 2 || i == 3 ? 1 : 0; }
  __host__ __device__ static constexpr int b(int i) { return P == 1 ? 0 : i == 1 ? 2 : i == 2 || i == 4 ? 1 : 0; }
};

// The accumulator layout of a 64-column wgmma (32 floats a thread: columns
// 8j + 2t, +1 of rows g and g + 8 in d[4j..4j+3]) as the four A fragments
// of the next product's k-steps of 16 in each of P pieces: a[piece * 4 +
// kk], rounded to bf16 (P = 1) or split exactly (P = 3).
template <int P>
__device__ __forceinline__ void acc_to_a(const float (&d)[32], uint32_t (&a)[4 * P][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (P == 1)
        a[kk][j] = pack_bf16(d[8 * kk + 2 * j], d[8 * kk + 2 * j + 1]);
      else
        split3_bf16(d[8 * kk + 2 * j], d[8 * kk + 2 * j + 1], a[kk][j], a[4 + kk][j],
                    a[8 + kk][j]);
    }
  }
}

// An accumulator the next product starts afresh (scale_d = 0): its old
// values become dead here, at no instruction. wgmma's asm names its
// accumulators read-write, so without this they would stay live, in
// registers, from their last use to the next product.
template <int N>
__device__ __forceinline__ void fresh_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "=f"(r[i]));
}

// exp2 of the softmax: ex2.approx in bf16, the accurate exp2f in fp32
template <int P>
__device__ __forceinline__ float softmax_exp2(float x) {
  if constexpr (P == 1) return fast_exp2(x);
  else return exp2f(x);
}

// Two outputs of a thread's accumulator pair at `dst`: bf16 (P = 1) or fp32.
template <int P>
__device__ __forceinline__ void store2(void* dst, float x0, float x1) {
  if constexpr (P == 1) *reinterpret_cast<uint32_t*>(dst) = pack_bf16(x0, x1);
  else *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
}

// Up to four fp32 tensors of n4 float4s each into three bf16 pieces:
// out[p * n4 + i] holds piece p of x[i] (an element's pieces are [3, n]
// apart). grid (blocks, jobs); the widths are multiples of 8, so every
// tensor is whole float4s and its pieces start 16-byte aligned.
struct Split3Jobs {
  const float4* x[4];
  uint2* out[4];
  size_t n4[4];
};

__global__ void __launch_bounds__(256) flash_split3_kernel(const Split3Jobs jobs) {
  const int j = blockIdx.y;
  const float4* x = jobs.x[j];
  uint2* out = jobs.out[j];
  const size_t n4 = jobs.n4[j];
  for (size_t i = size_t(blockIdx.x) * 256 + threadIdx.x; i < n4; i += size_t(gridDim.x) * 256) {
    const float4 v = x[i];
    uint32_t h0, m0, l0, h1, m1, l1;
    split3_bf16(v.x, v.y, h0, m0, l0);
    split3_bf16(v.z, v.w, h1, m1, l1);
    out[i] = make_uint2(h0, h1);
    out[n4 + i] = make_uint2(m0, m1);
    out[2 * n4 + i] = make_uint2(l0, l1);
  }
}

// Launch flash_split3_kernel on `count` (x, elements) pairs, the pieces of
// each after those of the one before in `pieces`.
inline cudaError_t split3(cudaStream_t stream, __nv_bfloat16* pieces, int count,
                          const void* const* xs, const size_t* elems) {
  Split3Jobs jobs{};
  size_t most = 0;
  for (int j = 0; j < count; ++j) {
    jobs.x[j] = static_cast<const float4*>(xs[j]);
    jobs.out[j] = reinterpret_cast<uint2*>(pieces);
    jobs.n4[j] = elems[j] / 4;
    most = jobs.n4[j] > most ? jobs.n4[j] : most;
    pieces += 3 * elems[j];
  }
  const size_t blocks = (most + 255) / 256;
  flash_split3_kernel<<<dim3(unsigned(blocks < 2048 ? blocks : 2048), count), 256, 0, stream>>>(jobs);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// B2, bf16: wgmma + TMA
// ---------------------------------------------------------------------------

// Shared memory of the forward, in bytes from the 1024-aligned base: the Q
// tile, `stages` K tiles, `stages` V tiles (DVS / 64 sub-tiles of 64 x 64,
// 8 KB each), each tile as P pieces one after the other, then 1 + stages
// mbarriers. The plan mirrors this.
struct FwdLayout {
  int k_off, v_off, bar_off, k_stage, v_stage;
  size_t bytes;
};

__host__ __device__ inline FwdLayout fwd_layout(int dkp, int dvs, int stages, int pieces) {
  FwdLayout L;
  L.k_stage = pieces * kBK * dkp * 2;  // a piece: 2, 4, 8 or 16 KB
  L.v_stage = pieces * kBK * dvs * 2;  // a piece: a multiple of 8 KB
  L.k_off = pieces * kBQ * dkp * 2;
  L.v_off = L.k_off + stages * L.k_stage;
  L.bar_off = L.v_off + stages * L.v_stage;
  L.bytes = size_t(L.bar_off) + 8 * (1 + stages) + 1024;  // + slack to align the base
  return L;
}

// grid (q_tiles * n_slices, B); block 128 (one warpgroup). DKP = dk padded
// to 16, 32, 64 or 128 (QkRows), DVS = the dv slice padded to a multiple of
// 64. P = 1: q, k, v and o bf16; P = 3: the maps read the pieces [3B, rows,
// cols] of fp32 q, k, v (piece p of batch row b is row p * B + b) and o is
// fp32.
template <int DKP, int DVS, int P>
__global__ void __launch_bounds__(128, P == 3 || DVS > 128 ? 2 : 3)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, void* __restrict__ o,
                       float* __restrict__ lse, int N, int M, int dv, int n_slices, int stages,
                       float c /* scale * log2(e) */) {
  using namespace sm90;
  using R = QkRows<DKP>;
  using Pc = Pieces<P>;
  constexpr int SW = R::SW;
  constexpr uint32_t kTileBytes = kBK * DKP * 2, vTileBytes = kBK * DVS * 2;  // one piece
  const FwdLayout L = fwd_layout(DKP, DVS, stages, P);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L.bar_off);  // [0] Q, [1 + s] stage s

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int slice = blockIdx.x % n_slices;
  const int q0 = (blockIdx.x / n_slices) * kBQ;
  const int col0 = slice * DVS;
  const int b = blockIdx.y, nb = gridDim.y;
  const int n_tiles = (M + kBK - 1) / kBK;

  auto issue = [&](int tile, int st) {
    uint64_t* bar = bars + 1 + st;
    mbar_arrive_expect_tx(bar, P * (kTileBytes + vTileBytes));
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int h = 0; h < R::BOXES; ++h)
        tma_load_3d(sm + L.k_off + st * L.k_stage + p * kTileBytes + h * R::BOX_BYTES, &tk, bar,
                    h * SW / 2, tile * kBK, p * nb + b);
#pragma unroll
      for (int j = 0; j < DVS / 64; ++j)
        tma_load_3d(sm + L.v_off + st * L.v_stage + p * vTileBytes + j * 8192, &tv, bar,
                    col0 + 64 * j, tile * kBK, p * nb + b);
    }
  };
  if (tid == 0) {
    for (int s = 0; s <= stages; ++s) mbar_init(bars + s, 1);
    fence_mbar_init();
    mbar_arrive_expect_tx(bars, P * kBQ * DKP * 2);
    for (int p = 0; p < P; ++p)
      for (int h = 0; h < R::BOXES; ++h)
        tma_load_3d(sm + p * kBQ * DKP * 2 + h * R::BOX_BYTES, &tq, bars, h * SW / 2, q0, p * nb + b);
    for (int s = 0; s < stages && s < n_tiles; ++s) issue(s, s);
  }
  __syncthreads();

  const uint64_t q_desc = make_desc(sm, 16, 8 * SW, SW);
  // S = Q.K^T: both K-major, one k-step of 16 per 32 bytes of row; the
  // pieces' products smallest first, each over every k-step
  auto qk = [&](float (&s)[32], int st) {
    const uint64_t k_desc = make_desc(sm + L.k_off + st * L.k_stage, 16, 8 * SW, SW);
#pragma unroll
    for (int i = 0; i < Pc::kProducts; ++i)
#pragma unroll
      for (int ks = 0; ks < DKP / 16; ++ks)
        wgmma_ss<64, 0, 0>(s, desc_advance(q_desc, Pc::a(i) * kBQ * DKP * 2 + R::kstep(ks)),
                           desc_advance(k_desc, Pc::b(i) * kTileBytes + R::kstep(ks)),
                           i > 0 || ks > 0);
  };
  // O: bf16 adds each tile's P.V into acc; fp32 sums a tile's in a fresh
  // accumulator `tacc` and adds that into acc in fp32 (rounded to nearest),
  // since the tensor core's adds truncate and a bias over hundreds of tiles
  // in one accumulator would outgrow fp32's tolerance
  float acc[DVS / 2], tacc[P == 3 ? DVS / 2 : 1];
#pragma unroll
  for (int i = 0; i < DVS / 2; ++i) acc[i] = 0.f;
  // P.V: V read MN-major, 16 keys (2 KB of rows) a k-step, sub-tiles 8 KB apart
  auto pv = [&](const uint32_t (&pa)[4 * P][4], int st) {
    const uint64_t v_desc = make_desc(sm + L.v_off + st * L.v_stage, 8192, 1024, 128);
#pragma unroll
    for (int i = 0; i < Pc::kProducts; ++i)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t vd = desc_advance(v_desc, Pc::b(i) * vTileBytes + 2048 * kk);
        if constexpr (P == 1) wgmma_rs<DVS, 1>(acc, pa[kk], vd, 1);
        else wgmma_rs<DVS, 1>(tacc, pa[Pc::a(i) * 4 + kk], vd, i > 0 || kk > 0);
      }
  };
  // acc = (acc + this tile's P.V) * alpha (fp32); bf16: acc *= alpha
  auto fold = [&](float alpha_lo, float alpha_hi) {
#pragma unroll
    for (int j = 0; j < DVS / 8; ++j) {
      if constexpr (P == 3) {
        acc[4 * j] += tacc[4 * j];
        acc[4 * j + 1] += tacc[4 * j + 1];
        acc[4 * j + 2] += tacc[4 * j + 2];
        acc[4 * j + 3] += tacc[4 * j + 3];
      }
      acc[4 * j] *= alpha_lo;
      acc[4 * j + 1] *= alpha_lo;
      acc[4 * j + 2] *= alpha_hi;
      acc[4 * j + 3] *= alpha_hi;
    }
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
    if constexpr (P == 1) {
      alpha_lo = fast_exp2(m_lo * c - sc_lo);  // 0 on the first tile
      alpha_hi = fast_exp2(m_hi * c - sc_hi);
    } else {  // no rounding while the max holds
      alpha_lo = mx_lo == m_lo ? 1.f : exp2f(m_lo * c - sc_lo);
      alpha_hi = mx_hi == m_hi ? 1.f : exp2f(m_hi * c - sc_hi);
    }
    m_lo = mx_lo;
    m_hi = mx_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[4 * j] = softmax_exp2<P>(fmaf(s[4 * j], c, -sc_lo));
      s[4 * j + 1] = softmax_exp2<P>(fmaf(s[4 * j + 1], c, -sc_lo));
      s[4 * j + 2] = softmax_exp2<P>(fmaf(s[4 * j + 2], c, -sc_hi));
      s[4 * j + 3] = softmax_exp2<P>(fmaf(s[4 * j + 3], c, -sc_hi));
      sum_lo += s[4 * j] + s[4 * j + 1];
      sum_hi += s[4 * j + 2] + s[4 * j + 3];
    }
    l_lo = l_lo * alpha_lo + sum_lo;
    l_hi = l_hi * alpha_hi + sum_hi;
  };

  uint32_t pa[4 * P][4];  // P of the tile whose P.V is next, bf16 A fragments (pieces)
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
    acc_to_a<P>(s, pa);
  }
  // fp32 at dkp 128 runs each tile's P.V before the next S (as one stage
  // must): S's accumulators and P's pieces are then never live together,
  // which keeps the registers within 255 without spilling
  constexpr bool kSerial = P == 3 && DKP == 128;
  for (int it = 1; it < n_tiles; ++it) {
    const int st = it % stages, prev = (it - 1) % stages;
    float s[32], alpha_lo, alpha_hi;
    fence_regs(acc);
    if (kSerial || stages == 1) {  // P.V of the last tile first, then free its stage
      if constexpr (P == 3) fresh_regs(tacc);
      wgmma_fence();
      pv(pa, prev);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if constexpr (P == 3) fence_regs(tacc);
      fence_regs(pa);
      __syncthreads();  // every warp is done with stage `prev`
      if (tid == 0 && it - 1 + stages < n_tiles) issue(it - 1 + stages, prev);
      mbar_wait(bars + 1 + st, (it / stages) & 1);
      wgmma_fence();
      qk(s, st);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      softmax(s, it, alpha_lo, alpha_hi);
    } else {
      mbar_wait(bars + 1 + st, (it / stages) & 1);
      if constexpr (P == 3) fresh_regs(tacc);
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
      if constexpr (P == 3) fence_regs(tacc);
      fence_regs(pa);
      __syncthreads();  // every warp is done with stage `prev`
      if (tid == 0 && it - 1 + stages < n_tiles) issue(it - 1 + stages, prev);
    }
    fold(alpha_lo, alpha_hi);
    acc_to_a<P>(s, pa);
  }
  fence_regs(acc);
  if constexpr (P == 3) fresh_regs(tacc);
  wgmma_fence();
  pv(pa, (n_tiles - 1) % stages);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  if constexpr (P == 3) fence_regs(tacc);
  fold(1.f, 1.f);

  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
  const int r_lo = q0 + warp * 16 + g, r_hi = r_lo + 8;
  constexpr int kOutBytes = P == 1 ? 2 : 4;
  uint8_t* ob = static_cast<uint8_t*>(o) + size_t(b) * N * dv * kOutBytes;
#pragma unroll
  for (int j = 0; j < DVS / 8; ++j) {
    const int col = col0 + j * 8 + 2 * t;
    if (col < dv) {
      if (r_lo < N)
        store2<P>(ob + (size_t(r_lo) * dv + col) * kOutBytes, acc[4 * j] * inv_lo,
                  acc[4 * j + 1] * inv_lo);
      if (r_hi < N)
        store2<P>(ob + (size_t(r_hi) * dv + col) * kOutBytes, acc[4 * j + 2] * inv_hi,
                  acc[4 * j + 3] * inv_hi);
    }
  }
  if (slice == 0 && t == 0) {
    if (r_lo < N) lse[size_t(b) * N + r_lo] = (m_lo * c + log2f(l_lo)) * kLn2;
    if (r_hi < N) lse[size_t(b) * N + r_hi] = (m_hi * c + log2f(l_hi)) * kLn2;
  }
}

template <int DKP, int DVS, int P>
cudaError_t launch_fwd_wgmma(dim3 grid, size_t smem, cudaStream_t stream, const void* q,
                             const void* k, const void* v, void* o, float* lse, int B, int N,
                             int M, int dk, int dv, int n_slices, int stages, float c) {
  constexpr int SW = QkRows<DKP>::SW;
  CUtensorMap tq, tk, tv;
  cudaError_t err = sm90::make_map_bf16(&tq, q, P * B, N, dk, kBQ, SW / 2, SW);
  if (err == cudaSuccess) err = sm90::make_map_bf16(&tk, k, P * B, M, dk, kBK, SW / 2, SW);
  if (err == cudaSuccess) err = sm90::make_map_bf16(&tv, v, P * B, M, dv, kBK, 64, 128);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<DKP, DVS, P>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  flash_fwd_wgmma_kernel<DKP, DVS, P><<<grid, 128, smem, stream>>>(
      tq, tk, tv, o, lse, N, M, dv, n_slices, stages, c);
  return cudaGetLastError();
}

template <int DKP>
cudaError_t launch_fwd_wgmma_dvs(int dvs, dim3 grid, size_t smem, cudaStream_t stream,
                                 const void* q, const void* k, const void* v, void* o, float* lse,
                                 int B, int N, int M, int dk, int dv, int n_slices, int stages,
                                 float c) {
  switch (dvs) {
    case 64: return launch_fwd_wgmma<DKP, 64, 1>(grid, smem, stream, q, k, v, o, lse, B, N, M, dk, dv, n_slices, stages, c);
    case 128: return launch_fwd_wgmma<DKP, 128, 1>(grid, smem, stream, q, k, v, o, lse, B, N, M, dk, dv, n_slices, stages, c);
    case 192: return launch_fwd_wgmma<DKP, 192, 1>(grid, smem, stream, q, k, v, o, lse, B, N, M, dk, dv, n_slices, stages, c);
    case 256: return launch_fwd_wgmma<DKP, 256, 1>(grid, smem, stream, q, k, v, o, lse, B, N, M, dk, dv, n_slices, stages, c);
    default: return cudaErrorInvalidValue;
  }
}

// fp32 (three pieces): dv slices of 64 columns (the registers of acc, tacc,
// S and P's pieces)
template <int DKP>
cudaError_t launch_fwd_bf16x3(int dvs, dim3 grid, size_t smem, cudaStream_t stream,
                              const void* q, const void* k, const void* v, void* o, float* lse,
                              int B, int N, int M, int dk, int dv, int n_slices, int stages,
                              float c) {
  if (dvs != 64) return cudaErrorInvalidValue;
  return launch_fwd_wgmma<DKP, 64, 3>(grid, smem, stream, q, k, v, o, lse, B, N, M, dk, dv, n_slices, stages, c);
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
// fp32 runs the split design (below) at every width on the pieces of B2's
// note: q, k, v and dO split by flash_split3_kernel in the same call, every
// product as six piece products, P^T and dS^T split in registers where they
// are made, the accurate exp2f, D and lse*log2e from flash_bwd_prep_kernel
// in fp32, each q tile's dV and dK summed in fresh accumulators added in
// fp32. Tripled tiles do not leave room for all of dv beside dK in one
// warpgroup's registers and shared memory, so dv slices are at most 128
// columns and the plan picks the ring's stages, the chunk ring's and the dq
// buffers by shape. The one-block design above, on three pieces, ran level
// 2 faster on the H100 but spilled at dv 128 in every arrangement tried:
// three times the k-steps' shared-memory descriptors (PERF.md).
// ===========================================================================

constexpr int kBwdBK = 64;        // keys per block
constexpr int kBwdBQ = 64;        // q rows per sweep step
constexpr int kBwdThreads = 128;  // 4 warps (one warpgroup)
constexpr int kBwdMaxDv = 512;
constexpr int kStatBytes = 2 * kBwdBQ * 4;  // lse*log2e and D of one q tile

// D = rowsum(do*o) and lse*log2e of every q row into stat [B, q_tiles, 2,
// 64], zero past N, from bf16 or fp32 o and do. grid (q_tiles, B); block
// 256: a warp per row, 8 at once.
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_prep_kernel(const T* __restrict__ o, const T* __restrict__ dout,
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
      for (int i = lane; i < dv * int(sizeof(T)) / 16; i += 32) {
        const uint4 x = ob[i], y = db[i];
        if constexpr (sizeof(T) == 2) {
          const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&x);
          const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 xf = __bfloat1622float2(xs[j]), yf = __bfloat1622float2(ys[j]);
            d = fmaf(xf.x, yf.x, fmaf(xf.y, yf.y, d));
          }
        } else {
          const float* xs = reinterpret_cast<const float*>(&x);
          const float* ys = reinterpret_cast<const float*>(&y);
          d = fmaf(xs[0], ys[0], fmaf(xs[1], ys[1], fmaf(xs[2], ys[2], fmaf(xs[3], ys[3], d))));
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
    acc_to_a<1>(s, pa);
    if (lead) acc_to_a<1>(dp, da);

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
// B3, split: bf16 q/k rows of 128 columns or dv above 512; fp32 at every width
// ---------------------------------------------------------------------------
//
// flash_bwd_wgmma_kernel keeps dK, dV (all of dv, over one or two
// warpgroups) and the score tiles in registers at once, which holds up to
// dkp 64 and dv 512 in bf16. Past either, and in fp32 (P = 3 pieces), the
// work of a key tile is split over blocks of two classes (grid (key_tiles *
// (n_slices + 1), B), one warpgroup each), so that no block holds more than
// one of dK and dV:
//   - n_slices dV blocks, one per dv slice of DVS <= 256 columns (<= 128 in
//     fp32): each recomputes S^T = K.Q^T and P^T for every q tile and adds
//     P^T.dO of its slice into dV (the forward's structure with keys and q
//     rows swapped);
//   - one dK/dQ block: S^T and P^T likewise, dP^T = V.dO^T as a loop over
//     dv in chunks of 64 columns (V and dO chunks streamed through a TMA ring
//     of `cstages`, so no width of dv needs more shared memory or
//     registers), then dS^T, dK += dS^T.Q, and dQ = dS.K by halves of <= 64
//     columns into the bulk reduce-add of flash_bwd_wgmma_kernel (through
//     `dqb` fp32 tile buffers: two overlap a tile's reduce with the next
//     tile, one where two do not fit).
// S^T and P^T are computed n_slices + 1 times per key tile: the price of
// any width. The q/k operand layouts at dkp 128 are those of V and dO
// (QkRows: two 64-column boxes, K-major k-steps across the pair, MN-major
// with the 8 KB box step as the leading byte offset). Every tile holds P
// pieces one after the other.

struct BwdSplitLayout {
  int q_off, x_off, ds_off, dq_off, stat_off, bar_off, q_stage, do_stage, dq_buf, chunk;
  size_t bytes;
};

// Shared memory of the split backward, in bytes from the 1024-aligned base:
// K, `stages` Q tiles, then the class's own part (a dV block's `stages` dO
// slices; a dK/dQ block's ring of `cstages` V and dO chunks, dS^T and `dqb`
// fp32 dq tiles), `stages` lse/D tiles, and the mbarriers: [0] K, [1 + s] q
// stage s, [1 + stages + r] chunk stage r. Each bf16 tile as `pieces`
// pieces. The plan mirrors this.
__host__ __device__ inline BwdSplitLayout bwd_split_layout(int dkp, int dvs, int dk, int stages,
                                                           int cstages, int dqb, int pieces) {
  BwdSplitLayout L;
  L.q_stage = pieces * kBwdBQ * dkp * 2;
  L.do_stage = pieces * kBwdBQ * dvs * 2;
  L.dq_buf = kBwdBQ * dk * 4;
  L.chunk = pieces * 2 * kBwdBK * 64 * 2;  // a V chunk's pieces, then a dO chunk's
  L.q_off = pieces * kBwdBK * dkp * 2;
  L.x_off = L.q_off + stages * L.q_stage;
  L.ds_off = L.x_off + cstages * L.chunk;
  L.dq_off = L.ds_off + pieces * kBwdBK * kBwdBQ * 2;
  const int dv_end = L.x_off + stages * L.do_stage, dq_end = L.dq_off + dqb * L.dq_buf;
  L.stat_off = dv_end > dq_end ? dv_end : dq_end;
  L.bar_off = L.stat_off + stages * kStatBytes;
  L.bytes = size_t(L.bar_off) + 8 * (1 + stages + cstages) + 1024;
  return L;
}

// P = 1: q, k, v, dO bf16, dK and dV written bf16; P = 3: the maps read the
// pieces [3B, rows, cols] of fp32 q, k, v, dO (piece p of batch row b is
// row p * B + b), dK and dV are written fp32.
template <int DKP, int DVS, int P>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_split_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                       const float* __restrict__ stat, float* __restrict__ dq,
                       void* __restrict__ dk_out, void* __restrict__ dv_out, int N, int M, int dk,
                       int dv, int n_slices, int stages, int cstages, int dqb, float c,
                       float scale) {
  using namespace sm90;
  using R = QkRows<DKP>;
  using Pc = Pieces<P>;
  constexpr int SW = R::SW;
  constexpr int DKH = DKP / R::BOXES;  // dQ's columns a product: one box
  constexpr uint32_t qBytes = kBwdBQ * DKP * 2, doBytes = kBwdBQ * DVS * 2;  // one piece
  constexpr int kOutBytes = P == 1 ? 2 : 4;
  const BwdSplitLayout L = bwd_split_layout(DKP, DVS, dk, stages, cstages, dqb, P);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L.bar_off);
  uint64_t* chunk_bars = bars + 1 + stages;

  const int role = blockIdx.x % (n_slices + 1);  // < n_slices: dV of that slice; else dK and dQ
  const bool dv_block = role < n_slices;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = (blockIdx.x / (n_slices + 1)) * kBwdBK;
  const int b = blockIdx.y, nb = gridDim.y;
  const int col0 = role * DVS;
  const int n_qt = (N + kBwdBQ - 1) / kBwdBQ;
  const int n_ch = (dv + 63) / 64;
  const int n_seq = n_qt * n_ch;  // the dK/dQ block's chunk loads
  const float* statb = stat + size_t(b) * n_qt * (2 * kBwdBQ);

  auto issue = [&](int tile, int st) {  // Q, lse/D and (dV blocks) the dO slice of q tile `tile`
    uint64_t* bar = bars + 1 + st;
    mbar_arrive_expect_tx(bar, P * qBytes + kStatBytes + (dv_block ? P * doBytes : 0));
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int h = 0; h < R::BOXES; ++h)
        tma_load_3d(sm + L.q_off + st * L.q_stage + p * qBytes + h * R::BOX_BYTES, &tq, bar,
                    h * SW / 2, tile * kBwdBQ, p * nb + b);
      if (dv_block) {
#pragma unroll
        for (int j = 0; j < DVS / 64; ++j)
          tma_load_3d(sm + L.x_off + st * L.do_stage + p * doBytes + j * 8192, &tdo, bar,
                      col0 + 64 * j, tile * kBwdBQ, p * nb + b);
      }
    }
    bulk_load(sm + L.stat_off + st * kStatBytes, statb + size_t(tile) * (2 * kBwdBQ), kStatBytes,
              bar);
  };
  // V and dO columns 64 * (seq % n_ch) of q tile seq / n_ch, P pieces each
  auto issue_chunk = [&](int seq, int r) {
    uint64_t* bar = chunk_bars + r;
    uint8_t* dst = sm + L.x_off + r * L.chunk;
    mbar_arrive_expect_tx(bar, L.chunk);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      tma_load_3d(dst + p * 8192, &tv, bar, 64 * (seq % n_ch), k0, p * nb + b);
      tma_load_3d(dst + (P + p) * 8192, &tdo, bar, 64 * (seq % n_ch), (seq / n_ch) * kBwdBQ,
                  p * nb + b);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < 1 + stages + cstages; ++s) mbar_init(bars + s, 1);
    fence_mbar_init();
    mbar_arrive_expect_tx(bars, P * kBwdBK * DKP * 2);
    for (int p = 0; p < P; ++p)
      for (int h = 0; h < R::BOXES; ++h)
        tma_load_3d(sm + p * kBwdBK * DKP * 2 + h * R::BOX_BYTES, &tk, bars, h * SW / 2, k0,
                    p * nb + b);
    for (int s = 0; s < stages && s < n_qt; ++s) issue(s, s);
    if (!dv_block)
      for (int r = 0; r < cstages && r < n_seq; ++r) issue_chunk(r, r);
  }
  __syncthreads();

  constexpr uint32_t kTileBytes = kBwdBK * DKP * 2;  // one piece of K
  const uint64_t k_desc = make_desc(sm, 16, 8 * SW, SW);
  const int krow = warp * 16 + g;  // this thread's keys: krow, krow + 8
  const bool key_lo_ok = k0 + krow < M, key_hi_ok = k0 + krow + 8 < M;
  const int key_lo = k0 + krow, key_hi = key_lo + 8;

  // S^T = K.Q^T of the q tile in stage st (issued, not waited for), both K-major
  auto scores = [&](float (&s)[32], const uint8_t* q_s) {
    const uint64_t q_desc = make_desc(q_s, 16, 8 * SW, SW);
#pragma unroll
    for (int i = 0; i < Pc::kProducts; ++i)
#pragma unroll
      for (int ks = 0; ks < DKP / 16; ++ks)
        wgmma_ss<64, 0, 0>(s, desc_advance(k_desc, Pc::a(i) * kTileBytes + R::kstep(ks)),
                           desc_advance(q_desc, Pc::b(i) * qBytes + R::kstep(ks)),
                           i > 0 || ks > 0);
  };
  // P^T = exp2(S^T*c - lse*log2e) in place; keys past M get none
  auto probs = [&](float (&s)[32], const float* l2) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j * 8 + 2 * t;
      const float l0 = l2[col], l1 = l2[col + 1];
      s[4 * j] = key_lo_ok ? softmax_exp2<P>(fmaf(s[4 * j], c, -l0)) : 0.f;
      s[4 * j + 1] = key_lo_ok ? softmax_exp2<P>(fmaf(s[4 * j + 1], c, -l1)) : 0.f;
      s[4 * j + 2] = key_hi_ok ? softmax_exp2<P>(fmaf(s[4 * j + 2], c, -l0)) : 0.f;
      s[4 * j + 3] = key_hi_ok ? softmax_exp2<P>(fmaf(s[4 * j + 3], c, -l1)) : 0.f;
    }
  };

  // In fp32 each q tile's dV and dK terms sum in a fresh accumulator that
  // is then added into the running one in fp32 (rounded to nearest): the
  // tensor core's adds truncate, and over hundreds of q tiles in one
  // accumulator their bias would outgrow fp32's tolerance (B2's note).
  mbar_wait(bars, 0);
  if (dv_block) {
    float dv_acc[DVS / 2], dv_t[P == 3 ? DVS / 2 : 1];
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
      uint32_t pa[4 * P][4];
      acc_to_a<P>(s, pa);
      // dV += P^T.dO of this slice (dO MN-major, 16 q rows a k-step)
      const uint64_t do_desc = make_desc(sm + L.x_off + st * L.do_stage, 8192, 1024, 128);
      fence_regs(dv_acc);
      if constexpr (P == 3) fresh_regs(dv_t);
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < Pc::kProducts; ++i)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t dd = desc_advance(do_desc, Pc::b(i) * doBytes + 2048 * kk);
          if constexpr (P == 1) wgmma_rs<DVS, 1>(dv_acc, pa[kk], dd, 1);
          else wgmma_rs<DVS, 1>(dv_t, pa[Pc::a(i) * 4 + kk], dd, i > 0 || kk > 0);
        }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      if constexpr (P == 3) fence_regs(dv_t);
      fence_regs(pa);
      if constexpr (P == 3) {
#pragma unroll
        for (int i = 0; i < DVS / 2; ++i) dv_acc[i] += dv_t[i];
      }
      __syncthreads();  // stage `st` is consumed
      if (tid == 0 && it + stages < n_qt) issue(it + stages, st);
    }
    uint8_t* dvb = static_cast<uint8_t*>(dv_out) + size_t(b) * M * dv * kOutBytes;
#pragma unroll
    for (int j = 0; j < DVS / 8; ++j) {
      const int col = col0 + j * 8 + 2 * t;
      if (col < dv) {
        if (key_lo < M)
          store2<P>(dvb + (size_t(key_lo) * dv + col) * kOutBytes, dv_acc[4 * j], dv_acc[4 * j + 1]);
        if (key_hi < M)
          store2<P>(dvb + (size_t(key_hi) * dv + col) * kOutBytes, dv_acc[4 * j + 2],
                    dv_acc[4 * j + 3]);
      }
    }
    return;
  }

  // the dK/dQ block
  uint8_t* ds_s = sm + L.ds_off;
  const uint64_t ds_desc = make_desc(ds_s, 16, 1024, 128);
  float dk_acc[DKP / 2], dk_t[P == 3 ? DKH / 2 : 1];
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
      // the ring is 1 or 2 deep: its slot and phase without a division
      const int r = cstages == 1 ? 0 : seq & 1;
      mbar_wait(chunk_bars + r, (cstages == 1 ? seq : seq >> 1) & 1);
      const uint8_t* v_c = sm + L.x_off + r * L.chunk;
      const uint64_t v_desc = make_desc(v_c, 16, 1024, 128);
      const uint64_t do_desc = make_desc(v_c + P * 8192, 16, 1024, 128);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < Pc::kProducts; ++i)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<64, 0, 0>(dp, desc_advance(v_desc, Pc::a(i) * 8192 + 32 * kk),
                             desc_advance(do_desc, Pc::b(i) * 8192 + 32 * kk),
                             ch > 0 || i > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dp);
      __syncthreads();  // chunk stage r is consumed
      if (tid == 0 && seq + cstages < n_seq) issue_chunk(seq + cstages, r);
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
    uint32_t da[4 * P][4];
    acc_to_a<P>(dp, da);
    if constexpr (P == 1) {
      // dK += dS^T.Q from registers (Q MN-major, 16 q rows a k-step; at dkp
      // 128 its two boxes are 8 KB apart along N)
      const uint64_t q_mn = make_desc(q_s, DKP <= 64 ? 16 : R::BOX_BYTES, 8 * SW, SW);
      fence_regs(dk_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<DKP, 1>(dk_acc, da[kk], desc_advance(q_mn, 16 * SW * kk), 1);
      wgmma_commit();
    }
    // dS^T (keys x 64 q, bf16 pieces, 8 KB apart) to shared memory in the
    // 128-byte swizzle: the 16-byte chunk j of row r sits at chunk j ^ (r % 8)
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = 2 * kk + h;
          const int r0 = krow, r1 = krow + 8;
          *reinterpret_cast<uint32_t*>(ds_s + p * 8192 + r0 * 128 + ((j ^ (r0 & 7)) << 4) + 4 * t) =
              da[p * 4 + kk][2 * h];
          *reinterpret_cast<uint32_t*>(ds_s + p * 8192 + r1 * 128 + ((j ^ (r1 & 7)) << 4) + 4 * t) =
              da[p * 4 + kk][2 * h + 1];
        }
      }
    }
    fence_proxy_async();
    __syncthreads();  // dS^T of every warp is in shared memory
    if constexpr (P == 3) {
      // dK += dS^T.Q from shared memory (dS^T K-major, Q MN-major), a box of
      // Q's columns at a time into a fresh accumulator added in fp32: dS's
      // register pieces are dead by now, which keeps dkp 128 within 255
      // registers
#pragma unroll
      for (int h = 0; h < R::BOXES; ++h) {
        const uint64_t q_box = make_desc(q_s + h * R::BOX_BYTES, 16, 8 * SW, SW);
        fresh_regs(dk_t);
        wgmma_fence();
#pragma unroll
        for (int i = 0; i < Pc::kProducts; ++i)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss<DKH, 0, 1>(dk_t, desc_advance(ds_desc, Pc::a(i) * 8192 + 32 * kk),
                                desc_advance(q_box, Pc::b(i) * qBytes + 16 * SW * kk),
                                i > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        if constexpr (P == 3) fence_regs(dk_t);
#pragma unroll
        for (int i = 0; i < DKH / 2; ++i) dk_acc[h * DKH / 2 + i] += dk_t[i];
      }
    }

    // dQ = dS.K over the block's 64 keys, one box of K's columns at a time
    // (dS^T and K MN-major), scaled into this tile's fp32 dq buffer
    float* dq_s = reinterpret_cast<float*>(sm + L.dq_off + (dqb == 2 ? it & 1 : 0) * L.dq_buf);
    const int qr = warp * 16 + g;
#pragma unroll
    for (int h = 0; h < R::BOXES; ++h) {
      float dqa[DKH / 2];
      const uint64_t k_mn = make_desc(sm + h * R::BOX_BYTES, 16, 8 * SW, SW);
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < Pc::kProducts; ++i)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<DKH, 1, 1>(dqa, desc_advance(ds_desc, Pc::a(i) * 8192 + 2048 * kk),
                              desc_advance(k_mn, Pc::b(i) * kTileBytes + 16 * SW * kk),
                              i > 0 || kk > 0);
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
    if constexpr (P == 1) fence_regs(da);  // fp32: dK reads dS^T from shared memory
    fence_proxy_async();
    __syncthreads();  // the dq tile is written; stage `st` and dS^T are consumed
    if (tid == 0) {
      const int rows = min(kBwdBQ, N - it * kBwdBQ);
      float* dq_tile = dq + (size_t(b) * N + size_t(it) * kBwdBQ) * dk;
      bulk_reduce_add_f32(dq_tile, dq_s, uint32_t(rows * dk * 4));
      bulk_commit();
      // the buffer the next tile writes is free
      if (dqb == 2) bulk_wait_read<1>();
      else bulk_wait_read<0>();
      if (it + stages < n_qt) issue(it + stages, st);
    }
  }
  if (tid == 0) bulk_wait_all();

  uint8_t* dkb = static_cast<uint8_t*>(dk_out) + size_t(b) * M * dk * kOutBytes;
#pragma unroll
  for (int j = 0; j < DKP / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (col < dk) {
      if (key_lo < M)
        store2<P>(dkb + (size_t(key_lo) * dk + col) * kOutBytes, dk_acc[4 * j] * scale,
                  dk_acc[4 * j + 1] * scale);
      if (key_hi < M)
        store2<P>(dkb + (size_t(key_hi) * dk + col) * kOutBytes, dk_acc[4 * j + 2] * scale,
                  dk_acc[4 * j + 3] * scale);
    }
  }
}

template <int DKP, int DVS, int P>
cudaError_t launch_bwd_split(dim3 grid, size_t smem, cudaStream_t stream, const void* q,
                             const void* k, const void* v, const void* dout, const float* stat,
                             float* dq, void* dk_out, void* dv_out, int B, int N, int M, int dk,
                             int dv, int n_slices, int stages, int cstages, int dqb, float c,
                             float scale) {
  constexpr int SW = QkRows<DKP>::SW;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = sm90::make_map_bf16(&tq, q, P * B, N, dk, kBwdBQ, SW / 2, SW);
  if (err == cudaSuccess) err = sm90::make_map_bf16(&tk, k, P * B, M, dk, kBwdBK, SW / 2, SW);
  if (err == cudaSuccess) err = sm90::make_map_bf16(&tv, v, P * B, M, dv, kBwdBK, 64, 128);
  if (err == cudaSuccess) err = sm90::make_map_bf16(&tdo, dout, P * B, N, dv, kBwdBQ, 64, 128);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_split_kernel<DKP, DVS, P>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  flash_bwd_split_kernel<DKP, DVS, P><<<grid, kBwdThreads, smem, stream>>>(
      tq, tk, tv, tdo, stat, dq, dk_out, dv_out, N, M, dk, dv, n_slices, stages, cstages, dqb, c,
      scale);
  return cudaGetLastError();
}

// the (dkp, dv slice) pairs the plan gives the split design in bf16: dkp
// 128 at any slice; dkp <= 64 only above dv 512, where three or more slices
// of <= 256 are each wider than 170 columns. In fp32 (ADEPTH_SPLIT3) every
// dkp with slices of 64 or 128.
cudaError_t launch_bwd_split_any(int pieces, int dkp, int dvs, dim3 grid, size_t smem,
                                 cudaStream_t stream, const void* q, const void* k, const void* v,
                                 const void* dout, const float* stat, float* dq, void* dk_out,
                                 void* dv_out, int B, int N, int M, int dk, int dv, int n_slices,
                                 int stages, int cstages, int dqb, float c, float scale) {
#define ADEPTH_SPLIT_CASE(P, D, S) \
  case (P * 1000 + D) * 1000 + S: return launch_bwd_split<D, S, P>(grid, smem, stream, q, k, v, dout, stat, dq, dk_out, dv_out, B, N, M, dk, dv, n_slices, stages, cstages, dqb, c, scale);
#define ADEPTH_SPLIT(D, S) ADEPTH_SPLIT_CASE(1, D, S)
#define ADEPTH_SPLIT3(D, S) ADEPTH_SPLIT_CASE(3, D, S)
  switch ((pieces * 1000 + dkp) * 1000 + dvs) {
    ADEPTH_SPLIT(16, 192) ADEPTH_SPLIT(16, 256) ADEPTH_SPLIT(32, 192) ADEPTH_SPLIT(32, 256)
    ADEPTH_SPLIT(64, 192) ADEPTH_SPLIT(64, 256) ADEPTH_SPLIT(128, 64) ADEPTH_SPLIT(128, 128)
    ADEPTH_SPLIT(128, 192) ADEPTH_SPLIT(128, 256)
    ADEPTH_SPLIT3(16, 64) ADEPTH_SPLIT3(16, 128) ADEPTH_SPLIT3(32, 64) ADEPTH_SPLIT3(32, 128)
    ADEPTH_SPLIT3(64, 64) ADEPTH_SPLIT3(64, 128) ADEPTH_SPLIT3(128, 64) ADEPTH_SPLIT3(128, 128)
    default: return cudaErrorInvalidValue;
  }
#undef ADEPTH_SPLIT3
#undef ADEPTH_SPLIT
#undef ADEPTH_SPLIT_CASE
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
  acc_to_a<1>(s, a);

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

// Kernel B2. The plan (ops/cuda/flash_attention.py) picks the variant (1:
// bf16 wgmma; 4: fp32 as three bf16 pieces on the same design), dkp, dvs,
// the block, stages, the shared memory bytes and grid.x; they are checked
// here against the kernel's own layout and a mismatch returns
// cudaErrorInvalidValue. Variant 4 first splits fp32 q, k and v into
// `pieces`, a bf16 scratch buffer of 3 * (B*N*dk + B*M*dk + B*M*dv)
// elements, and writes o in fp32. Launches on `stream` of `device`; returns
// cudaGetLastError() (0 on success). The caller checks shapes: dk and dv
// multiples of 8 (the wrapper zero-pads them), dk <= 128, 16-byte aligned
// contiguous tensors, B <= 65535.
int adepth_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                               void* pieces, int B, int N, int M, int dk, int dv, float scale,
                               int variant, int dkp, int dvs, int block, int stages,
                               long long smem, int grid_x, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dk <= 0 || dk > kMaxHeadDk || dk % 8 || dv <= 0 || dv % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const float c = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const int q_tiles = (N + kBQ - 1) / kBQ;
  const bool f32 = variant == 4;
  const int n_slices = f32 ? (dv + dvs - 1) / dvs : (dv + 255) / 256;
  if ((variant != 1 && !f32) || block != 128 || dkp < dk || dvs * n_slices < dv || dvs % 64 ||
      dvs > (f32 ? 64 : 256) || stages < 1 || (f32 && pieces == nullptr) ||
      size_t(smem) != fwd_layout(dkp, dvs, stages, f32 ? 3 : 1).bytes ||
      grid_x != q_tiles * n_slices)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(grid_x, B);
  if (f32) {
    __nv_bfloat16* q3 = static_cast<__nv_bfloat16*>(pieces);
    const void* xs[3] = {q, k, v};
    const size_t elems[3] = {size_t(B) * N * dk, size_t(B) * M * dk, size_t(B) * M * dv};
    err = split3(st, q3, 3, xs, elems);
    if (err != cudaSuccess) return static_cast<int>(err);
    const __nv_bfloat16* k3 = q3 + 3 * elems[0];
    const __nv_bfloat16* v3 = k3 + 3 * elems[1];
    switch (dkp) {
      case 16: err = launch_fwd_bf16x3<16>(dvs, grid, smem, st, q3, k3, v3, o, l, B, N, M, dk, dv, n_slices, stages, c); break;
      case 32: err = launch_fwd_bf16x3<32>(dvs, grid, smem, st, q3, k3, v3, o, l, B, N, M, dk, dv, n_slices, stages, c); break;
      case 64: err = launch_fwd_bf16x3<64>(dvs, grid, smem, st, q3, k3, v3, o, l, B, N, M, dk, dv, n_slices, stages, c); break;
      case 128: err = launch_fwd_bf16x3<128>(dvs, grid, smem, st, q3, k3, v3, o, l, B, N, M, dk, dv, n_slices, stages, c); break;
      default: err = cudaErrorInvalidValue;
    }
    return static_cast<int>(err);
  }
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
// dk and dv are written in the input dtype; lse is fp32 [B, N]. Every
// variant first runs flash_bwd_prep_kernel from o, dout and lse into `stat`
// [B, q_tiles, 2, 64] fp32. Variants: 2 (bf16 wgmma, one warpgroup a block
// for dv <= 256, two above, dkp <= 64 and dv <= 512), 3 (bf16 split: dV
// blocks per dv slice beside a dK/dQ block per key tile) and 5 (fp32: the
// split design on three bf16 pieces, q, k, v and dout split first into
// `pieces`, 3 * (B*N*dk + B*M*dk + B*M*dv + B*N*dv) bf16 elements). The
// plan's dkp, dvs (the dv columns of one warpgroup), block, stages, smem
// and grid_x, and for the split designs the chunk ring's stages `cstages`
// and the dq tile buffers `dqb`, are checked as in the forward. The caller
// checks shapes: dk and dv multiples of 8, dk <= 128, 16-byte aligned
// contiguous tensors, B <= 65535.
int adepth_flash_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                               const void* o, const void* lse, void* stat, void* pieces, void* dq,
                               void* dk_out, void* dv_out, int B, int N, int M, int dk, int dv,
                               float scale, int variant, int dkp, int dvs, int block, int stages,
                               long long smem, int grid_x, int cstages, int dqb, int device,
                               void* stream) {
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
  const int q_tiles = (N + kBwdBQ - 1) / kBwdBQ;
  const int wgs = block / kBwdThreads;
  const bool f32 = variant == 5;
  const int n_slices = f32 ? (dv + dvs - 1) / dvs : (dv + 255) / 256;
  bool ok;
  if (variant == 2) {
    ok = (wgs == 1 || wgs == 2) && block % kBwdThreads == 0 && dkp >= dk && dkp <= 64 &&
         dvs * wgs >= dv && dv <= kBwdMaxDv && !(wgs == 2 && dv <= 256) && dvs % 64 == 0 &&
         dvs <= 256 && stages >= 1 &&
         size_t(smem) == bwd_wg_layout(dkp, dvs * wgs, dk, stages, wgs).bytes &&
         grid_x == key_tiles;
  } else {
    ok = (variant == 3 || f32) && block == kBwdThreads && dkp >= dk && dvs * n_slices >= dv &&
         dvs % 64 == 0 && dvs <= (f32 ? 128 : 256) && stages >= 1 &&
         (cstages == 1 || cstages == 2) && (dqb == 1 || dqb == 2) && (!f32 || pieces != nullptr) &&
         size_t(smem) == bwd_split_layout(dkp, dvs, dk, stages, cstages, dqb, f32 ? 3 : 1).bytes &&
         grid_x == key_tiles * (n_slices + 1);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  float* stf = static_cast<float*>(stat);
  if (f32)
    flash_bwd_prep_kernel<float><<<dim3(q_tiles, B), 256, 0, st>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout), l, stf, N, dv);
  else
    flash_bwd_prep_kernel<__nv_bfloat16><<<dim3(q_tiles, B), 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), l, stf, N,
        dv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (f32) {
    __nv_bfloat16* q3 = static_cast<__nv_bfloat16*>(pieces);
    const void* xs[4] = {q, k, v, dout};
    const size_t elems[4] = {size_t(B) * N * dk, size_t(B) * M * dk, size_t(B) * M * dv,
                             size_t(B) * N * dv};
    err = split3(st, q3, 4, xs, elems);
    if (err != cudaSuccess) return static_cast<int>(err);
    const __nv_bfloat16* k3 = q3 + 3 * elems[0];
    const __nv_bfloat16* v3 = k3 + 3 * elems[1];
    const __nv_bfloat16* do3 = v3 + 3 * elems[2];
    return static_cast<int>(launch_bwd_split_any(3, dkp, dvs, grid, smem, st, q3, k3, v3, do3, stf,
                                                 dqf, dk_out, dv_out, B, N, M, dk, dv, n_slices,
                                                 stages, cstages, dqb, c, scale));
  }
  if (variant == 3)
    return static_cast<int>(launch_bwd_split_any(1, dkp, dvs, grid, smem, st, q, k, v, dout, stf,
                                                 dqf, dk_out, dv_out, B, N, M, dk, dv, n_slices,
                                                 stages, cstages, dqb, c, scale));
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
