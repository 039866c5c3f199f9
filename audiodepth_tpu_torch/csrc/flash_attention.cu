// Flash cross-attention forward for Hopper (sm_90a): kernel B2.
//
// Replaces the TPU kernel audiodepth_tpu/ops/pallas/flash_attention.py
// (_fwd_kernel, via _flash_fwd). Same function:
//   o   = softmax(q.k^T.scale).v          [B, N, dv], in the input dtype
//   lse = log sum_m exp(q.k^T.scale)      [B, N] fp32 (natural log)
// with q [B, N, dk], k [B, M, dk], v [B, M, dv], all bf16 or all fp32, and
// an online base-2 softmax with fp32 running max and sum.
//
// Differences from the TPU kernel. There the k axis was a sequential grid
// dimension with the running statistics in VMEM scratch; here it is a loop
// inside the block, and blocks over (q-tile, dv-slice, batch) run in
// parallel. The scale is not folded into a bf16 copy of q (a rounding the
// TPU kernel paid to save a VPU pass): the raw fp32 score s enters the
// softmax as exp2(s*c - m*c), c = scale*log2(e), one FFMA per score. No
// 128-lane padding of dk and no VMEM-driven block cap: dk is padded with
// zeros to a multiple of 16 in shared memory only, and ragged N and M are
// masked.
//
// Bound on the H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s; the exp2 unit
// (MUFU) does 16 ex2 a clock per SM, 132 SMs at 1.98 GHz = 4.18e12 ex2/s).
// At the binaural level-2 shape (2B = 32, N = M = 16384, dk = 16, dv = 128)
// the products are 2*32*16384^2*(16 + 128) = 2.47e12 FLOP = 2.50 ms, the
// softmax 8.6e9 ex2 = 2.05 ms, the bytes (q, k, v, o, lse once) ~0.3 GB =
// 0.09 ms: bound by tensor operations, with ex2 close behind. Level 5
// (N = 256) is bound by bytes.
//
// Design (bf16, FA2-style, simple first). A block of 4 warps owns a 64-row
// q tile (16 rows a warp) and a 128-wide slice of dv. Its q fragments stay in
// registers. k/v tiles of 64 keys go to shared memory with cp.async, double
// buffered. S = Q.K^T and O += P.V both run on the tensor cores as
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate); P never leaves registers: the
// accumulator layout of S is repacked to bf16 as the A operand of P.V. The
// rows padded by 8 bf16 keep ldmatrix free of bank conflicts. dv is split
// across blocks and the cheap Q.K^T (dk <= dv/2) is recomputed per slice; at
// level 2 (dv = 128) there is one slice, so no ex2 is repeated. Blocks are
// ordered batch-major, so the q tiles of one attention row reuse its k/v
// (4.7 MB at level 2) from the 50 MB L2. Known gaps: mma.sync reaches only
// part of the tensor cores' rate (wgmma, TMA and warp specialisation are the
// next step), and the softmax is not overlapped with the products. Measured
// by chip_smoke.py on an H100 80GB HBM3 at its 700 W limit: 11.5 ms at the
// level-2 shape (4.6x the bound, 215 TFLOP/s), where PyTorch's fused SDPA
// (its memory-efficient backend, the only one that takes dk != dv) takes
// 19.2 ms.
//
// fp32 runs the same tiling on the CUDA cores in full fp32 (no TF32): a
// 256-thread block, each thread owning 4 q rows x 4 keys of S and the same 4
// rows x 8 columns of O, with P passed through shared memory.
//
// The backward, kernel B3, follows B2 in this file (its own note is there).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;    // q rows per block
constexpr int kBK = 64;    // keys per k/v tile
constexpr int kDVS = 128;  // dv columns per block (the dv slice)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16), fp32 accumulators and statistics
// ---------------------------------------------------------------------------

constexpr int kThreadsBf16 = 128;  // 4 warps x 16 q rows

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// d += a.b for one 16x8x16 tile; a row-major 16x16, b col-major 16x8
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* base, bool valid) {
  return valid ? *reinterpret_cast<const uint32_t*>(base) : 0u;
}

template <int DKP>
struct Bf16Smem {
  static constexpr int kStride = DKP + 8;   // bf16 per k row (16-byte pad)
  static constexpr int vStride = kDVS + 8;  // bf16 per v row
  static constexpr int kStage = kBK * kStride;
  static constexpr int vStage = kBK * vStride;
  static constexpr size_t bytes = size_t(2) * (kStage + vStage) * sizeof(__nv_bfloat16);
};

// grid (q_tiles * n_slices, B); block 128. DKP = dk rounded up to 16.
template <int DKP>
__global__ void __launch_bounds__(kThreadsBf16)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, int N, int M, int dk, int dv, int n_slices,
                      float c /* scale * log2(e) */) {
  using L = Bf16Smem<DKP>;
  constexpr int KSTEPS = DKP / 16;
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* vs = ks + 2 * L::kStage;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / thread in group
  const int slice = blockIdx.x % n_slices;
  const int q0 = (blockIdx.x / n_slices) * kBQ;
  const int col0 = slice * kDVS;
  const size_t b = blockIdx.y;
  const __nv_bfloat16* qb = q + b * N * dk;
  const __nv_bfloat16* kb = k + b * M * dk;
  const __nv_bfloat16* vb = v + b * M * dv;

  // q fragments (A operand of S = Q.K^T), loaded once; zero past N and dk
  const int r_lo = q0 + warp * 16 + g, r_hi = r_lo + 8;
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s) {
    const int d = s * 16 + 2 * t;
    qa[s][0] = load_pair(qb + size_t(r_lo) * dk + d, r_lo < N && d < dk);
    qa[s][1] = load_pair(qb + size_t(r_hi) * dk + d, r_hi < N && d < dk);
    qa[s][2] = load_pair(qb + size_t(r_lo) * dk + d + 8, r_lo < N && d + 8 < dk);
    qa[s][3] = load_pair(qb + size_t(r_hi) * dk + d + 8, r_hi < N && d + 8 < dk);
  }

  auto load_tile = [&](int kv0, int stage) {
    __nv_bfloat16* kt = ks + stage * L::kStage;
    __nv_bfloat16* vt = vs + stage * L::vStage;
    constexpr int kChunks = DKP / 8;  // 16-byte chunks per k row
    for (int i = tid; i < kBK * kChunks; i += kThreadsBf16) {
      const int r = i / kChunks, ch = i - r * kChunks;
      const bool ok = kv0 + r < M && ch * 8 < dk;
      cp_async16(kt + r * L::kStride + ch * 8, ok ? kb + size_t(kv0 + r) * dk + ch * 8 : kb, ok);
    }
    constexpr int vChunks = kDVS / 8;
    for (int i = tid; i < kBK * vChunks; i += kThreadsBf16) {
      const int r = i / vChunks, ch = i - r * vChunks;
      const int col = col0 + ch * 8;
      const bool ok = kv0 + r < M && col < dv;
      cp_async16(vt + r * L::vStride + ch * 8, ok ? vb + size_t(kv0 + r) * dv + col : vb, ok);
    }
  };

  float acc[kDVS / 8][4];
#pragma unroll
  for (int j = 0; j < kDVS / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running max of the raw scores
  float l_lo = 0.f, l_hi = 0.f;              // this thread's part of the running sum

  // ldmatrix lane addressing: matrix index mi, row r8 within it
  const int mi = lane >> 3, r8 = lane & 7;
  const int n_tiles = (M + kBK - 1) / kBK;
  load_tile(0, 0);
  cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    const int kv0 = it * kBK;
    if (it + 1 < n_tiles) {
      load_tile(kv0 + kBK, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kt = ks + (it & 1) * L::kStage;
    const __nv_bfloat16* vt = vs + (it & 1) * L::vStage;

    // S = Q.K^T: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys
    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ss = 0; ss < KSTEPS; ++ss) {
#pragma unroll
      for (int np = 0; np < kBK / 16; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, kt + (np * 16 + r8 + (mi >> 1) * 8) * L::kStride + ss * 16 + (mi & 1) * 8);
        mma_bf16(s[2 * np], qa[ss], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qa[ss], bk[2], bk[3]);
      }
    }
    if (kv0 + kBK > M) {  // ragged last tile: keys past M get no weight
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        const int key = kv0 + j * 8 + 2 * t;
        if (key >= M) s[j][0] = s[j][2] = -INFINITY;
        if (key + 1 >= M) s[j][1] = s[j][3] = -INFINITY;
      }
    }

    // online softmax; a row's 64 scores lie on the 4 threads of a quad
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
    }
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
    // every tile holds at least one key < M, so mx is finite
    const float sc_lo = mx_lo * c, sc_hi = mx_hi * c;
    const float alpha_lo = fast_exp2(m_lo * c - sc_lo);  // 0 on the first tile
    const float alpha_hi = fast_exp2(m_hi * c - sc_hi);
    m_lo = mx_lo;
    m_hi = mx_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      s[j][0] = fast_exp2(fmaf(s[j][0], c, -sc_lo));
      s[j][1] = fast_exp2(fmaf(s[j][1], c, -sc_lo));
      s[j][2] = fast_exp2(fmaf(s[j][2], c, -sc_hi));
      s[j][3] = fast_exp2(fmaf(s[j][3], c, -sc_hi));
      sum_lo += s[j][0] + s[j][1];
      sum_hi += s[j][2] + s[j][3];
    }
    l_lo = l_lo * alpha_lo + sum_lo;
    l_hi = l_hi * alpha_hi + sum_hi;
#pragma unroll
    for (int j = 0; j < kDVS / 8; ++j) {
      acc[j][0] *= alpha_lo;
      acc[j][1] *= alpha_lo;
      acc[j][2] *= alpha_hi;
      acc[j][3] *= alpha_hi;
    }

    // O += P.V: P (accumulator layout of S) repacked as bf16 A fragments
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < kDVS / 16; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vt + (kk * 16 + r8 + (mi & 1) * 8) * L::vStride + dp * 16 + (mi >> 1) * 8);
        mma_bf16(acc[2 * dp], pa, bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // this stage is read; the next iteration's load may overwrite it
  }

  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
  __nv_bfloat16* ob = o + b * N * dv;
#pragma unroll
  for (int j = 0; j < kDVS / 8; ++j) {
    const int col = col0 + j * 8 + 2 * t;
    if (col < dv) {
      if (r_lo < N)
        *reinterpret_cast<uint32_t*>(ob + size_t(r_lo) * dv + col) =
            pack_bf16(acc[j][0] * inv_lo, acc[j][1] * inv_lo);
      if (r_hi < N)
        *reinterpret_cast<uint32_t*>(ob + size_t(r_hi) * dv + col) =
            pack_bf16(acc[j][2] * inv_hi, acc[j][3] * inv_hi);
    }
  }
  if (slice == 0 && t == 0) {
    if (r_lo < N) lse[b * N + r_lo] = (m_lo * c + log2f(l_lo)) * kLn2;
    if (r_hi < N) lse[b * N + r_hi] = (m_hi * c + log2f(l_hi)) * kLn2;
  }
}

// ---------------------------------------------------------------------------
// fp32: the same tiling on the CUDA cores
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

template <int DKP>
cudaError_t launch_bf16(dim3 grid, cudaStream_t stream, const void* q, const void* k,
                        const void* v, void* o, float* lse, int N, int M, int dk, int dv,
                        int n_slices, float c) {
  const size_t smem = Bf16Smem<DKP>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<DKP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  flash_fwd_bf16_kernel<DKP><<<grid, kThreadsBf16, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, N, M, dk, dv,
      n_slices, c);
  return cudaGetLastError();
}

// ===========================================================================
// Kernel B3: the backward.
//
// Replaces the TPU kernel audiodepth_tpu/ops/pallas/flash_attention.py:148
// (_bwd_kernel, via _flash_bwd). With D = rowsum(do*o) computed by the
// caller (as the JAX package does outside its kernel):
//   p  = exp(q.k^T.scale - lse)       dv = p^T.do
//   ds = p*(do.v^T - D)               dk = ds^T.q.scale     dq = ds.k.scale
// dq, dk, dv accumulate in fp32 and are cast to the input dtype.
//
// Bound on the H100 SXM. At the level-2 shape (2B = 32, N = M = 16384,
// dk = 16, dv = 128) the five products (s, p^T.do, do.v^T, ds^T.q, ds.k) are
// 2*32*16384^2*(3*16 + 2*128) = 5.22e12 FLOP = 5.28 ms at 989 TFLOP/s, the
// exp2 of p 8.6e9 = 2.05 ms, the bytes ~0.5 GB = 0.15 ms: bound by tensor
// operations. Level 3 is 6.5e11 FLOP = 0.66 ms; level 5 is bound by bytes.
//
// Design (bf16, FA2-style, simple first). What the TPU kernel did for its
// layout is gone: no transposed dq/dk accumulators, no full-N dq buffer in
// fast memory, no 128-lane padding (dk is padded to 16 in shared memory
// only). A block of 4 warps owns a tile of 64 keys (16 a warp) and one
// 128-wide slice of dv, and sweeps every 64-row q tile. Each warp computes
// S^T = K.Q^T for its keys, so P^T and dS^T sit in the accumulator layout
// with keys as rows and repack in registers into the A operand of
// dv += P^T.dO and dk += dS^T.Q; dk and the dv slice accumulate in fp32
// registers across the sweep. p is recomputed as exp2(s*c - lse*log2e) on
// the fp32 scores (c = scale*log2e, B2's choice); p and ds are rounded to
// bf16 before their products, as the TPU kernel does. dP^T = V.dO^T needs
// the whole of dv, so only the block of slice 0 computes dP, dS, dk and dq
// (its V and dO tiles hold every column); the blocks of the other slices
// (dv 256 and 512, levels 3-5) recompute S and P and accumulate their dv
// slice only. dq crosses key tiles: dS^T goes to shared memory in bf16,
// each warp multiplies 16 q rows of dS by the tile's K, and the fp32 result
// is added to a [B, N, dk] fp32 buffer that the caller zeroed, with one
// atomicAdd per element (N*M*B*dk/64 adds: 2.1e9 at level 2). The atomics
// make dq's fp32 sums run-to-run nondeterministic in their last bits.
// q/dO tiles are double buffered with cp.async while they fit shared
// memory (dv <= 256); K (and V for slice 0) load once per block.
//
// fp32 runs on the CUDA cores in full fp32: a 256-thread block owns 32 keys
// and the whole of dv, sweeps 32-row q tiles, and passes P and dS through
// shared memory; dq takes the same atomics.
// ===========================================================================

constexpr int kBwdBK = 64;        // keys per block
constexpr int kBwdBQ = 64;        // q rows per sweep step
constexpr int kBwdThreads = 128;  // 4 warps x 16 keys
constexpr int kBwdMaxDv = 512;

// shared memory of the bf16 backward, in bf16 elements unless noted
struct BwdLayout {
  int k_stride, w_stride, ds_stride, stages;
  int v_off, q_off, do_off, ds_off, stat_off;  // elements from the start
  size_t bytes;
};

__host__ __device__ inline BwdLayout bwd_layout(int dkp, int w, int stages) {
  BwdLayout L;
  L.k_stride = dkp + 8;
  L.w_stride = w + 8;
  L.ds_stride = kBwdBQ + 8;
  L.stages = stages;
  L.v_off = kBwdBK * L.k_stride;
  L.q_off = L.v_off + kBwdBK * L.w_stride;
  L.do_off = L.q_off + stages * kBwdBQ * L.k_stride;
  L.ds_off = L.do_off + stages * kBwdBQ * L.w_stride;
  L.stat_off = L.ds_off + kBwdBK * L.ds_stride;
  L.bytes = size_t(L.stat_off) * 2 + size_t(2 * stages * kBwdBQ) * sizeof(float);
  return L;
}

// grid (key_tiles * n_slices, B); block 128. DKP = dk rounded up to 16;
// W = the dO/V tile width of slice 0: max(dv rounded up to 16, kDVS).
template <int DKP>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ dsum,
                      float* __restrict__ dq, __nv_bfloat16* __restrict__ dk_out,
                      __nv_bfloat16* __restrict__ dv_out, int N, int M, int dk, int dv,
                      int n_slices, int W, int stages, float c, float scale) {
  constexpr int KSTEPS = DKP / 16;
  const BwdLayout L = bwd_layout(DKP, W, stages);
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* vs = ks + L.v_off;
  __nv_bfloat16* qs = ks + L.q_off;
  __nv_bfloat16* dos = ks + L.do_off;
  __nv_bfloat16* dsT = ks + L.ds_off;
  float* lse2s = reinterpret_cast<float*>(ks + L.stat_off);  // stages x kBwdBQ
  float* dsums = lse2s + stages * kBwdBQ;                      // stages x kBwdBQ

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, r8 = lane & 7;  // ldmatrix lane addressing
  const int slice = blockIdx.x % n_slices;
  const int k0 = (blockIdx.x / n_slices) * kBwdBK;
  const int col0 = slice * kDVS;
  const bool lead = slice == 0;  // computes dP, dS, dk and dq
  const int w_load = lead ? W : kDVS;  // dO columns [col0, col0 + w_load) in smem
  const size_t b = blockIdx.y;
  const __nv_bfloat16* qb = q + b * N * dk;
  const __nv_bfloat16* kb = k + b * M * dk;
  const __nv_bfloat16* vb = v + b * M * dv;
  const __nv_bfloat16* dob = dout + b * N * dv;
  const float* lseb = lse + b * N;
  const float* dsumb = dsum + b * N;

  // the block's K tile, and V (every column) for slice 0; zero past M and dk
  constexpr int kChunks = DKP / 8;
  for (int i = tid; i < kBwdBK * kChunks; i += kBwdThreads) {
    const int r = i / kChunks, ch = i - r * kChunks;
    const bool ok = k0 + r < M && ch * 8 < dk;
    cp_async16(ks + r * L.k_stride + ch * 8, ok ? kb + size_t(k0 + r) * dk + ch * 8 : kb, ok);
  }
  if (lead) {
    const int vChunks = W / 8;
    for (int i = tid; i < kBwdBK * vChunks; i += kBwdThreads) {
      const int r = i / vChunks, ch = i - r * vChunks;
      const bool ok = k0 + r < M && ch * 8 < dv;
      cp_async16(vs + r * L.w_stride + ch * 8, ok ? vb + size_t(k0 + r) * dv + ch * 8 : vb, ok);
    }
  }
  cp_async_commit();

  // one q tile: Q, the dO columns this block reads, lse*log2e and D; rows
  // past N are zero, which gives them p = 1 but dP = dS = 0 and no dv
  auto load_q_tile = [&](int qt0, int st) {
    __nv_bfloat16* qt = qs + st * kBwdBQ * L.k_stride;
    for (int i = tid; i < kBwdBQ * kChunks; i += kBwdThreads) {
      const int r = i / kChunks, ch = i - r * kChunks;
      const bool ok = qt0 + r < N && ch * 8 < dk;
      cp_async16(qt + r * L.k_stride + ch * 8, ok ? qb + size_t(qt0 + r) * dk + ch * 8 : qb, ok);
    }
    __nv_bfloat16* dt = dos + st * kBwdBQ * L.w_stride;
    const int dChunks = w_load / 8;
    for (int i = tid; i < kBwdBQ * dChunks; i += kBwdThreads) {
      const int r = i / dChunks, ch = i - r * dChunks;
      const int col = col0 + ch * 8;
      const bool ok = qt0 + r < N && col < dv;
      cp_async16(dt + r * L.w_stride + ch * 8, ok ? dob + size_t(qt0 + r) * dv + col : dob, ok);
    }
    if (tid < kBwdBQ) {
      lse2s[st * kBwdBQ + tid] = qt0 + tid < N ? lseb[qt0 + tid] * kLog2e : 0.f;
    } else {
      const int j = tid - kBwdBQ;
      dsums[st * kBwdBQ + j] = qt0 + j < N ? dsumb[qt0 + j] : 0.f;
    }
  };

  load_q_tile(0, 0);
  cp_async_commit();
  cp_async_wait<1>();  // the K/V group has landed
  __syncthreads();

  const int krow = warp * 16;  // this warp's keys within the tile
  uint32_t ka[KSTEPS][4];      // A operand of S^T = K.Q^T
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s)
    ldmatrix_x4(ka[s], ks + (krow + r8 + (mi & 1) * 8) * L.k_stride + s * 16 + (mi >> 1) * 8);
  const bool key_lo_ok = k0 + krow + g < M, key_hi_ok = k0 + krow + g + 8 < M;

  float dv_acc[kDVS / 8][4];
#pragma unroll
  for (int j = 0; j < kDVS / 8; ++j) dv_acc[j][0] = dv_acc[j][1] = dv_acc[j][2] = dv_acc[j][3] = 0.f;
  float dk_acc[DKP / 8][4];
#pragma unroll
  for (int j = 0; j < DKP / 8; ++j) dk_acc[j][0] = dk_acc[j][1] = dk_acc[j][2] = dk_acc[j][3] = 0.f;

  const int n_qt = (N + kBwdBQ - 1) / kBwdBQ;
  for (int it = 0; it < n_qt; ++it) {
    const int qt0 = it * kBwdBQ;
    const int st = stages == 2 ? (it & 1) : 0;
    if (stages == 2 && it + 1 < n_qt) {
      load_q_tile(qt0 + kBwdBQ, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* qt = qs + st * kBwdBQ * L.k_stride;
    const __nv_bfloat16* dt = dos + st * kBwdBQ * L.w_stride;
    const float* l2 = lse2s + st * kBwdBQ;
    const float* dd = dsums + st * kBwdBQ;

    // S^T = K.Q^T: 16 keys x 64 q rows per warp
    float p[kBwdBQ / 8][4];
#pragma unroll
    for (int j = 0; j < kBwdBQ / 8; ++j) p[j][0] = p[j][1] = p[j][2] = p[j][3] = 0.f;
#pragma unroll
    for (int ss = 0; ss < KSTEPS; ++ss) {
#pragma unroll
      for (int np = 0; np < kBwdBQ / 16; ++np) {
        uint32_t bq[4];
        ldmatrix_x4(bq, qt + (np * 16 + r8 + (mi >> 1) * 8) * L.k_stride + ss * 16 + (mi & 1) * 8);
        mma_bf16(p[2 * np], ka[ss], bq[0], bq[1]);
        mma_bf16(p[2 * np + 1], ka[ss], bq[2], bq[3]);
      }
    }
    // P^T = exp2(S^T*c - lse*log2e); keys past M get none
#pragma unroll
    for (int j = 0; j < kBwdBQ / 8; ++j) {
      const int col = j * 8 + 2 * t;
      const float l0 = l2[col], l1 = l2[col + 1];
      p[j][0] = key_lo_ok ? fast_exp2(fmaf(p[j][0], c, -l0)) : 0.f;
      p[j][1] = key_lo_ok ? fast_exp2(fmaf(p[j][1], c, -l1)) : 0.f;
      p[j][2] = key_hi_ok ? fast_exp2(fmaf(p[j][2], c, -l0)) : 0.f;
      p[j][3] = key_hi_ok ? fast_exp2(fmaf(p[j][3], c, -l1)) : 0.f;
    }

    // dv slice += P^T.dO: the slice's columns are the tile's first kDVS
#pragma unroll
    for (int kk = 0; kk < kBwdBQ / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
      pa[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
      pa[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
      pa[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < kDVS / 16; ++dp) {
        uint32_t bd[4];
        ldmatrix_x4_trans(bd, dt + (kk * 16 + r8 + (mi & 1) * 8) * L.w_stride + dp * 16 + (mi >> 1) * 8);
        mma_bf16(dv_acc[2 * dp], pa, bd[0], bd[1]);
        mma_bf16(dv_acc[2 * dp + 1], pa, bd[2], bd[3]);
      }
    }

    if (lead) {
      // dP^T = V.dO^T over every column of dv (zero-padded to W)
      float ds[kBwdBQ / 8][4];
#pragma unroll
      for (int j = 0; j < kBwdBQ / 8; ++j) ds[j][0] = ds[j][1] = ds[j][2] = ds[j][3] = 0.f;
      for (int kk = 0; kk < W / 16; ++kk) {
        uint32_t va[4];
        ldmatrix_x4(va, vs + (krow + r8 + (mi & 1) * 8) * L.w_stride + kk * 16 + (mi >> 1) * 8);
#pragma unroll
        for (int np = 0; np < kBwdBQ / 16; ++np) {
          uint32_t bd[4];
          ldmatrix_x4(bd, dt + (np * 16 + r8 + (mi >> 1) * 8) * L.w_stride + kk * 16 + (mi & 1) * 8);
          mma_bf16(ds[2 * np], va, bd[0], bd[1]);
          mma_bf16(ds[2 * np + 1], va, bd[2], bd[3]);
        }
      }
      // dS^T = P^T (dP^T - D)
#pragma unroll
      for (int j = 0; j < kBwdBQ / 8; ++j) {
        const int col = j * 8 + 2 * t;
        const float d0 = dd[col], d1 = dd[col + 1];
        ds[j][0] = p[j][0] * (ds[j][0] - d0);
        ds[j][1] = p[j][1] * (ds[j][1] - d1);
        ds[j][2] = p[j][2] * (ds[j][2] - d0);
        ds[j][3] = p[j][3] * (ds[j][3] - d1);
      }
      // dk += dS^T.Q; dS^T to shared memory (bf16) for dq
#pragma unroll
      for (int kk = 0; kk < kBwdBQ / 16; ++kk) {
        uint32_t da[4];
        da[0] = pack_bf16(ds[2 * kk][0], ds[2 * kk][1]);
        da[1] = pack_bf16(ds[2 * kk][2], ds[2 * kk][3]);
        da[2] = pack_bf16(ds[2 * kk + 1][0], ds[2 * kk + 1][1]);
        da[3] = pack_bf16(ds[2 * kk + 1][2], ds[2 * kk + 1][3]);
        __nv_bfloat16* row_lo = dsT + (krow + g) * L.ds_stride + kk * 16 + 2 * t;
        __nv_bfloat16* row_hi = row_lo + 8 * L.ds_stride;
        *reinterpret_cast<uint32_t*>(row_lo) = da[0];
        *reinterpret_cast<uint32_t*>(row_hi) = da[1];
        *reinterpret_cast<uint32_t*>(row_lo + 8) = da[2];
        *reinterpret_cast<uint32_t*>(row_hi + 8) = da[3];
#pragma unroll
        for (int np = 0; np < DKP / 16; ++np) {
          uint32_t bq[4];
          ldmatrix_x4_trans(bq, qt + (kk * 16 + r8 + (mi & 1) * 8) * L.k_stride + np * 16 + (mi >> 1) * 8);
          mma_bf16(dk_acc[2 * np], da, bq[0], bq[1]);
          mma_bf16(dk_acc[2 * np + 1], da, bq[2], bq[3]);
        }
      }
      __syncthreads();  // dS^T of all four warps is in shared memory

      // dq rows qt0 + 16*warp .. + 16: dS.K over the tile's 64 keys
      float dqa[DKP / 8][4];
#pragma unroll
      for (int j = 0; j < DKP / 8; ++j) dqa[j][0] = dqa[j][1] = dqa[j][2] = dqa[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kBwdBK / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, dsT + (kk * 16 + r8 + (mi >> 1) * 8) * L.ds_stride + warp * 16 + (mi & 1) * 8);
#pragma unroll
        for (int np = 0; np < DKP / 16; ++np) {
          uint32_t bk[4];
          ldmatrix_x4_trans(bk, ks + (kk * 16 + r8 + (mi & 1) * 8) * L.k_stride + np * 16 + (mi >> 1) * 8);
          mma_bf16(dqa[2 * np], a, bk[0], bk[1]);
          mma_bf16(dqa[2 * np + 1], a, bk[2], bk[3]);
        }
      }
      const int r_lo = qt0 + warp * 16 + g, r_hi = r_lo + 8;
      float* dqb = dq + b * N * dk;
#pragma unroll
      for (int j = 0; j < DKP / 8; ++j) {
        const int col = j * 8 + 2 * t;
        if (col < dk) {
          if (r_lo < N) {
            atomicAdd(dqb + size_t(r_lo) * dk + col, dqa[j][0] * scale);
            atomicAdd(dqb + size_t(r_lo) * dk + col + 1, dqa[j][1] * scale);
          }
          if (r_hi < N) {
            atomicAdd(dqb + size_t(r_hi) * dk + col, dqa[j][2] * scale);
            atomicAdd(dqb + size_t(r_hi) * dk + col + 1, dqa[j][3] * scale);
          }
        }
      }
    }
    __syncthreads();  // this stage (and dS^T) is consumed
    if (stages == 1 && it + 1 < n_qt) {
      load_q_tile(qt0 + kBwdBQ, 0);
      cp_async_commit();
    }
  }

  const int key_lo = k0 + krow + g, key_hi = key_lo + 8;
  if (lead) {
    __nv_bfloat16* dkb = dk_out + b * M * dk;
#pragma unroll
    for (int j = 0; j < DKP / 8; ++j) {
      const int col = j * 8 + 2 * t;
      if (col < dk) {
        if (key_lo < M)
          *reinterpret_cast<uint32_t*>(dkb + size_t(key_lo) * dk + col) =
              pack_bf16(dk_acc[j][0] * scale, dk_acc[j][1] * scale);
        if (key_hi < M)
          *reinterpret_cast<uint32_t*>(dkb + size_t(key_hi) * dk + col) =
              pack_bf16(dk_acc[j][2] * scale, dk_acc[j][3] * scale);
      }
    }
  }
  __nv_bfloat16* dvb = dv_out + b * M * dv;
#pragma unroll
  for (int j = 0; j < kDVS / 8; ++j) {
    const int col = col0 + j * 8 + 2 * t;
    if (col < dv) {
      if (key_lo < M)
        *reinterpret_cast<uint32_t*>(dvb + size_t(key_lo) * dv + col) =
            pack_bf16(dv_acc[j][0], dv_acc[j][1]);
      if (key_hi < M)
        *reinterpret_cast<uint32_t*>(dvb + size_t(key_hi) * dv + col) =
            pack_bf16(dv_acc[j][2], dv_acc[j][3]);
    }
  }
}

template <int DKP>
cudaError_t launch_bwd_bf16(dim3 grid, size_t smem, cudaStream_t stream, const void* q,
                            const void* k, const void* v, const void* dout, const float* lse,
                            const float* dsum, float* dq, void* dk_out, void* dv_out, int N,
                            int M, int dk, int dv, int n_slices, int W, int stages, float c,
                            float scale) {
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_bf16_kernel<DKP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  flash_bwd_bf16_kernel<DKP><<<grid, kBwdThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse, dsum,
      dq, static_cast<__nv_bfloat16*>(dk_out), static_cast<__nv_bfloat16*>(dv_out), N, M, dk, dv,
      n_slices, W, stages, c, scale);
  return cudaGetLastError();
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

// Launches on `stream` of `device`; returns cudaGetLastError() (0 on
// success). The caller checks shapes: dk % 8 == 0, dk <= 64, dv % 8 == 0,
// 16-byte aligned contiguous tensors, B <= 65535.
int adepth_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                               int B, int N, int M, int dk, int dv, float scale, int is_bf16,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dk <= 0 || dk > kMaxDk || dk % 8 || dv % 8) return static_cast<int>(cudaErrorInvalidValue);
  const int n_slices = (dv + kDVS - 1) / kDVS;
  const dim3 grid(((N + kBQ - 1) / kBQ) * n_slices, B);
  const float c = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (!is_bf16) {
    err = cudaFuncSetAttribute(flash_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(F32Smem::bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_fwd_f32_kernel<<<grid, kThreadsF32, F32Smem::bytes, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), l, N, M, dk, dv, n_slices, c);
    return static_cast<int>(cudaGetLastError());
  }
  switch ((dk + 15) / 16) {
    case 1: err = launch_bf16<16>(grid, st, q, k, v, o, l, N, M, dk, dv, n_slices, c); break;
    case 2: err = launch_bf16<32>(grid, st, q, k, v, o, l, N, M, dk, dv, n_slices, c); break;
    case 3: err = launch_bf16<48>(grid, st, q, k, v, o, l, N, M, dk, dv, n_slices, c); break;
    default: err = launch_bf16<64>(grid, st, q, k, v, o, l, N, M, dk, dv, n_slices, c); break;
  }
  return static_cast<int>(err);
}

// Kernel B3. dq is a zeroed fp32 [B, N, dk] buffer the kernel adds into;
// dk and dv are written in the input dtype; lse and dsum are fp32 [B, N].
// The caller checks shapes: dk % 8 == 0, dk <= 64, dv % 8 == 0,
// dv <= 512, 16-byte aligned contiguous tensors, B <= 65535.
int adepth_flash_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* dsum, void* dq, void* dk_out,
                               void* dv_out, int B, int N, int M, int dk, int dv, float scale,
                               int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dk <= 0 || dk > kMaxDk || dk % 8 || dv <= 0 || dv % 8 || dv > kBwdMaxDv)
    return static_cast<int>(cudaErrorInvalidValue);
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float c = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* ds = static_cast<const float*>(dsum);
  float* dqf = static_cast<float*>(dq);
  if (!is_bf16) {
    const size_t smem = bwd_f32_bytes(dv);
    if (smem > size_t(max_smem)) return static_cast<int>(cudaErrorInvalidValue);
    err = cudaFuncSetAttribute(flash_bwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((M + kBwdF32BK - 1) / kBwdF32BK, B);
    flash_bwd_f32_kernel<<<grid, kThreadsF32, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), l, ds, dqf, static_cast<float*>(dk_out),
        static_cast<float*>(dv_out), N, M, dk, dv, c, scale);
    return static_cast<int>(cudaGetLastError());
  }
  const int dkp = (dk + 15) / 16 * 16;
  const int W = (dv + 15) / 16 * 16 > kDVS ? (dv + 15) / 16 * 16 : kDVS;
  int stages = 2;
  if (bwd_layout(dkp, W, 2).bytes > size_t(max_smem)) stages = 1;
  const size_t smem = bwd_layout(dkp, W, stages).bytes;
  if (smem > size_t(max_smem)) return static_cast<int>(cudaErrorInvalidValue);
  const int n_slices = (dv + kDVS - 1) / kDVS;
  const dim3 grid(((M + kBwdBK - 1) / kBwdBK) * n_slices, B);
  switch (dkp / 16) {
    case 1: err = launch_bwd_bf16<16>(grid, smem, st, q, k, v, dout, l, ds, dqf, dk_out, dv_out, N, M, dk, dv, n_slices, W, stages, c, scale); break;
    case 2: err = launch_bwd_bf16<32>(grid, smem, st, q, k, v, dout, l, ds, dqf, dk_out, dv_out, N, M, dk, dv, n_slices, W, stages, c, scale); break;
    case 3: err = launch_bwd_bf16<48>(grid, smem, st, q, k, v, dout, l, ds, dqf, dk_out, dv_out, N, M, dk, dv, n_slices, W, stages, c, scale); break;
    default: err = launch_bwd_bf16<64>(grid, smem, st, q, k, v, dout, l, ds, dqf, dk_out, dv_out, N, M, dk, dv, n_slices, W, stages, c, scale); break;
  }
  return static_cast<int>(err);
}

const char* adepth_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
