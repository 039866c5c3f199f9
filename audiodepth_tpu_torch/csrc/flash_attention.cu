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

const char* adepth_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
