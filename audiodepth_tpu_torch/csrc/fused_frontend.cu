// Fused mel front end for Hopper (sm_90a), kernel B1: waveform -> log-mel,
// min-max normalised per channel, in one kernel.
//
// Replaces the TPU kernel audiodepth_tpu/ops/pallas/fused_frontend.py
// (_frontend_kernel, via fused_mel_frontend). Same function, per channel
// (one row of the [B*C, L] waveform):
//   frames [T, win] . windowed real-DFT basis [win, 2F]   (cos | -sin)
//   magnitude sqrt(re^2 + im^2)                           [T, F]
//   . HTK mel bank [F, M]                                  [T, M]
//   log(x + 1e-8), min-max over the whole channel (0 where max == min)
//   stored as [M, T].
// The TPU wrapper reflect-padded the waveform and gathered the frames in
// XLA; here both are folded into the kernel: frame t, tap m reads sample
// t*hop + start + m (start = -win/2 = -32 at BatVision's settings).
//
// What bounds it on the H100 SXM. The function needs the DFT only for the
// bins the mel bank reads (1-232 of 257 at BatVision's settings) and the
// bank only at its non-zeros (439 of 8,224). At B*C = 32, L = 7782 (T =
// 244) the DFT below is six bf16 passes of 2*T*64*464 flops a channel, 2.78
// GFLOP at 989 TFLOP/s = 2.8 us (the time of three TF32 passes at 495),
// plus the bank's 6.9 MFLOP at 67 TFLOP/s = 0.1 us, against 2.2 MB of device
// traffic = 0.65 us: bound by operations, 2.9 us. The first port of this
// kernel (dense fp32 FMA on the CUDA cores, 71.6 us) was held back by fixed
// costs instead: 256 blocks in 2-3 waves, 165 KB of constants copied from
// L2 by every block before any math, and a dense mel product. This design
// is held back in turn by mma.sync's rate (about half of wgmma's) on 96
// SMs at B*C = 32 (the card runs 15 clusters of 8, not 16), by the launch
// of clusters of 227 KB blocks, and by latency with 8 warps an SM: PERF.md
// and tools/frontend_ablation.py take it apart.
//
// Design.
// * One wave. A channel is `blocks_per_channel` blocks of one cluster, each
//   computing `frames_per_block` frames (a multiple of 16) in tiles of up to
//   32; a cluster holds `cluster_size / blocks_per_channel` channels. The
//   wrapper's plan (ops/cuda/fused_frontend.py, frontend_plan) picks them
//   from cudaOccupancyMaxActiveClusters so that the main path's shapes run
//   in one wave. The cluster size is a launch attribute; above 8 it is the
//   non-portable size.
// * Constants once per cluster, off the critical path. The wrapper packs
//   one buffer: the windowed basis for the bins the bank reads only, each
//   bin's cos and -sin columns interleaved, as three bf16 pieces of the
//   float64 basis stored in mma.m16n8k16 B-fragment order (a lane's 16-byte
//   load is one k-step's pieces 1-2, or two k-steps' piece 3; a warp's is
//   512 contiguous bytes), then each filter's first bin, length and weights
//   offset, then the weights: 180,448 bytes at BatVision's settings. Each
//   block of a cluster issues one bulk copy of 1/cluster_size of it with
//   .multicast::cluster, so every byte leaves L2 once per cluster and lands
//   in every block, completing on each block's mbarrier. The waveform
//   segment and the A fragments load while the copy is in flight.
// * DFT on the tensor cores with mma.sync.m16n8k16 in bf16, each operand
//   split into three bf16 pieces (x = x1 + x2 + x3 exactly for fp32 x: 8 +
//   8 + 8 significant bits) and six products a step, all but those below
//   2^-26 of the product, smallest first, each 16-tap step summed in a fresh
//   accumulator and then added in fp32. A wgmma descriptor cannot express
//   the overlapping frames, hence mma.sync. A fragments come straight from
//   the waveform segment in shared memory (frame t, tap m is seg[t*hop +
//   m]; frames are never materialised) and stay in registers for the tile;
//   each of the 8 warps takes both m-tiles of a 32-frame tile and every 8th
//   n-tile of 4 bins, so each B fragment loaded feeds two m-tiles and a
//   step has 8 independent product chains (a 16-frame tile: one m-tile,
//   two n-tiles at a time). With cos and -sin interleaved, a thread's
//   accumulator pairs hold re and im of one bin, so the magnitude needs no
//   shuffle. The next tile's segment is loaded into registers during the
//   DFT and stored once the DFT has read its own.
// * Mel product over each filter's non-zero bins only, in bin order, fp32
//   FMA from the magnitudes in shared memory (the skipped terms are exactly
//   +0 in the dense product); log, and a running min / max.
// * Min-max on chip: the channel's min / max across its blocks through
//   distributed shared memory, and a second cluster.sync before any block
//   exits. Output [B, C, M, T] fp32, stored row by row.
// * Long inputs (two passes). A block holds at most 128 frames of log-mel
//   beside the constants, and a cluster at most 16 blocks, so a channel of
//   more than 2,048 frames cannot keep its min-max inside one cluster. For
//   such plans (FrontendPlan.two_pass) a channel's blocks are consecutive
//   in the grid and clusters only share the constants: each block writes
//   its raw log-mel to the output and its (min, max) to a small buffer
//   [B*C, blocks_per_channel, 2], and a second kernel of the same call
//   (frontend_normalize_kernel, one block a channel) reduces a channel's
//   pairs and normalises its output in place, with the same formula. The
//   other option, blocks looping over frame tiles of a channel, would need
//   the whole channel's log-mel on chip (128 bytes a frame): 47 KB are left
//   beside the constants. The second pass reads and writes the output once
//   more, which the one-pass form of the main path's shapes never pays.
//
// Traps.
// * Alignment. A waveform row of 7782 floats is 31,128 bytes, so every
//   second channel starts 8 bytes off a 16-byte boundary, and the cut
//   train-path rows (a view into rows of 8,038) the same; neither a bulk
//   copy (16-byte address and size) nor a TMA tensor map (strides a
//   multiple of 16 bytes) takes them. TMA carries only the wrapper's own
//   aligned constants; the waveform is read with coalesced 4-byte loads,
//   through the row strides the wrapper passes (the last axis contiguous).
// * Reflection. Frames 0 and T-1 reach 32 samples past each end and reflect
//   without repeating the edge sample (reflect_index). The spare rows of a
//   last partial tile read further; they are clamped into the row and never
//   stored.
// * Silent channel: max == min gives zeros.
// * Numerics. Sidelobe bins of a clean signal sit near the 1e-8 floor, so
//   after the log and the range division any two fp32 summation orders
//   differ there by up to ~1e-4. 3xTF32 (two tf32 pieces, three products,
//   products good to ~2^-22, the tensor core's sums truncated) was tried
//   first and failed on the card both the 1e-5 gate against the fp32 plain
//   version on the train path's echoes and the float64 gate on clean
//   chirps; the three-piece bf16 products are exact to 2^-26 and land below
//   the plain version's own float64 error (tests/test_torch_frontend_plan.py
//   emulates them).
// * Shared memory: 180 KB of constants, 5 KB of segment, 30 KB of
//   magnitudes and 128 bytes a frame of log-mel: one block an SM, within
//   the 227 KB a block may take, up to 128 frames a block. 256 threads, so
//   that a thread may hold the two m-tiles' A pieces (96 registers) without
//   spilling: at 512 threads (128 registers) the first draft spilled.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSegRegs = 8;          // segment samples a thread prefetches into registers
constexpr int kTile = 32;            // frames per tile: two m-tiles of 16
constexpr int kMelFrames = 4;        // frames a thread sums in the mel product
constexpr int kMelGroups = kTile / kMelFrames;  // frames f, f + 8, f + 16, f + 24 of a tile
constexpr int kTaps = 64;            // K of the DFT product: window taps, zero-padded
constexpr int kKSteps = kTaps / 16;  // m16n8k16 steps along K
// basis words of one n-tile (8 columns): per k-step and lane, one uint4 of
// pieces 1 and 2 (b0, b1 each), then per pair of k-steps and lane, one
// uint4 of piece 3 (b0, b1 of both steps)
constexpr int kNTileVec4 = kKSteps * 32 + kKSteps / 2 * 32;
constexpr int kMaxCluster = 16;

__host__ __device__ inline int align4(int n) { return (n + 3) & ~3; }

// The segment keeps 4 floats of padding after every 32 samples, so that
// the A-fragment loads of 8 frames 32 samples apart spread over the banks.
__host__ __device__ inline int seg_index(int i) { return i + 4 * (i >> 5); }

// Byte offsets into dynamic shared memory: the constants (as packed by the
// wrapper), the tile's waveform segment, its magnitudes (rows of
// 4*n_ntiles + 1 bins: an odd stride, so 32 frames at one bin hit 32
// banks), and the block's log-mel [n_mels, frames_per_block].
struct SmemLayout {
  int tile, mag_stride;
  size_t seg, mag, logmel, total;
  __host__ __device__ SmemLayout(int frames_per_block, int hop, int const_bytes, int n_ntiles,
                                 int n_mels) {
    tile = frames_per_block < kTile ? frames_per_block : kTile;
    mag_stride = 4 * n_ntiles + 1;
    const int seg_len = (tile - 1) * hop + kTaps;
    seg = size_t(const_bytes);
    mag = seg + 4 * size_t(align4(seg_index(seg_len - 1) + 1));
    logmel = mag + 4 * size_t(align4(tile * mag_stride));
    total = logmel + 4 * size_t(n_mels) * frames_per_block;
  }
};

struct Params {
  const float* wave;  // channel i at wave + (i / n_c) * stride_b + (i % n_c) * stride_c
  long long stride_b, stride_c;
  int n_c;
  const float* consts;  // packed constants, const_bytes long
  int const_bytes, table_off, weight_off;  // offsets in 4-byte words
  int n_ntiles, n_mels;
  float* out;  // [bc, n_mels, T]
  int bc, L, T, hop, start;
  int frames_per_block, blocks_per_channel;
  float* block_minmax;  // two-pass plans: [bc, blocks_per_channel, 2]; else null
};

__device__ __forceinline__ int reflect_index(int s, int L) {
  if (s < 0) s = -s;
  if (s >= L) s = 2 * (L - 1) - s;
  return min(max(s, 0), L - 1);
}

__device__ __forceinline__ void warp_minmax(float& lo, float& hi) {
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
}

// The magnitude's square root: sqrt.approx.f32 (one MUFU op, relative
// error within 2^-22) in place of the IEEE sqrtf, whose rarely taken slow
// path kept ptxas from overlapping the DFT's steps (tools/frontend_ablation.py,
// variant ieee_sqrt); the plain version's sqrt differs by that much, far
// below the 1e-5 gate after the log and the range division.
__device__ __forceinline__ float sqrt_approx(float x) {
  float y;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// two floats rounded to nearest bf16, packed: x0 in the low half
__device__ __forceinline__ uint32_t bf16x2(float x0, float x1) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x = p1 + p2 + p3 exactly, for both x0 (low halves) and x1 (high halves):
// each piece holds the next 8 significant bits, and each subtraction is exact
__device__ __forceinline__ void split3_bf16(float x0, float x1, uint32_t& p1, uint32_t& p2,
                                            uint32_t& p3) {
  p1 = bf16x2(x0, x1);
  x0 -= __uint_as_float(p1 << 16);
  x1 -= __uint_as_float(p1 & 0xffff0000u);
  p2 = bf16x2(x0, x1);
  x0 -= __uint_as_float(p2 << 16);
  x1 -= __uint_as_float(p2 & 0xffff0000u);
  p3 = bf16x2(x0, x1);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The six products of one 16-tap k-step, (a1 + a2 + a3) . (b1 + b2 + b3)
// but a2.b3, a3.b2 and a3.b3 (each below 2^-26 of the product), smallest
// first: a3.b1, a1.b3, a2.b2, a2.b1, a1.b2, a1.b1; the A and the B piece of
// product i.
__host__ __device__ constexpr int prod_a(int i) { return i == 0 ? 2 : i == 2 || i == 3 ? 1 : 0; }
__host__ __device__ constexpr int prod_b(int i) { return i == 1 ? 2 : i == 2 || i == 4 ? 1 : 0; }

// The A pieces of m-tile mt for every k-step: a[s][piece][q] is a0..a3 of
// k-step s (rows g, g+8, g, g+8; tap pairs 2t, 2t, 2t+8, 2t+8, the second
// tap in the high half), read from the segment (frame r, tap m at r*hop + m).
__device__ __forceinline__ void load_a(uint32_t (&a)[kKSteps][3][4], const float* s_seg, int mt,
                                       int hop, int g, int tig) {
#pragma unroll
  for (int s = 0; s < kKSteps; ++s)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = (mt * 16 + g + (q & 1) * 8) * hop + s * 16 + 2 * tig + (q >> 1) * 8;
      split3_bf16(s_seg[seg_index(i)], s_seg[seg_index(i + 1)], a[s][0][q], a[s][1][q],
                  a[s][2][q]);
    }
}

// DFT magnitudes of one tile: every warp takes all MT m-tiles of the tile
// and walks groups of NT n-tiles (warp w: w*NT, w*NT + kWarps*NT, ...), so
// that each B fragment loaded feeds MT m-tiles. The first tile waits for
// the constants after its A fragments are in registers; every block has
// frames (the entry point checks the plan), so no block exits with a copy
// still landing in its shared memory.
template <int MT, int NT>
__device__ __forceinline__ void dft_tile(const uint4* basis, const float* s_seg, float* s_mag,
                                         int ms, int ntf, int n_ntiles, int hop, uint64_t* bar,
                                         bool wait) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  uint32_t a[MT][kKSteps][3][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) load_a(a[m], s_seg, m, hop, g, tig);
  if (wait) sm90::mbar_wait(bar, 0);
  for (int nt0 = warp * NT; nt0 < n_ntiles; nt0 += kWarps * NT) {
    // b[n][s][piece]: b0, b1 of each piece; a group's n-tile past the end
    // repeats the last one, unstored
    uint32_t b[NT][kKSteps][3][2];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const uint4* u = basis + min(nt0 + n, n_ntiles - 1) * kNTileVec4 + lane;
#pragma unroll
      for (int s = 0; s < kKSteps; ++s) {
        const uint4 b12 = u[s * 32];
        b[n][s][0][0] = b12.x;
        b[n][s][0][1] = b12.y;
        b[n][s][1][0] = b12.z;
        b[n][s][1][1] = b12.w;
        if (s % 2 == 0) {
          const uint4 b3 = u[(kKSteps + s / 2) * 32];
          b[n][s][2][0] = b3.x;
          b[n][s][2][1] = b3.y;
          b[n][s + 1][2][0] = b3.z;
          b[n][s + 1][2][1] = b3.w;
        }
      }
    }
    // Each (m-tile, n-tile, k-step) sums its six products in a fresh
    // accumulator (the tensor core truncates its sums, so they are kept to
    // one k-step), issued product by product across all of them so that
    // consecutive HMMAs are independent; then the k-steps add up in fp32.
    float d[MT][NT][kKSteps][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int s = 0; s < kKSteps; ++s)
#pragma unroll
          for (int i = 0; i < 4; ++i) d[m][n][s][i] = 0.f;
#pragma unroll
    for (int pr = 0; pr < 6; ++pr)
#pragma unroll
      for (int s = 0; s < kKSteps; ++s)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int m = 0; m < MT; ++m)
            mma_bf16(d[m][n][s], a[m][s][prod_a(pr)], b[n][s][prod_b(pr)][0],
                     b[n][s][prod_b(pr)][1]);
    float acc[MT][NT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[m][n][i] = d[m][n][0][i];
#pragma unroll
          for (int s = 1; s < kKSteps; ++s) acc[m][n][i] += d[m][n][s][i];
        }
    // c0, c1: re, im of bin 4*nt + tig at frame 16m + g; c2, c3: at frame 16m + g + 8
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (nt0 + n >= n_ntiles) break;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int f0 = m * 16 + g;
        float* mg = s_mag + f0 * ms + 4 * (nt0 + n) + tig;
        const float* c = acc[m][n];
        if (f0 < ntf) mg[0] = sqrt_approx(c[0] * c[0] + c[1] * c[1]);
        if (f0 + 8 < ntf) mg[8 * ms] = sqrt_approx(c[2] * c[2] + c[3] * c[3]);
      }
    }
  }
}

// Segment samples [tid + r*kThreads] of a tile starting at sample s0,
// reflected into the row: loads into registers, issued early, stored later.
struct SegPrefetch {
  float v[kSegRegs];
  __device__ __forceinline__ void load(const float* x, bool live, int s0, int seg_len, int L) {
#pragma unroll
    for (int r = 0; r < kSegRegs; ++r) {
      const int i = int(threadIdx.x) + r * kThreads;
      v[r] = live && i < seg_len ? __ldg(x + reflect_index(s0 + i, L)) : 0.f;
    }
  }
  // the samples past kSegRegs * kThreads (a hop above 64) load here directly
  __device__ __forceinline__ void store(float* s_seg, const float* x, bool live, int s0,
                                        int seg_len, int L) const {
#pragma unroll
    for (int r = 0; r < kSegRegs; ++r) {
      const int i = int(threadIdx.x) + r * kThreads;
      if (i < seg_len) s_seg[seg_index(i)] = v[r];
    }
    for (int i = int(threadIdx.x) + kSegRegs * kThreads; i < seg_len; i += kThreads)
      s_seg[seg_index(i)] = live ? __ldg(x + reflect_index(s0 + i, L)) : 0.f;
  }
};

// grid (n_clusters * cluster_size); cluster (cluster_size, 1, 1) as a
// launch attribute; block r of a cluster computes frames
// [(r % nb) * F, ...) of the cluster's channel r / nb. Two-pass plans:
// block i computes frames [(i % nb) * F, ...) of channel i / nb.
__global__ void __launch_bounds__(kThreads, 1) fused_mel_frontend_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const SmemLayout lay(p.frames_per_block, p.hop, p.const_bytes, p.n_ntiles, p.n_mels);
  const float* s_const = reinterpret_cast<const float*>(smem);
  float* s_seg = reinterpret_cast<float*>(smem + lay.seg);
  float* s_mag = reinterpret_cast<float*>(smem + lay.mag);
  float* s_logmel = reinterpret_cast<float*>(smem + lay.logmel);
  __shared__ uint64_t s_bar;
  __shared__ float s_warp[2][kWarps];
  __shared__ float s_block[2];    // this block's min / max, read by its channel's blocks
  __shared__ float s_channel[2];  // the channel's min / max

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cs = int(cluster.num_blocks()), rank = int(cluster.block_rank());
  const int nb = p.blocks_per_channel, F = p.frames_per_block;
  const bool two_pass = p.block_minmax != nullptr;
  const int ch = two_pass ? int(blockIdx.x) / nb : int(blockIdx.x) / cs * (cs / nb) + rank / nb;
  const int part = two_pass ? int(blockIdx.x) % nb : rank % nb;
  const bool live = ch < p.bc;  // the last cluster may hold fewer channels
  const int f_begin = min(p.T, part * F), f_end = min(p.T, f_begin + F);
  const float* x = p.wave + (live ? (ch / p.n_c) * p.stride_b + (ch % p.n_c) * p.stride_c : 0);

  // Constants: every block's barrier is initialised before any copy can
  // reach it, then each block multicasts its slice to the whole cluster.
  if (tid == 0) {
    sm90::mbar_init(&s_bar, 1);
    sm90::fence_mbar_init();
  }
  cluster.sync();
  if (tid == 0) {
    sm90::mbar_arrive_expect_tx(&s_bar, uint32_t(p.const_bytes));
    const int chunks = p.const_bytes / 16, per = (chunks + cs - 1) / cs;
    const int c0 = min(chunks, rank * per), c1 = min(chunks, c0 + per);
    if (c1 > c0)
      sm90::bulk_load_multicast(smem + 16 * c0, reinterpret_cast<const char*>(p.consts) + 16 * c0,
                                uint32_t(16 * (c1 - c0)), &s_bar, uint16_t((1u << cs) - 1));
  }

  const int* table = reinterpret_cast<const int*>(s_const + p.table_off);
  const float* weights = s_const + p.weight_off;
  const uint4* basis = reinterpret_cast<const uint4*>(smem);
  const int tile = lay.tile, ms = lay.mag_stride;
  const int seg_len = (tile - 1) * p.hop + kTaps;
  float lo = INFINITY, hi = -INFINITY;
  // The segment of tile k+1 is loaded into registers while tile k's DFT
  // runs, and stored once the DFT has read its own segment.
  SegPrefetch next;
  if (f_begin < f_end) {
    next.load(x, live, f_begin * p.hop + p.start, seg_len, p.L);
    next.store(s_seg, x, live, f_begin * p.hop + p.start, seg_len, p.L);
  }
  for (int t0 = f_begin; t0 < f_end; t0 += tile) {
    const int ntf = min(tile, f_end - t0), t1 = t0 + tile;
    __syncthreads();  // this tile's segment is stored; the last tile's magnitudes are consumed
    if (t1 < f_end) next.load(x, live, t1 * p.hop + p.start, seg_len, p.L);
    if (ntf > 16)
      dft_tile<2, 1>(basis, s_seg, s_mag, ms, ntf, p.n_ntiles, p.hop, &s_bar, t0 == f_begin);
    else
      dft_tile<1, 2>(basis, s_seg, s_mag, ms, ntf, p.n_ntiles, p.hop, &s_bar, t0 == f_begin);
    __syncthreads();  // the magnitudes are complete; the segment is read
    if (t1 < f_end) next.store(s_seg, x, live, t1 * p.hop + p.start, seg_len, p.L);

    // Mel product over each filter's non-zeros, log, running min / max: a
    // thread takes filter j and frames f, f + kMelGroups, ... (kMelFrames
    // independent sums sharing each weight it loads).
    for (int i = tid; i < p.n_mels * kMelGroups; i += kThreads) {
      const int j = i / kMelGroups, f = i - j * kMelGroups;
      const float* w = weights + table[4 * j + 2];
      const int len = table[4 * j + 1];
      const float* mg[kMelFrames];  // rows past the tile's frames repeat its last, unstored
      float acc[kMelFrames];
#pragma unroll
      for (int q = 0; q < kMelFrames; ++q) {
        mg[q] = s_mag + min(f + q * kMelGroups, ntf - 1) * ms + table[4 * j];
        acc[q] = 0.f;
      }
      for (int k = 0; k < len; ++k) {
        const float wk = w[k];
#pragma unroll
        for (int q = 0; q < kMelFrames; ++q) acc[q] = fmaf(mg[q][k], wk, acc[q]);
      }
#pragma unroll
      for (int q = 0; q < kMelFrames; ++q) {
        if (f + q * kMelGroups >= ntf) break;
        const float v = logf(acc[q] + 1e-8f);
        s_logmel[j * F + (t0 - f_begin) + f + q * kMelGroups] = v;
        lo = fminf(lo, v);
        hi = fmaxf(hi, v);
      }
    }
  }

  // This block's min / max, then the channel's across its blocks (DSMEM).
  warp_minmax(lo, hi);
  if (lane == 0) {
    s_warp[0][warp] = lo;
    s_warp[1][warp] = hi;
  }
  __syncthreads();
  if (warp == 0) {
    lo = lane < kWarps ? s_warp[0][lane] : INFINITY;
    hi = lane < kWarps ? s_warp[1][lane] : -INFINITY;
    warp_minmax(lo, hi);
    if (lane == 0) {
      s_block[0] = lo;
      s_block[1] = hi;
    }
  }
  const int nf = f_end - f_begin;
  if (two_pass) {  // raw log-mel and this block's (min, max); the second pass normalises
    __syncthreads();
    if (live) {
      if (tid == 0) {
        p.block_minmax[2 * (size_t(ch) * nb + part)] = s_block[0];
        p.block_minmax[2 * (size_t(ch) * nb + part) + 1] = s_block[1];
      }
      float* y = p.out + size_t(ch) * p.n_mels * p.T + f_begin;
      for (int i = tid; i < p.n_mels * nf; i += kThreads) {
        const int j = i / nf, f = i - j * nf;
        y[size_t(j) * p.T + f] = s_logmel[j * F + f];
      }
    }
    cluster.sync();  // no block exits while its cluster's copies may still land
    return;
  }
  cluster.sync();  // every block's s_block is written
  if (warp == 0) {
    lo = INFINITY;
    hi = -INFINITY;
    if (lane < nb) {
      const float* remote = cluster.map_shared_rank(s_block, rank / nb * nb + lane);
      lo = remote[0];
      hi = remote[1];
    }
    warp_minmax(lo, hi);
    if (lane == 0) {
      s_channel[0] = lo;
      s_channel[1] = hi;
    }
  }
  cluster.sync();  // remote reads are done before any block exits
  if (!live) return;
  lo = s_channel[0];
  hi = s_channel[1];
  // (x - lo) times the IEEE reciprocal of the range: within 1.5 ulp of the
  // plain version's division, without its slow path in every thread
  const float scale = hi > lo ? __frcp_rn(hi - lo) : 0.f;
  float* y = p.out + size_t(ch) * p.n_mels * p.T + f_begin;
  for (int i = tid; i < p.n_mels * nf; i += kThreads) {
    const int j = i / nf, f = i - j * nf;
    y[size_t(j) * p.T + f] = (s_logmel[j * F + f] - lo) * scale;
  }
}

// The second pass of a two-pass plan: grid (bc), block kThreads. The
// channel's min / max over its blocks' pairs, then (x - lo) * (1 / range)
// over its [n_mels, T] output in place, as the one-pass kernel writes it.
__global__ void __launch_bounds__(kThreads) frontend_normalize_kernel(
    float* __restrict__ out, const float* __restrict__ block_minmax, int nb, int n_mels, int T) {
  __shared__ float s_warp[2][kWarps];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t ch = blockIdx.x;
  float lo = INFINITY, hi = -INFINITY;
  for (int i = tid; i < nb; i += kThreads) {
    lo = fminf(lo, block_minmax[2 * (ch * nb + i)]);
    hi = fmaxf(hi, block_minmax[2 * (ch * nb + i) + 1]);
  }
  warp_minmax(lo, hi);
  if (lane == 0) {
    s_warp[0][warp] = lo;
    s_warp[1][warp] = hi;
  }
  __syncthreads();
  lo = s_warp[0][0];
  hi = s_warp[1][0];
  for (int w = 1; w < kWarps; ++w) {
    lo = fminf(lo, s_warp[0][w]);
    hi = fmaxf(hi, s_warp[1][w]);
  }
  const float scale = hi > lo ? __frcp_rn(hi - lo) : 0.f;
  float* y = out + ch * n_mels * T;
  for (int i = tid; i < n_mels * T; i += kThreads) y[i] = (y[i] - lo) * scale;
}

cudaError_t prepare(int smem_bytes, int cluster_size) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_mel_frontend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess && cluster_size > 8)
    err = cudaFuncSetAttribute(fused_mel_frontend_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

cudaLaunchConfig_t launch_config(int n_blocks, int smem_bytes, cudaStream_t stream,
                                 cudaLaunchAttribute* attr, int cluster_size) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster_size;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(n_blocks, 1, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = size_t(smem_bytes);
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
}

}  // namespace

extern "C" {

// How many clusters of `cluster_size` blocks, each with `smem_bytes` of
// dynamic shared memory, the card runs at once (*count); returns the CUDA
// error (0 on success), clearing it so that no later launch check sees it.
int adepth_fused_mel_max_active_clusters(int cluster_size, int smem_bytes, int device,
                                         int* count) {
  *count = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = prepare(smem_bytes, cluster_size);
  if (err == cudaSuccess) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t config = launch_config(cluster_size, smem_bytes, nullptr, &attr,
                                                    cluster_size);
    err = cudaOccupancyMaxActiveClusters(count, fused_mel_frontend_kernel, &config);
  }
  if (err != cudaSuccess) cudaGetLastError();
  return static_cast<int>(err);
}

// Launches on `stream` of `device` with the wrapper's plan; returns the CUDA
// error (0 on success). The plan and the constants are checked against the
// kernel's own layout; the wrapper checks the rest (dtypes, win <= 64, L >
// -start). A two-pass plan passes `block_minmax`, a float buffer of bc * nb
// pairs, and launches frontend_normalize_kernel after the first pass; a
// one-pass plan passes null.
int adepth_fused_mel_frontend(const void* wave, long long stride_b, long long stride_c, int n_c,
                              const void* consts, int const_bytes, int table_off, int weight_off,
                              int n_ntiles, int n_mels, void* out, int bc, int L, int T, int hop,
                              int start, int frames_per_block, int blocks_per_channel,
                              int cluster_size, int n_clusters, long long smem_bytes,
                              void* block_minmax, int device, void* stream) {
  const int nb = blocks_per_channel, fpb = frames_per_block;
  const bool two_pass = block_minmax != nullptr;
  const bool grid_ok = two_pass ? (long long)n_clusters * cluster_size >= (long long)bc * nb
                                : cluster_size % nb == 0 &&
                                      (long long)n_clusters * (cluster_size / nb) >= bc;
  const bool ok =
      fpb > 0 && fpb % 16 == 0 && nb > 0 && (long long)nb * fpb >= T && (nb - 1) * fpb < T &&
      cluster_size > 0 && cluster_size <= kMaxCluster && grid_ok && n_c > 0 && hop > 0 && L > 0 &&
      const_bytes > 0 && const_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(consts) % 16 == 0 &&
      n_ntiles > 0 && (long long)n_ntiles * kNTileVec4 * 4 <= table_off &&
      table_off + 4 * n_mels <= weight_off && 4LL * weight_off <= const_bytes &&
      smem_bytes == (long long)SmemLayout(fpb, hop, const_bytes, n_ntiles, n_mels).total;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = prepare(int(smem_bytes), cluster_size);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config =
      launch_config(n_clusters * cluster_size, int(smem_bytes),
                    static_cast<cudaStream_t>(stream), &attr, cluster_size);
  const Params p = {static_cast<const float*>(wave), stride_b, stride_c, n_c,
                    static_cast<const float*>(consts), const_bytes, table_off, weight_off,
                    n_ntiles, n_mels, static_cast<float*>(out), bc, L, T, hop, start, fpb, nb,
                    static_cast<float*>(block_minmax)};
  err = cudaLaunchKernelEx(&config, fused_mel_frontend_kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetLastError();
  if (err != cudaSuccess || !two_pass) return static_cast<int>(err);
  frontend_normalize_kernel<<<bc, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), static_cast<const float*>(block_minmax), nb, n_mels, T);
  return static_cast<int>(cudaGetLastError());
}

const char* adepth_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
