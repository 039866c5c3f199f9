"""Write `sm90_wgmma.cuh`: inline-PTX wrappers of Hopper's
`wgmma.mma_async.m64nNk16.f32.bf16.bf16` for the widths the flash
attention kernels use.

    python3 audiodepth_tpu_torch/csrc/gen_sm90_wgmma.py

PTX lists every accumulator register of a wgmma by name, N/2 of them for
m64nN, so each width is written out here rather than by hand.
"""

from __future__ import annotations

from pathlib import Path

# m64nN widths in use: A and B from shared memory for S (64) and dQ / dK
# (dk padded: 16, 32, 64); A from registers for dK and P.V / dV (dv tiles)
SS_WIDTHS = (16, 32, 64)
RS_WIDTHS = (16, 32, 64, 128, 192, 256)
OUT = Path(__file__).resolve().parent / "sm90_wgmma.cuh"

HEAD = """\
// Generated by gen_sm90_wgmma.py in this directory; do not edit by hand.
//
// wgmma.mma_async m64nNk16, bf16 inputs, fp32 accumulators d[N/2] in the
// warpgroup's accumulator layout (warp w holds rows 16w + lane/4 and
// 16w + lane/4 + 8; d[4j..4j+3] are columns 8j + 2(lane%4) + {0, 1} of
// those two rows). scale_d = 0 overwrites d, 1 adds to it.
//   wgmma_ss<N, TA, TB>: A and B from shared memory (descriptors); TA / TB
//     = 1 reads the operand MN-major (transposed), 0 K-major.
//   wgmma_rs<N, TB>: A from registers, four bf16x2 per thread in the
//     mma.sync m16n8k16 A-fragment layout of the thread's warp rows.
// Issue between wgmma_fence() and wgmma_commit() (sm90.cuh).
#pragma once
#include <stdint.h>

namespace sm90 {
"""


def regs(n: int, first: int = 0) -> str:
    return ", ".join(f"%{first + i}" for i in range(n))


def outs(n: int) -> str:
    return ", ".join(f'"+f"(d[{i}])' for i in range(n))


def ss(width: int) -> str:
    n = width // 2
    return f"""
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n{width}(float* d, uint64_t da, uint64_t db, int scale_d) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{n + 2}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{width}k16.f32.bf16.bf16 "
      "{{{regs(n)}}}, %{n}, %{n + 1}, p, 1, 1, %{n + 3}, %{n + 4};\\n}}\\n"
      : {outs(n)}
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}}
"""


def rs(width: int) -> str:
    n = width // 2
    return f"""
template <int TB>
__device__ __forceinline__ void wgmma_rs_n{width}(float* d, const uint32_t* a, uint64_t db, int scale_d) {{
  asm volatile(
      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{n + 5}, 0;\\n"
      "wgmma.mma_async.sync.aligned.m64n{width}k16.f32.bf16.bf16 "
      "{{{regs(n)}}}, {{{regs(4, n)}}}, %{n + 4}, p, 1, 1, %{n + 6};\\n}}\\n"
      : {outs(n)}
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}}
"""


def dispatch() -> str:
    ss_cases = "\n".join(
        f"  {'if' if i == 0 else 'else if'} constexpr (N == {w}) wgmma_ss_n{w}<TA, TB>(d, da, db, scale_d);"
        for i, w in enumerate(SS_WIDTHS))
    rs_cases = "\n".join(
        f"  {'if' if i == 0 else 'else if'} constexpr (N == {w}) wgmma_rs_n{w}<TB>(d, a, db, scale_d);"
        for i, w in enumerate(RS_WIDTHS))
    ss_widths = " || ".join(f"N == {w}" for w in SS_WIDTHS)
    rs_widths = " || ".join(f"N == {w}" for w in RS_WIDTHS)
    return f"""
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db, int scale_d) {{
  static_assert({ss_widths}, "no wgmma wrapper of this width");
{ss_cases}
}}

template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db, int scale_d) {{
  static_assert({rs_widths}, "no wgmma wrapper of this width");
{rs_cases}
}}

}}  // namespace sm90
"""


def main() -> None:
    body = HEAD + "".join(map(ss, SS_WIDTHS)) + "".join(map(rs, RS_WIDTHS)) + dispatch()
    OUT.write_text(body)


if __name__ == "__main__":
    main()
