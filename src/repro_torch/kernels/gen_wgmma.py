"""Write ``csrc/wgmma.cuh``: the Hopper ``wgmma`` instructions the
flash-attention, matmul and ssm_scan kernels issue, one inline-PTX wrapper per (width,
input type, operand source and layout).

    PYTHONPATH=src python -m repro_torch.kernels.gen_wgmma

An accumulator of an m64nN instruction is N/2 fp32 registers per thread,
each named in the instruction's operand list, so every width needs its own
asm block; this script writes them out instead of by hand.
"""
from __future__ import annotations

from pathlib import Path

OUT = Path(__file__).resolve().parent / "csrc" / "wgmma.cuh"
SS_WIDTHS = (64, 128)            # S = Q K^T: n is the key tile
RS_WIDTHS = (64, 112, 128, 256)  # O += P V: n is the head width
TYPES = (("bf16", "__nv_bfloat16"), ("f16", "__half"))
SST_WIDTHS = (128,)              # matmul, 16-bit: B read N-major
STT_WIDTHS = (64, 128)           # ssm_scan's chunk states u^T B: A read M-major, B N-major
K32_WIDTHS = (128,)              # matmul, 8-bit: both operands K-major
# (ptx types, C type, accumulator C type, its asm constraint, the trailing
# immediates: integer wgmma takes no scale-a/b)
K32_TYPES = (("s32.s8.s8", "int8_t", "int", "r", ""),
             ("f32.e4m3.e4m3", "__nv_fp8_e4m3", "float", "f", ", 1, 1"))

HEADER = """\
// Written by src/repro_torch/kernels/gen_wgmma.py; edit that script, not this file.
//
// Hopper warpgroup MMAs (wgmma.mma_async, sm_90a) with fp32 accumulators:
//   WgmmaSS<N, T>::mma(d, desc_a, desc_b, scale_d): A and B from shared memory,
//     both K-major (no transpose);
//   WgmmaRS<N, T>::mma(d, a, desc_b, scale_d): A from registers (4 x b32 of
//     two 16-bit values each, the m64k16 fragment), B from shared memory
//     MN-major (transpose bit set);
//   WgmmaSSt<N, T>::mma(d, desc_a, desc_b, scale_d): A K-major and B MN-major
//     (transpose bit set), both from shared memory;
//   WgmmaSStt<N, T>::mma(d, desc_a, desc_b, scale_d): A and B both MN-major
//     (both transpose bits set), both from shared memory;
//   WgmmaK32<N, T>::mma(d, desc_a, desc_b, scale_d): the 8-bit types, k 32,
//     both operands K-major (the ISA has no transpose for them); int8 into
//     s32 (d is int), fp8 e4m3 into f32.
// d is the m64nN accumulator, N/2 values per thread; scale_d 0 overwrites it,
// 1 accumulates.  The caller fences, commits and waits (wgmma_fence(),
// wgmma_commit(), wgmma_wait<0>()).
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of an accumulator register
// across an asynchronous wgmma that owns it.
__device__ __forceinline__ void reg_fence(float& r) { asm volatile("" : "+f"(r)::"memory"); }

template <int N, typename T> struct WgmmaSS;
template <int N, typename T> struct WgmmaRS;
template <int N, typename T> struct WgmmaSSt;
template <int N, typename T> struct WgmmaSStt;
template <int N, typename T> struct WgmmaK32;
"""


def regs(n: int, first: int = 0) -> str:
    return ", ".join(f"%{first + i}" for i in range(n))


def outs(n: int, constraint: str = "f") -> str:
    return ", ".join(f'"+{constraint}"(d[{i}])' for i in range(n))


def ss(n: int, ptx: str, ctype: str, name: str = "WgmmaSS", trans_b: int = 0,
       trans_a: int = 0) -> str:
    r = n // 2
    return f"""
template <> struct {name}<{n}, {ctype}> {{
  static __device__ __forceinline__ void mma(float (&d)[{r}], uint64_t da, uint64_t db, int scale_d) {{
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 2}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.{ptx}.{ptx} "
        "{{{regs(r)}}}, %{r}, %{r + 1}, p, 1, 1, {trans_a}, {trans_b};\\n}}\\n"
        : {outs(r)}
        : "l"(da), "l"(db), "r"(scale_d));
  }}
}};
"""


def k32(n: int, ptx: str, ctype: str, acc: str, constraint: str, imm: str) -> str:
    r = n // 2
    return f"""
template <> struct WgmmaK32<{n}, {ctype}> {{
  using Acc = {acc};
  static __device__ __forceinline__ void mma({acc} (&d)[{r}], uint64_t da, uint64_t db, int scale_d) {{
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 2}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k32.{ptx} "
        "{{{regs(r)}}}, %{r}, %{r + 1}, p{imm};\\n}}\\n"
        : {outs(r, constraint)}
        : "l"(da), "l"(db), "r"(scale_d));
  }}
}};
"""


def rs(n: int, ptx: str, ctype: str) -> str:
    r = n // 2
    return f"""
template <> struct WgmmaRS<{n}, {ctype}> {{
  static __device__ __forceinline__ void mma(float (&d)[{r}], const uint32_t (&a)[4], uint64_t db,
                                             int scale_d) {{
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 5}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.{ptx}.{ptx} "
        "{{{regs(r)}}}, {{{regs(4, r)}}}, %{r + 4}, p, 1, 1, 1;\\n}}\\n"
        : {outs(r)}
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }}
}};
"""


def render() -> str:
    """The header's text."""
    parts = [HEADER]
    for ptx, ctype in TYPES:
        parts += [ss(n, ptx, ctype) for n in SS_WIDTHS]
        parts += [rs(n, ptx, ctype) for n in RS_WIDTHS]
        parts += [ss(n, ptx, ctype, "WgmmaSSt", 1) for n in SST_WIDTHS]
        parts += [ss(n, ptx, ctype, "WgmmaSStt", 1, 1) for n in STT_WIDTHS]
    for ptx, ctype, acc, constraint, imm in K32_TYPES:
        parts += [k32(n, ptx, ctype, acc, constraint, imm) for n in K32_WIDTHS]
    return "".join(parts)


def main() -> None:
    OUT.write_text(render())
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
