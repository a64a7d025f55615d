// op_latency: dependent-issue latency of one ALU op (the paper's Tab 4.1).
//
// Stands in for the reference's jitted chain, src/repro/core/probes.py::
// probe_op_latency, which runs `chain` dependent applications of each op of
// _OP_TABLE in one device loop (jax.lax.fori_loop) and subtracts a move-only
// chain; that probe has no pallas_call.  Bound by latency, not by bytes or
// operations: each step waits on the one before, so one block of `width`
// threads (one lane each) times the op's latency, chain times over, plus a
// launch; the move-only instance times the launch and the loop, and the
// probe subtracts it.
//
// The ops are the rows of _OP_TABLE with the same constants.  nvcc folds
// chains of x * 1, (x << 1) >> 1, x + 1 or max(x, c) into closed forms, and a
// folded chain measures nothing, so the constants arrive as kernel
// arguments and the arithmetic rows are inline PTX in `asm volatile`, which
// the compiler may neither merge nor drop.  The transcendental rows are
// rsqrtf, expf, tanhf and logf as compiled without --use_fast_math: expf and
// logf the accurate library routines around ex2/lg2, tanhf the library
// routine, rsqrtf the rsqrt.approx instruction; `fabsf(x) + c` and `x * c`
// around them as in the table.  `cuobjdump -sass` of the built library (on an
// H100, CUDA 12.8) shows the arithmetic instances' loops unrolled four times
// with one FADD / FMUL / FFMA / FMNMX a step, an IMAD (mul.s32) or a VIADD
// (add.s32) a step, and an SHF pair for the shift.  The move-only instance
// keeps no loop at all: ptxas propagates the copies whatever `volatile`
// tells the front end, so it times the launch, the load and the store,
// which is what the probe subtracts.
#include <utility>

#include "common.cuh"

namespace {

enum Op {
  kMove = 0, kAddF32, kMulF32, kFmaF32, kMaxF32, kRsqrtF32, kExpF32, kTanhF32, kLogF32,
  kAddS32, kMulS32, kShiftS32, kNumOps
};

template <int OP>
__device__ __forceinline__ uint32_t step(uint32_t r, float c0, float c1, int i0) {
  const float x = __uint_as_float(r);
  float f;
  uint32_t y;
  if constexpr (OP == kMove) {
    asm volatile("mov.b32 %0, %1;" : "=r"(y) : "r"(r));
    return y;
  } else if constexpr (OP == kAddS32) {
    asm volatile("add.s32 %0, %1, %2;" : "=r"(y) : "r"(r), "r"(i0));
    return y;
  } else if constexpr (OP == kMulS32) {
    asm volatile("mul.lo.s32 %0, %1, %2;" : "=r"(y) : "r"(r), "r"(i0));
    return y;
  } else if constexpr (OP == kShiftS32) {  // (x << i0) >> i0, arithmetic
    asm volatile("{\n.reg .b32 t;\nshl.b32 t, %1, %2;\nshr.s32 %0, t, %2;\n}"
                 : "=r"(y) : "r"(r), "r"(i0));
    return y;
  } else if constexpr (OP == kAddF32) {
    asm volatile("add.rn.f32 %0, %1, %2;" : "=f"(f) : "f"(x), "f"(c0));
  } else if constexpr (OP == kMulF32) {
    asm volatile("mul.rn.f32 %0, %1, %2;" : "=f"(f) : "f"(x), "f"(c0));
  } else if constexpr (OP == kFmaF32) {
    asm volatile("fma.rn.f32 %0, %1, %2, %3;" : "=f"(f) : "f"(x), "f"(c0), "f"(c1));
  } else if constexpr (OP == kMaxF32) {
    asm volatile("max.f32 %0, %1, %2;" : "=f"(f) : "f"(x), "f"(c0));
  } else if constexpr (OP == kRsqrtF32) {
    f = rsqrtf(fabsf(x) + c0);
  } else if constexpr (OP == kExpF32) {
    f = expf(x * c0);
  } else if constexpr (OP == kTanhF32) {
    f = tanhf(x * c0);
  } else {  // kLogF32
    f = logf(fabsf(x) + c0);
  }
  return __float_as_uint(f);
}

// Each lane runs `chain` dependent steps from x0[lane] in a register and
// writes the result; the 32-bit values are fp32 or s32 bits by op.
template <int OP>
__global__ void chain_kernel(const uint32_t* __restrict__ x0, uint32_t* __restrict__ out,
                             int width, int chain, float c0, float c1, int i0) {
  const int lane = threadIdx.x;
  if (lane >= width) return;
  uint32_t r = x0[lane];
#pragma unroll 4
  for (int s = 0; s < chain; ++s) r = step<OP>(r, c0, c1, i0);
  out[lane] = r;
}

template <int OP>
int launch(const void* x0, void* out, int width, int chain, float c0, float c1, int i0,
           cudaStream_t s) {
  chain_kernel<OP><<<1, width, 0, s>>>(static_cast<const uint32_t*>(x0),
                                       static_cast<uint32_t*>(out), width, chain, c0, c1, i0);
  return static_cast<int>(cudaGetLastError());
}

template <int... OPS>
int dispatch(int op, const void* x0, void* out, int width, int chain, float c0, float c1, int i0,
             cudaStream_t s, std::integer_sequence<int, OPS...>) {
  int rc = static_cast<int>(cudaErrorInvalidValue);
  ((op == OPS ? (rc = launch<OPS>(x0, out, width, chain, c0, c1, i0, s), 0) : 0), ...);
  return rc;
}

}  // namespace

// One chain of op `op` (the Op enum; kernels/op_latency.py::OPS in order) on
// `width` <= 1024 lanes of one block.
extern "C" int repro_op_latency(int op, const void* x0, void* out, int width, int chain,
                                float c0, float c1, int i0, void* stream) {
  if (op < 0 || op >= kNumOps || width < 1 || width > 1024 || chain < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(op, x0, out, width, chain, c0, c1, i0, static_cast<cudaStream_t>(stream),
                  std::make_integer_sequence<int, kNumOps>{});
}
