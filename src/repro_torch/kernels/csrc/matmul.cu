// matmul: out (M, N) = a (M, K) @ b (K, N), fp32 accumulation, cast to out's dtype.
//
// Replaces src/repro/kernels/matmul.py::_matmul_kernel (matmul_pallas).
//
// Bound on the H100: operations.  2*M*N*K FLOPs on the FP32 pipes, 67
// TFLOP/s, while the three matrices move once at 3.35 TB/s, far less time for
// any n this repo probes.  This kernel is the dissect fit's fp32 probe, so it
// stays on the FP32 pipes (no TF32, no tensor-core emulation): what keeps it
// from that peak is feeding the FMAs, that is global-load latency and
// shared-memory reads.
//
// Design: the TPU kernel walks K as the innermost, sequential grid axis with
// the accumulator in VMEM scratch.  Here each block of 256 threads owns one
// 128x256 output tile and loops over K in steps of 16 through a ring of 4
// stages in dynamic shared memory (99 KB), with one __syncthreads() per stage:
//   - B's rows go to the ring as they are, by 16-byte cp.async.cg copies
//     (coalesced, zero-filled past the edges through the copy's source size),
//     committed one group per stage: stage k+3 is in flight while stage k's
//     FMAs run;
//   - A's rows are read with 16-byte loads into registers for stage k+3 before
//     stage k's FMAs and written transposed, A^T (k, m), after them, so the
//     FMAs read both operands along the output tile;
//   - each thread keeps an 8x16 accumulator (4-wide strips 64 apart: two of
//     rows, four of columns) in ~200 registers, one block per SM, and per k
//     reads its 8 values of A^T and 16 of B as six 16-byte shared loads, the
//     next k's while this k's 128 FMAs run; a warp's reads are two broadcast
//     chunks of A^T and 16 consecutive chunks of B: no bank conflicts.  The
//     wider tile takes 3 shared loads per 64 FMAs where 128x128 takes 4, and
//     was the faster of the two on the card;
//   - any M, N, K runs: edge tiles are zero-filled and every column of the
//     store is masked against N.  A matrix whose rows are not 16-byte
//     aligned takes the instance of this kernel that stages the same ring
//     with one-element loads;
//   - bf16/fp16 inputs are staged as they are and widened to fp32 as they
//     are read from shared memory, so they also run on the FP32 pipes with
//     fp32 accumulation (the tensor-core path for them waits for the
//     gemm_lp slice).
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int BM = 128, BN = 256, BK = 16, kThreads = 256, kStages = 4;
constexpr int NJ = BN / 64;  // 4-wide column strips per thread, 64 apart

template <typename TI>
struct Tiles {
  static constexpr int kVec = 16 / sizeof(TI);  // elements per 16-byte chunk
  static constexpr int AS = BM + kVec;          // row stride of A^T (k, m): one chunk of padding
  static constexpr int kAElems = BK * AS, kBElems = BK * BN;
  static constexpr int kStageElems = kAElems + kBElems;
  static constexpr int kBytes = kStages * kStageElems * sizeof(TI);
  // chunks of A (kVec consecutive k of one row) each thread stages per stage
  static constexpr int kAPerThread = BM * BK / kVec / kThreads;
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four consecutive elements from shared memory, widened to fp32.
__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* f) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}
__device__ __forceinline__ void load4(const __half* p, float* f) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&v.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&v.y));
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}

// kVec consecutive elements of one row of A, in registers.
template <typename TI>
struct __align__(16) Chunk {
  TI v[Tiles<TI>::kVec];
};

// This thread's chunks of A for the stage at k0, zeros past M and K.
template <typename TI, bool kVecLoads>
__device__ __forceinline__ void load_a(Chunk<TI> (&c)[Tiles<TI>::kAPerThread], const TI* A, int M,
                                       int K, int m0, int k0) {
  constexpr int kVec = Tiles<TI>::kVec, kPerRow = BK / kVec;
#pragma unroll
  for (int l = 0; l < Tiles<TI>::kAPerThread; ++l) {
    const int i = threadIdx.x + l * kThreads;
    const int gm = m0 + i / kPerRow, gk = k0 + (i % kPerRow) * kVec;
    const TI* src = A + static_cast<long long>(gm) * K + gk;
    if (kVecLoads && gm < M && gk + kVec <= K) {
      c[l] = *reinterpret_cast<const Chunk<TI>*>(src);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        c[l].v[e] = (gm < M && gk + e < K) ? src[e] : from_f32<TI>(0.f);
    }
  }
}

// The chunks of load_a, transposed into a stage's A^T.
template <typename TI>
__device__ __forceinline__ void store_a(TI* At, const Chunk<TI> (&c)[Tiles<TI>::kAPerThread]) {
  constexpr int kVec = Tiles<TI>::kVec, kPerRow = BK / kVec;
#pragma unroll
  for (int l = 0; l < Tiles<TI>::kAPerThread; ++l) {
    const int i = threadIdx.x + l * kThreads;
    const int r = i / kPerRow, k = (i % kPerRow) * kVec;
#pragma unroll
    for (int e = 0; e < kVec; ++e) At[(k + e) * Tiles<TI>::AS + r] = c[l].v[e];
  }
}

// B rows [k0, k0 + BK) x [n0, n0 + BN) into a stage, zeros past K and N.
template <typename TI, bool kAsync>
__device__ __forceinline__ void stage_b(TI* Bs, const TI* B, int N, int K, int n0, int k0) {
  constexpr int kVec = Tiles<TI>::kVec, kPerRow = BN / kVec;
#pragma unroll
  for (int l = 0; l < BK * kPerRow / kThreads; ++l) {
    const int i = threadIdx.x + l * kThreads;
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    const int gk = k0 + r, gn = n0 + c;
    const int valid = gk < K ? max(0, min(kVec, N - gn)) : 0;
    const TI* src = valid > 0 ? B + static_cast<long long>(gk) * N + gn : B;
    TI* dst = Bs + r * BN + c;
    if constexpr (kAsync) {
      cp_async16(static_cast<uint32_t>(__cvta_generic_to_shared(dst)), src,
                 valid * static_cast<int>(sizeof(TI)));
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) dst[e] = e < valid ? src[e] : from_f32<TI>(0.f);
    }
  }
}

// kAligned: the rows of A and B are 16-byte aligned (cp.async and vector
// loads); else the same ring is staged with one-element loads.
template <typename TI, typename TO, bool kAligned>
__global__ void __launch_bounds__(kThreads, 1)
matmul_kernel(const TI* __restrict__ A, const TI* __restrict__ B, TO* __restrict__ C, int M,
              int N, int K) {
  using T = Tiles<TI>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TI* smem = reinterpret_cast<TI*>(smem_raw);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int n_k = (K + BK - 1) / BK;

  float acc[8][4 * NJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NJ; ++j) acc[i][j] = 0.f;

  Chunk<TI> a_next[T::kAPerThread];
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) {
      TI* st = smem + s * T::kStageElems;
      load_a<TI, kAligned>(a_next, A, M, K, m0, s * BK);
      store_a<TI>(st, a_next);
      stage_b<TI, kAligned>(st + T::kAElems, B, N, K, n0, s * BK);
    }
    cp_async_commit();
  }

  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<kStages - 2>();  // this thread's copies of stage kt have landed
    __syncthreads();               // everyone's have, and stage kt-1 is free again
    const int next = kt + kStages - 1;
    TI* st_next = smem + (next % kStages) * T::kStageElems;
    if (next < n_k) {
      load_a<TI, kAligned>(a_next, A, M, K, m0, next * BK);
      stage_b<TI, kAligned>(st_next + T::kAElems, B, N, K, n0, next * BK);
    }
    cp_async_commit();

    const TI* At = smem + (kt % kStages) * T::kStageElems;
    const TI* Bs = At + T::kAElems;
    float a[2][8], b[2][4 * NJ];
    auto operands = [&](int k, float* ak, float* bk) {
      load4(At + k * T::AS + ty * 4, ak);
      load4(At + k * T::AS + 64 + ty * 4, ak + 4);
#pragma unroll
      for (int h = 0; h < NJ; ++h) load4(Bs + k * BN + 64 * h + tx * 4, bk + 4 * h);
    };
    operands(0, a[0], b[0]);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const int cur = k % 2;
      // the next k's operands, read while this k's FMAs run
      if (k + 1 < BK) operands(k + 1, a[cur ^ 1], b[cur ^ 1]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4 * NJ; ++j) acc[i][j] = fmaf(a[cur][i], b[cur][j], acc[i][j]);
    }
    // the slot of stage `next` held stage kt-1, which every thread finished
    // reading before this iteration's __syncthreads()
    if (next < n_k) store_a<TI>(st_next, a_next);
  }
  cp_async_wait<0>();

  const bool vec = N % 4 == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i < 4 ? 0 : 64) + ty * 4 + (i % 4);
    if (gm >= M) continue;
#pragma unroll
    for (int h = 0; h < NJ; ++h) {
      const int gn = n0 + h * 64 + tx * 4;
      TO* p = C + static_cast<long long>(gm) * N + gn;
      const float* f = acc[i] + 4 * h;
      if (vec && gn + 4 <= N) {
        if constexpr (sizeof(TO) == 4) {
          *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
        } else {
          __align__(8) TO v[4] = {from_f32<TO>(f[0]), from_f32<TO>(f[1]), from_f32<TO>(f[2]),
                                  from_f32<TO>(f[3])};
          *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(v);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gn + j < N) p[j] = from_f32<TO>(f[j]);
      }
    }
  }
}

template <typename TI, typename TO>
int launch(const void* a, const void* b, void* c, int M, int N, int K, cudaStream_t s) {
  constexpr int kVec = Tiles<TI>::kVec;
  constexpr int bytes = Tiles<TI>::kBytes;
  const bool aligned = K % kVec == 0 && N % kVec == 0 &&
                       reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(b) % 16 == 0;
  auto kernel = aligned ? matmul_kernel<TI, TO, true> : matmul_kernel<TI, TO, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, kThreads, bytes, s>>>(static_cast<const TI*>(a), static_cast<const TI*>(b),
                                       static_cast<TO*>(c), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <typename TI>
int launch_out(int out_dtype, const void* a, const void* b, void* c, int M, int N, int K,
               cudaStream_t s) {
  switch (out_dtype) {
    case kF32: return launch<TI, float>(a, b, c, M, N, K, s);
    case kBF16: return launch<TI, __nv_bfloat16>(a, b, c, M, N, K, s);
    case kF16: return launch<TI, __half>(a, b, c, M, N, K, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int repro_matmul(int in_dtype, int out_dtype, const void* a, const void* b, void* c,
                            int M, int N, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_dtype) {
    case kF32: return launch_out<float>(out_dtype, a, b, c, M, N, K, s);
    case kBF16: return launch_out<__nv_bfloat16>(out_dtype, a, b, c, M, N, K, s);
    case kF16: return launch_out<__half>(out_dtype, a, b, c, M, N, K, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
