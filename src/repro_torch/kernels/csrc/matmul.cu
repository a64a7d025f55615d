// matmul: out (M, N) = a (M, K) @ b (K, N), cast to out's dtype.
//
// Replaces src/repro/kernels/matmul.py::_matmul_kernel (matmul_pallas), which
// accumulates in fp32 and casts to out_dtype.  Two kernels, by input type:
//
// * float32 (`matmul_kernel`, the dissect fit's fp32 probe): bound by
//   operations, 2*M*N*K FLOPs on the FP32 pipes at 67 TFLOP/s, while the
//   three matrices move once at 3.35 TB/s, far less time for any n this repo
//   probes.  It stays on the FP32 pipes (no TF32, no tensor-core emulation),
//   because the fit reads its rate as the card's fp32 peak: what keeps it
//   from that peak is feeding the FMAs, that is global-load latency and
//   shared-memory reads.
// * bfloat16, float16, int8 and fp8 e4m3 (`tc_kernel`, the gemm_lp ladder):
//   the tensor cores by wgmma, bound by operations at 989 TFLOP/s (16-bit)
//   and 1,979 (8-bit) for n >= ~600, by bytes below.  See the second part.
//
// Every output type of the reference is taken: float32, bfloat16, float16,
// int32, int8 and fp8 e4m3.  The casts are XLA's (common.cuh::from_f32):
// integers truncate and saturate, fp8 rounds to nearest even and gives NaN
// past +-448's rounding range, not cvt's saturating 448.
//
// fp32 design: the TPU kernel walks K as the innermost, sequential grid axis
// with the accumulator in VMEM scratch.  Here each block of 256 threads owns
// one 128x256 output tile and loops over K in steps of 16 through a ring of 4
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
//     with one-element loads.
#include <cstdint>
#include <cstdio>
#include <type_traits>

#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

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

// Four consecutive fp32 values from shared memory.
__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
// Four consecutive outputs, cast, in one store of 4 x sizeof(TO) bytes.
template <typename TO>
__device__ __forceinline__ void store4(TO* p, const float* f) {
  __align__(16) TO v[4] = {from_f32<TO>(f[0]), from_f32<TO>(f[1]), from_f32<TO>(f[2]),
                           from_f32<TO>(f[3])};
  if constexpr (sizeof(TO) == 4) {
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(v);
  } else if constexpr (sizeof(TO) == 2) {
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(v);
  } else {
    *reinterpret_cast<uint32_t*>(p) = *reinterpret_cast<const uint32_t*>(v);
  }
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
        store4(p, f);
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

int launch_fp32(int out_dtype, const void* a, const void* b, void* c, int M, int N, int K,
                cudaStream_t s) {
  switch (out_dtype) {
    case kF32: return launch<float, float>(a, b, c, M, N, K, s);
    case kBF16: return launch<float, __nv_bfloat16>(a, b, c, M, N, K, s);
    case kF16: return launch<float, __half>(a, b, c, M, N, K, s);
    case kI32: return launch<float, int>(a, b, c, M, N, K, s);
    case kI8: return launch<float, int8_t>(a, b, c, M, N, K, s);
    case kF8E4M3: return launch<float, __nv_fp8_e4m3>(a, b, c, M, N, K, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// bf16 / fp16 / int8 / fp8 e4m3: the tensor cores (wgmma) fed by the TMA
// ---------------------------------------------------------------------------
// One block of two warpgroups (256 threads) owns a 128 x 128 output tile, 64
// rows a warpgroup, and walks K in tiles of 128 bytes a row (64 16-bit or
// 128 8-bit values) through a ring of 4 stages of A (128 x 128 B) and B
// (128 x 128 B), 128 KB in all:
//   - the block's first thread issues every TMA load (cp.async.bulk.tensor,
//     128-byte swizzle; a "full" mbarrier per stage counts the bytes in, an
//     "empty" one the 256 threads out) and refills a stage as soon as both
//     warpgroups have released it, so tiles t+1..t+3 load while tile t is
//     multiplied.  No producer warpgroup: beside two consumers it spilled in
//     the flash kernel;
//   - each warpgroup issues 4 wgmma m64n128 (k16 for 16-bit, k32 for 8-bit)
//     per tile, A from shared memory K-major.  16-bit B is read as it lies,
//     (K, N) row-major, MN-major with the transpose bit; the ISA has no
//     transpose for the 8-bit types, so both operands must be K-major and
//     the wrapper first writes B^T (N, K) with `transpose8_kernel`;
//   - accumulators: fp32 for bf16/fp16/fp8, s32 for int8.  int8 is exact in
//     s32; the reference accumulates it in fp32, which agrees only while
//     every |partial sum| < 2^24 (a kept deviation, ROADMAP.md).  fp8 is
//     promoted: each tile's 128 values of K go into a fresh fp32
//     accumulator, which is then added into the block's own in registers,
//     since the tensor cores keep only ~14 bits of an fp8 accumulation
//     (DeepSeek-V3, arXiv:2412.19437, Sec. 3.3.2);
//   - edges: the tensor maps carry the true M, N and K, so the TMA fills
//     every box past them with zeros, exact for every type here; the store
//     masks rows at M and columns at N.  Global row strides must be
//     multiples of 16 bytes: the wrapper zero-pads a row that is not.
namespace tc {

constexpr int BM = 128, BN = 128, kThreads = 256, kStages = 4;
constexpr int kRowBytes = 128;  // one tile row of K: the 128-byte swizzle span
constexpr int kTileBytes = BM * kRowBytes;  // A's, and B's (BN = BM)
constexpr int kStageBytes = 2 * kTileBytes;
constexpr int kBarOffset = kStages * kStageBytes;
constexpr int kSmemBytes = 1024 + kBarOffset + 16 * kStages;  // 1024: room to align the base

template <typename TI> struct Traits;
template <> struct Traits<__nv_bfloat16> {
  static constexpr bool kBKMajor = false;
  using Acc = float;
};
template <> struct Traits<__half> {
  static constexpr bool kBKMajor = false;
  using Acc = float;
};
template <> struct Traits<int8_t> {
  static constexpr bool kBKMajor = true;
  using Acc = int;
};
template <> struct Traits<__nv_fp8_e4m3> {
  static constexpr bool kBKMajor = true;
  using Acc = float;
};

using ::reg_fence;  // wgmma.cuh's, for fp32 accumulators
__device__ __forceinline__ void reg_fence(int& r) { asm volatile("" : "+r"(r)::"memory"); }

template <typename TI, typename Acc>
__device__ __forceinline__ void mma(Acc (&d)[BN / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (Traits<TI>::kBKMajor) {
    WgmmaK32<BN, TI>::mma(d, da, db, scale_d);
  } else {
    WgmmaSSt<BN, TI>::mma(d, da, db, scale_d);
  }
}

__device__ __forceinline__ float as_float(float v) { return v; }
__device__ __forceinline__ float as_float(int v) { return static_cast<float>(v); }

// Outputs i and i + 1 of `c`, cast to out_dtype.  An int accumulator goes to
// int32 as it is and to int8 saturated; every other cast is from fp32.
template <typename Acc>
__device__ __forceinline__ void store2(void* c, int out_dtype, long long i, Acc v0, Acc v1,
                                       bool both) {
  auto put = [&](auto* p, auto x0, auto x1) {
    p[i] = x0;
    if (both) p[i + 1] = x1;
  };
  switch (out_dtype) {
    case kF32:
      put(static_cast<float*>(c), as_float(v0), as_float(v1));
      break;
    case kBF16:
      put(static_cast<__nv_bfloat16*>(c), from_f32<__nv_bfloat16>(as_float(v0)),
          from_f32<__nv_bfloat16>(as_float(v1)));
      break;
    case kF16:
      put(static_cast<__half*>(c), from_f32<__half>(as_float(v0)),
          from_f32<__half>(as_float(v1)));
      break;
    case kF8E4M3:
      put(static_cast<__nv_fp8_e4m3*>(c), from_f32<__nv_fp8_e4m3>(as_float(v0)),
          from_f32<__nv_fp8_e4m3>(as_float(v1)));
      break;
    case kI32:
      if constexpr (std::is_integral<Acc>::value) {
        put(static_cast<int*>(c), v0, v1);
      } else {
        put(static_cast<int*>(c), from_f32<int>(v0), from_f32<int>(v1));
      }
      break;
    case kI8:
      if constexpr (std::is_integral<Acc>::value) {
        put(static_cast<int8_t*>(c), static_cast<int8_t>(max(-128, min(127, v0))),
            static_cast<int8_t>(max(-128, min(127, v1))));
      } else {
        put(static_cast<int8_t*>(c), from_f32<int8_t>(v0), from_f32<int8_t>(v1));
      }
      break;
  }
}

template <typename TI, bool kPromote>
__global__ void __launch_bounds__(kThreads, 1)
tc_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
          void* __restrict__ c, int out_dtype, int M, int N, int K, long long ldc) {
  using Acc = typename Traits<TI>::Acc;
  constexpr int kK = kRowBytes / sizeof(TI);  // K values a tile
  constexpr int kSteps = 4;                   // wgmma k-steps a tile, 32 bytes of K each
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t base = smem_u32(smem);
  auto s_a = [&](int s) { return base + s * kStageBytes; };
  auto s_b = [&](int s) { return base + s * kStageBytes + kTileBytes; };
  auto full = [&](int s) { return base + kBarOffset + 8 * s; };
  auto empty = [&](int s) { return base + kBarOffset + 8 * (kStages + s); };

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int n_k = (K + kK - 1) / kK;

  auto load = [&](int t) {  // K tile t into stage t % kStages, once it is empty
    const int s = t % kStages, k0 = t * kK;
    if (t >= kStages) mbar_wait(empty(s), ((t / kStages) - 1) & 1);
    mbar_expect_tx(full(s), kStageBytes);
    tma_load_2d(s_a(s), ta, k0, m0, full(s));
    if constexpr (Traits<TI>::kBKMajor) {
      tma_load_2d(s_b(s), tb, k0, n0, full(s));  // B^T (N, K): 128 rows of N
    } else {  // B (K, N): two boxes of 64 columns of N x kK rows of K
      tma_load_2d(s_b(s), tb, n0, k0, full(s));
      tma_load_2d(s_b(s) + kK * kRowBytes, tb, n0 + 64, k0, full(s));
    }
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int t = 0; t < min(kStages, n_k); ++t) load(t);
  }
  __syncwarp();  // the warp reconverges before its next warpgroup-wide instruction

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  Acc acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = Acc(0);
  float part[kPromote ? BN / 2 : 1];

  for (int t = 0; t < n_k; ++t) {
    const int s = t % kStages;
    mbar_wait(full(s), (t / kStages) & 1);
    const uint32_t a_wg = s_a(s) + 64 * wg * kRowBytes;
    if constexpr (kPromote) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) reg_fence(part[i]);
    } else {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) reg_fence(acc[i]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const uint64_t da = sw128_desc(a_wg + kk * 32, 16);
      const uint64_t db = Traits<TI>::kBKMajor
                              ? sw128_desc(s_b(s) + kk * 32, 16)
                              : sw128_desc(s_b(s) + kk * 16 * kRowBytes, kK * kRowBytes);
      if constexpr (kPromote) {
        mma<TI>(part, da, db, kk > 0);
      } else {
        mma<TI>(acc, da, db, 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    if constexpr (kPromote) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        reg_fence(part[i]);
        acc[i] += part[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) reg_fence(acc[i]);
    }
    mbar_arrive(empty(s));
    // the first thread refills the stage once both warpgroups released it
    if (threadIdx.x == 0 && t + kStages < n_k) load(t + kStages);
    __syncwarp();
  }

  // the m64nN accumulator: this thread's rows row0 and row0 + 8, columns
  // 8j + 2 (lane % 4) + {0, 1} in acc[4j + 2r + {0, 1}]
  const int row0 = m0 + 64 * wg + 16 * warp + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < M && col < N)
        store2(c, out_dtype, row * ldc + col, acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1],
               col + 1 < N);
    }
  }
}

// B (K, N) int8/fp8 -> B^T (N, ldt): 64 x 64 tiles through shared memory,
// zeros for k in [K, ldt).  Bound by bytes: K*N read and N*ldt written.
__global__ void __launch_bounds__(256)
transpose8_kernel(const uint8_t* __restrict__ b, uint8_t* __restrict__ bt, int K, int N,
                  int ldt) {
  __shared__ uint8_t tile[64][65];
  const int k0 = blockIdx.y * 64, n0 = blockIdx.x * 64;
  const int tx = threadIdx.x % 64, ty = threadIdx.x / 64;
  for (int r = ty; r < 64; r += 4) {
    const int k = k0 + r, n = n0 + tx;
    tile[r][tx] = (k < K && n < N) ? b[static_cast<long long>(k) * N + n] : 0;
  }
  __syncthreads();
  for (int r = ty; r < 64; r += 4) {
    const int n = n0 + r, k = k0 + tx;
    if (n < N && k < ldt) bt[static_cast<long long>(n) * ldt + k] = tile[tx][r];
  }
}

// A 2-D map over a row-major (rows, cols) matrix with a row stride of `ld`
// elements; boxes of 128 bytes of columns x `box_rows` rows, 128-byte swizzle.
bool encode2d(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes, const void* ptr,
              int rows, int cols, long long ld, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) {
    fprintf(stderr, "matmul: cuTensorMapEncodeTiled is not available\n");
    return false;
  }
  const cuuint64_t gdim[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t gstride[1] = {static_cast<cuuint64_t>(ld * elem_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kRowBytes / elem_bytes),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estride[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(ptr), gdim, gstride, box, estride,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    fprintf(stderr, "matmul: cuTensorMapEncodeTiled failed with CUresult %d\n",
            static_cast<int>(r));
    return false;
  }
  return true;
}

template <typename TI>
int launch_tc(CUtensorMapDataType type, int out_dtype, const void* a, const void* b, void* c,
              int M, int N, int K, long long lda, long long ldb, long long ldc, cudaStream_t s) {
  constexpr int es = sizeof(TI);
  CUtensorMap ta, tb;
  const bool ok =
      encode2d(&ta, type, es, a, M, K, lda, BM) &&
      (Traits<TI>::kBKMajor ? encode2d(&tb, type, es, b, N, K, ldb, BN)       // B^T (N, K)
                            : encode2d(&tb, type, es, b, K, N, ldb, kRowBytes / es));  // B (K, N)
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  constexpr bool kPromote = std::is_same<TI, __nv_fp8_e4m3>::value;
  static_assert(kSmemBytes <= 232448, "the ring does not fit one block's shared memory");
  auto kernel = tc_kernel<TI, kPromote>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, kThreads, kSmemBytes, s>>>(ta, tb, c, out_dtype, M, N, K, ldc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// float32 in, any output type out: the FP32-pipe kernel.  Contiguous rows.
extern "C" int repro_matmul(int in_dtype, int out_dtype, const void* a, const void* b, void* c,
                            int M, int N, int K, void* stream) {
  if (in_dtype != kF32) return static_cast<int>(cudaErrorInvalidValue);
  return launch_fp32(out_dtype, a, b, c, M, N, K, static_cast<cudaStream_t>(stream));
}

// bf16 / fp16 / int8 / fp8 e4m3 in, any output type out: the tensor cores.
// a is (M, K) with a row stride of lda elements; b is (K, N) with row stride
// ldb for the 16-bit types and B^T (N, K) with row stride ldb for the 8-bit
// ones; c is (M, N) with row stride ldc.  lda and ldb must make rows of a
// multiple of 16 bytes and the pointers 16-byte aligned (the TMA's units).
extern "C" int repro_matmul_tc(int in_dtype, int out_dtype, const void* a, const void* b, void* c,
                               int M, int N, int K, long long lda, long long ldb, long long ldc,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || K < 1 || out_dtype < kF32 || out_dtype > kF8E4M3)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (in_dtype) {
    case kBF16:
      return tc::launch_tc<__nv_bfloat16>(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, out_dtype, a, b, c, M,
                                          N, K, lda, ldb, ldc, s);
    case kF16:
      return tc::launch_tc<__half>(CU_TENSOR_MAP_DATA_TYPE_FLOAT16, out_dtype, a, b, c, M, N, K,
                                   lda, ldb, ldc, s);
    case kI8:
      return tc::launch_tc<int8_t>(CU_TENSOR_MAP_DATA_TYPE_UINT8, out_dtype, a, b, c, M, N, K,
                                   lda, ldb, ldc, s);
    case kF8E4M3:
      return tc::launch_tc<__nv_fp8_e4m3>(CU_TENSOR_MAP_DATA_TYPE_UINT8, out_dtype, a, b, c, M, N,
                                          K, lda, ldb, ldc, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// B (K, N) of 8-bit values -> B^T (N, ldt), zero past K.
extern "C" int repro_matmul_transpose8(const void* b, void* bt, int K, int N, int ldt,
                                       void* stream) {
  if (K < 1 || N < 1 || ldt < K) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + 63) / 64, (ldt + 63) / 64);
  tc::transpose8_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(b), static_cast<uint8_t*>(bt), K, N, ldt);
  return static_cast<int>(cudaGetLastError());
}
