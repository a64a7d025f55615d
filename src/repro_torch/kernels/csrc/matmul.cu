// matmul: out (M, N) = a (M, K) @ b (K, N), fp32 accumulation, cast to out's dtype.
//
// Replaces src/repro/kernels/matmul.py::_matmul_kernel (matmul_pallas).
//
// Bound on the H100: operations.  2*M*N*K FLOPs; in fp32 outside the tensor
// cores the peak is 67 TFLOP/s (989 TFLOP/s bf16/fp16 on the tensor cores,
// which this kernel does not use yet), while the three matrices move once at
// 3.35 TB/s, far less time for any n this repo probes.
//
// Design: the TPU kernel walks K as the innermost, sequential grid axis and
// keeps the fp32 accumulator in VMEM scratch.  Here each block owns one
// 128x128 output tile and loops over K itself, 8 columns of A and 8 rows of B
// at a time through static shared memory (2 x 4 KB; a 128^3 fp32 tile would
// not fit the 48 KB static limit).  Each of the 256 threads keeps an 8x8
// accumulator in registers (two 4-wide strips in each dimension, 64 apart,
// so the float4 reads of a warp from shared memory are conflict-free) and
// issues 64 FMAs per 16 shared loads.  Inputs are widened to fp32 as they
// are staged, so bf16/fp16 also run on the FP32 pipes with fp32
// accumulation; no TF32 anywhere.  Edge tiles are zero-filled on load and
// masked on store, so any M, N, K runs.
#include "common.cuh"

constexpr int BM = 128, BN = 128, BK = 8, kThreads = 256;

template <typename TI, typename TO>
__global__ void __launch_bounds__(kThreads)
matmul_kernel(const TI* A, const TI* B, TO* C, int M, int N, int K) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int l = 0; l < (BM * BK) / kThreads; ++l) {
      const int idx = tid + l * kThreads;
      const int r = idx / BK, c = idx % BK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? to_f32(A[static_cast<long long>(gm) * K + gk]) : 0.f;
    }
#pragma unroll
    for (int l = 0; l < (BK * BN) / kThreads; ++l) {
      const int idx = tid + l * kThreads;
      const int r = idx / BN, c = idx % BN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < K && gn < N) ? to_f32(B[static_cast<long long>(gk) * N + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a_lo = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a_hi = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b_lo = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b_hi = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float a[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w, a_hi.x, a_hi.y, a_hi.z, a_hi.w};
      const float b[8] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w, b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (gn < N) C[static_cast<long long>(gm) * N + gn] = from_f32<TO>(acc[i][j]);
    }
  }
}

template <typename TI, typename TO>
static int launch(const void* a, const void* b, void* c, int M, int N, int K, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  matmul_kernel<TI, TO><<<grid, kThreads, 0, s>>>(static_cast<const TI*>(a),
                                                  static_cast<const TI*>(b),
                                                  static_cast<TO*>(c), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <typename TI>
static int launch_out(int out_dtype, const void* a, const void* b, void* c, int M, int N, int K,
                      cudaStream_t s) {
  switch (out_dtype) {
    case kF32: return launch<TI, float>(a, b, c, M, N, K, s);
    case kBF16: return launch<TI, __nv_bfloat16>(a, b, c, M, N, K, s);
    case kF16: return launch<TI, __half>(a, b, c, M, N, K, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

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
