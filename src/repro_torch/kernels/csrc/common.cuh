// Shared helpers for the port's hand-written kernels.
//
// Every kernel file exports plain C entry points (loaded with ctypes): device
// pointers and the stream arrive as void*, and each entry point returns
// cudaGetLastError() after its launches so the Python wrapper can raise on a
// launch the CUDA runtime refused.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

// dtype codes shared with repro_torch/kernels/_util.py::DTYPE_CODES
enum ReproDtype { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of `v` over the block, valid in thread 0.  Fixed order: deterministic.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warps[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) warps[warp] = v;
  __syncthreads();
  const int nwarps = (blockDim.x + 31) >> 5;
  v = threadIdx.x < nwarps ? warps[lane] : 0.f;
  if (warp == 0) v = warp_sum(v);
  return v;
}
