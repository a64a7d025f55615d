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

// Loads of data read once: the non-coherent path, not allocated in L1.
__device__ __forceinline__ unsigned int ld_stream(const unsigned int* p) {
  unsigned int r;
  asm("ld.global.nc.L1::no_allocate.b32 %0, [%1];" : "=r"(r) : "l"(p));
  return r;
}
__device__ __forceinline__ uint2 ld_stream(const uint2* p) {
  uint2 r;
  asm("ld.global.nc.L1::no_allocate.v2.b32 {%0, %1}, [%2];" : "=r"(r.x), "=r"(r.y) : "l"(p));
  return r;
}
__device__ __forceinline__ uint4 ld_stream(const uint4* p) {
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.v4.b32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
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
