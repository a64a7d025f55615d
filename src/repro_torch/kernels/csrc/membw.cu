// stream_reduce: fp32 sum of every element of x into one (1,1) checksum.
//
// Replaces src/repro/kernels/membw.py::_reduce_kernel (stream_reduce).
//
// Bound on the H100: bytes.  Each element is read once and the sum is one
// add per element, far below the FP32 rate, so the floor is the array's size
// over the bandwidth of the level that holds it (3.35 TB/s from HBM).
//
// Design: the TPU kernel carries its sum across a sequential grid in one
// (1,1) output block; Hopper runs blocks in parallel and in no order, so the
// sum is two passes instead.  Pass 1 runs a grid sized by the wrapper (8
// blocks of 256 threads per SM, enough loads in flight to cover HBM latency);
// each thread streams 16-byte float4 loads in a grid-stride loop, four
// independent loads per iteration, and the block writes one partial.  Pass 2
// is one block that sums the partials.  Both passes add in a fixed order, so
// the result is deterministic (atomics would not be).  The wrapper's
// block_rows/block_cols keep the reference's meaning as the padding multiple;
// the CTA tile here is the kernel's own.
#include "common.cuh"

constexpr int kThreads = 256;
constexpr int kFinalThreads = 1024;

__device__ __forceinline__ float sum4(float4 v) { return (v.x + v.y) + (v.z + v.w); }

__global__ void __launch_bounds__(kThreads)
reduce_partials(const float* x, long long n, float* partials) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const long long n4 = n >> 2;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  long long i = tid;
  for (; i + 3 * stride < n4; i += 4 * stride) {
    const float4 p = x4[i], q = x4[i + stride], r = x4[i + 2 * stride], s = x4[i + 3 * stride];
    a0 += sum4(p);
    a1 += sum4(q);
    a2 += sum4(r);
    a3 += sum4(s);
  }
  for (; i < n4; i += stride) a0 += sum4(x4[i]);
  const long long t = (n4 << 2) + tid;  // the n % 4 trailing elements
  if (t < n) a0 += x[t];
  const float v = block_sum((a0 + a1) + (a2 + a3));
  if (threadIdx.x == 0) partials[blockIdx.x] = v;
}

__global__ void __launch_bounds__(kFinalThreads)
reduce_final(const float* partials, int n, float* out) {
  float v = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) v += partials[i];
  v = block_sum(v);
  if (threadIdx.x == 0) out[0] = v;
}

extern "C" int repro_stream_reduce(const void* x, long long n, void* partials, int blocks,
                                   void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  reduce_partials<<<blocks, kThreads, 0, s>>>(static_cast<const float*>(x), n,
                                               static_cast<float*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_final<<<1, kFinalThreads, 0, s>>>(static_cast<const float*>(partials), blocks,
                                           static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
