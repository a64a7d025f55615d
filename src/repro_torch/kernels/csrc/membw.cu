// The streaming-bandwidth probes of src/repro/kernels/membw.py:
//
//   stream_reduce   fp32 sum of every element of x into one (1,1) checksum;
//                   replaces _reduce_kernel.
//   stream_copy     out = x, any dtype, bit for bit; replaces _copy_kernel.
//   strided_reduce  fp32 sum of the rows whose offset within their block of
//                   block_rows rows is a multiple of stride; replaces
//                   _strided_reduce_kernel, whose stride restarts in every block.
//
// Bound on the H100: bytes.  Each element is read (and for the copy written)
// once and the sum is one add per element, far below the FP32 rate, so the
// floor is the bytes moved over the bandwidth of the level that holds them
// (3.35 TB/s from HBM).  For strided_reduce the bytes are those of the rows
// it sums.
//
// Design: the TPU kernels walk a sequential grid of (block_rows, block_cols)
// tiles and carry the sum from step to step in one (1,1) output block.
// Hopper runs blocks in parallel and in no order, so each reduction here runs a
// grid sized by the wrapper (8 blocks of 256 threads per SM, enough loads in
// flight to cover HBM latency) over the whole array in a grid-stride loop
// with 16-byte accesses.  The reductions take two passes: pass 1 writes one
// partial per block, pass 2 is one block that sums the partials.  Both passes
// add in a fixed order, so the result is deterministic (atomics would not
// be).  The copy keeps several loads in flight a thread (copy_kernel,
// below).  The wrappers' block_rows/block_cols keep the
// reference's meaning (the tile the shape must divide into, and for
// strided_reduce the block the stride restarts in); the CTA tile is the
// kernel's own.
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

// Pass 1 of strided_reduce: one warp per selected row (coalesced along the
// row), warps striding over the selected rows.  Selected row t is row
// (t / per) * block_rows + (t % per) * stride, `per` selected rows in each
// block.  VEC is 4 (float4 loads) when the row length allows.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
strided_partials(const float* x, int sel_rows, int cols, int per, int block_rows, int stride,
                 float* partials) {
  constexpr int kWarps = kThreads / 32;
  const int vecs = cols / VEC;
  const int lane = threadIdx.x & 31;
  float a = 0.f;
  for (int t = blockIdx.x * kWarps + (threadIdx.x >> 5); t < sel_rows; t += gridDim.x * kWarps) {
    const long long row = static_cast<long long>(t / per) * block_rows + (t % per) * stride;
    const float* xr = x + row * cols;
    for (int c = lane; c < vecs; c += 32) {
      if (VEC == 4) {
        a += sum4(reinterpret_cast<const float4*>(xr)[c]);
      } else {
        a += xr[c];
      }
    }
  }
  const float v = block_sum(a);
  if (threadIdx.x == 0) partials[blockIdx.x] = v;
}

// stream_copy.  A thread that waits for each 16-byte load before it issues
// the next keeps one access in flight, too few bytes to cover HBM latency
// (Little's law).  Here each thread loads kCopyUnroll 16-byte vectors of a
// round, blockDim apart so every warp access is coalesced, before it stores
// any; the loads read through the non-coherent path without allocating in L1,
// the stores are evict-first.  Blocks take rounds of blockDim * kCopyUnroll
// vectors in a grid stride, so at any moment the blocks in flight work on
// neighbouring addresses.  The wrapper sets the grid (kernels/membw.py::
// copy_plan).  The last block's threads copy the nbytes % 16 tail bytes, one
// each.  Every byte is moved unchanged: the copy is bit for bit for any dtype.
// (A ring of 1-D bulk copies through shared memory, one issuing thread a
// block, measured 2.8 % slower on the H100: PERF.md.)
constexpr int kCopyUnroll = 2;  // kernels/membw.py::COPY_UNROLL

__global__ void __launch_bounds__(1024)
copy_kernel(const uint4* __restrict__ x, uint4* __restrict__ out, long long n16,
            const unsigned char* __restrict__ xb, unsigned char* __restrict__ ob,
            long long nbytes) {
  const long long round = static_cast<long long>(blockDim.x) * kCopyUnroll;
  for (long long base = blockIdx.x * round; base < n16; base += round * gridDim.x) {
    uint4 v[kCopyUnroll];
#pragma unroll
    for (int k = 0; k < kCopyUnroll; ++k) {
      const long long i = base + k * blockDim.x + threadIdx.x;
      if (i < n16) v[k] = ld_stream(x + i);
    }
#pragma unroll
    for (int k = 0; k < kCopyUnroll; ++k) {
      const long long i = base + k * blockDim.x + threadIdx.x;
      if (i < n16) __stcs(out + i, v[k]);
    }
  }
  const long long t = (n16 << 4) + threadIdx.x;  // the nbytes % 16 tail bytes
  if (blockIdx.x == gridDim.x - 1 && t < nbytes) ob[t] = xb[t];
}

// ctas and threads are kernels/membw.py::copy_plan's.
extern "C" int repro_stream_copy(const void* x, long long nbytes, void* out, int ctas,
                                 int threads, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ctas < 1 || threads < 32 || threads > 1024 || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  copy_kernel<<<ctas, threads, 0, s>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), nbytes >> 4,
      static_cast<const unsigned char*>(x), static_cast<unsigned char*>(out), nbytes);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_strided_reduce(const void* x, int sel_rows, int cols, int per,
                                    int block_rows, int stride, void* partials, int blocks,
                                    void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* pf = static_cast<float*>(partials);
  if (cols % 4 == 0) {
    strided_partials<4><<<blocks, kThreads, 0, s>>>(xf, sel_rows, cols, per, block_rows, stride, pf);
  } else {
    strided_partials<1><<<blocks, kThreads, 0, s>>>(xf, sel_rows, cols, per, block_rows, stride, pf);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_final<<<1, kFinalThreads, 0, s>>>(pf, blocks, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
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
