// axpy: out = alpha * x + y over (block_rows, block_cols) tiles of an (R, C) array.
//
// Replaces src/repro/kernels/axpy.py::_axpy_kernel (axpy_pallas).
//
// Bound on the H100: bytes.  Two reads and one write per element against one
// multiply and one add, so the floor is 3 * R * C * itemsize over the memory
// rate (3.35 TB/s from HBM).
//
// Design: the paper's Ch. 1 point is that the width of each global access
// decides how much of that rate a kernel reaches (cublasSaxpy's 64-bit loads
// against 128-bit ones).  Here the width is a template parameter: each thread
// moves `vec_bytes` (4, 8 or 16) per access through an aligned vector type,
// so the compiler emits LDG.32/.64/.128 and the sweep over widths is the
// experiment itself.  One block per (block_rows, block_cols) tile, as the
// TPU grid had one program per tile; neighbouring threads take neighbouring
// vectors of a tile row, so every warp access is coalesced.  alpha arrives
// already rounded to the element type, and the product is rounded before the
// add (__fmul_rn / __fadd_rn, no contraction), which is what the plain
// version's `alpha * x + y` does.
#include "common.cuh"

constexpr int kMaxThreads = 256;

template <typename T, int NV>
struct alignas(sizeof(T) * NV) Vec {
  T v[NV];
};

template <typename T>
__device__ __forceinline__ T axpy1(float alpha, T x, T y) {
  const T prod = from_f32<T>(__fmul_rn(alpha, to_f32(x)));
  return from_f32<T>(__fadd_rn(to_f32(prod), to_f32(y)));
}

template <typename T, int NV>
__global__ void __launch_bounds__(kMaxThreads)
axpy_kernel(float alpha, const T* x, const T* y, T* out, long long cols, int block_rows,
            int block_cols, long long col_tiles) {
  using V = Vec<T, NV>;
  const long long tile = blockIdx.x;
  const long long r0 = (tile / col_tiles) * block_rows;
  const long long c0 = (tile % col_tiles) * block_cols;
  const int row_vecs = block_cols / NV;
  const int tile_vecs = block_rows * row_vecs;
  for (int a = threadIdx.x; a < tile_vecs; a += blockDim.x) {
    const long long off = (r0 + a / row_vecs) * cols + c0 + static_cast<long long>(a % row_vecs) * NV;
    const V xv = *reinterpret_cast<const V*>(x + off);
    const V yv = *reinterpret_cast<const V*>(y + off);
    V ov;
#pragma unroll
    for (int k = 0; k < NV; ++k) ov.v[k] = axpy1(alpha, xv.v[k], yv.v[k]);
    *reinterpret_cast<V*>(out + off) = ov;
  }
}

template <typename T, int NV>
static void launch(float alpha, const void* x, const void* y, void* out, long long rows,
                   long long cols, int block_rows, int block_cols, cudaStream_t s) {
  const long long col_tiles = cols / block_cols;
  const long long tiles = (rows / block_rows) * col_tiles;
  const int tile_vecs = block_rows * (block_cols / NV);
  int threads = tile_vecs < kMaxThreads ? tile_vecs : kMaxThreads;
  threads = (threads + 31) / 32 * 32;
  axpy_kernel<T, NV><<<static_cast<unsigned>(tiles), threads, 0, s>>>(
      alpha, static_cast<const T*>(x), static_cast<const T*>(y), static_cast<T*>(out), cols,
      block_rows, block_cols, col_tiles);
}

template <typename T>
static int launch_width(int vec_bytes, float alpha, const void* x, const void* y, void* out,
                        long long rows, long long cols, int block_rows, int block_cols,
                        cudaStream_t s) {
  constexpr int E = static_cast<int>(sizeof(T));
  switch (vec_bytes) {
    case 4:
      launch<T, 4 / E>(alpha, x, y, out, rows, cols, block_rows, block_cols, s);
      break;
    case 8:
      launch<T, 8 / E>(alpha, x, y, out, rows, cols, block_rows, block_cols, s);
      break;
    case 16:
      launch<T, 16 / E>(alpha, x, y, out, rows, cols, block_rows, block_cols, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_axpy(int dtype, int vec_bytes, float alpha, const void* x, const void* y,
                          void* out, long long rows, long long cols, int block_rows,
                          int block_cols, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_width<float>(vec_bytes, alpha, x, y, out, rows, cols, block_rows,
                                 block_cols, s);
    case kBF16:
      return launch_width<__nv_bfloat16>(vec_bytes, alpha, x, y, out, rows, cols, block_rows,
                                         block_cols, s);
    case kF16:
      return launch_width<__half>(vec_bytes, alpha, x, y, out, rows, cols, block_rows,
                                  block_cols, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
