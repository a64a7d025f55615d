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
// against 128-bit ones).  The experiment's two variables keep their meaning:
// one block per (block_rows, block_cols) tile, as the TPU grid had one
// program per tile, and every global access `vec_bytes` (4, 8 or 16) wide,
// LDG/STG .32/.64/.128, a template parameter.  What a tile's threads do
// inside it is Hopper's: by Little's law a thread that waits for each load
// before it issues the next cannot hold enough bytes in flight to cover HBM
// latency, so each thread owns kUnroll vectors per round, spaced one block
// width apart (so every warp access is coalesced), and issues all their x
// and y loads, back to back once the round's offsets are known, before any
// arithmetic or store.  The loads read through the
// non-coherent path without allocating in L1 and the stores are evict-first
// (each byte is touched once).  kUnroll is one constant for every width:
// bytes in flight then scale with the width, which stays the sweep's only
// variable.  The launch geometry (threads, rounds) comes from the wrapper
// (kernels/axpy.py::axpy_geometry); a round past the tile's last vector is
// masked.  Each thread walks its vectors' offsets by adds, with one wrap per
// tile row crossed, so no access divides.  alpha arrives already rounded to
// the element type, and the product is rounded before the add (__fmul_rn /
// __fadd_rn, no contraction), which is what the plain version's
// `alpha * x + y` does.
#include "common.cuh"

constexpr int kMaxThreads = 1024;
constexpr int kUnroll = 4;  // kernels/axpy.py::AXPY_UNROLL
// The unroll the kernel runs at each access width: kUnroll at every one.
// repro_axpy_unroll reports it, so a check can read the kernel's own.
template <int VB> constexpr int kUnrollAt = kUnroll;

template <int VB> struct Raw;
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

template <typename T, int NV>
struct alignas(sizeof(T) * NV) Vec {
  T v[NV];
};

template <typename T>
__device__ __forceinline__ T axpy1(float alpha, T x, T y) {
  const T prod = from_f32<T>(__fmul_rn(alpha, to_f32(x)));
  return from_f32<T>(__fadd_rn(to_f32(prod), to_f32(y)));
}

template <typename T, typename R>
__device__ __forceinline__ R axpy_vec(float alpha, R xr, R yr) {
  using V = Vec<T, sizeof(R) / sizeof(T)>;
  const V xv = *reinterpret_cast<const V*>(&xr);
  const V yv = *reinterpret_cast<const V*>(&yr);
  V ov;
#pragma unroll
  for (int k = 0; k < static_cast<int>(sizeof(R) / sizeof(T)); ++k)
    ov.v[k] = axpy1(alpha, xv.v[k], yv.v[k]);
  return *reinterpret_cast<const R*>(&ov);
}

template <typename T, int VB, int U>
__global__ void __launch_bounds__(kMaxThreads)
axpy_kernel(float alpha, const T* __restrict__ x, const T* __restrict__ y, T* __restrict__ out,
            long long cols, int block_rows, int row_vecs, int col_tiles, int rounds) {
  using R = typename Raw<VB>::type;
  constexpr int NV = VB / static_cast<int>(sizeof(T));
  const int tile_vecs = block_rows * row_vecs;
  const int tile_row = blockIdx.x / col_tiles, tile_col = blockIdx.x % col_tiles;
  const long long base = static_cast<long long>(tile_row) * block_rows * cols +
                         static_cast<long long>(tile_col) * row_vecs * NV;
  // this thread's vectors are v, v + step, v + 2 step, ...; (row, col) in the tile
  const int step = blockDim.x;
  const int drow = step / row_vecs, dcol = step % row_vecs;
  const long long doff = drow * cols + static_cast<long long>(dcol) * NV;
  const long long wrap = cols - static_cast<long long>(row_vecs) * NV;
  int v = threadIdx.x;
  int col = v % row_vecs;
  long long off = base + (v / row_vecs) * cols + static_cast<long long>(col) * NV;
  for (int r = 0; r < rounds; ++r) {
    long long offs[U];
    bool live[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      offs[k] = off;
      live[k] = v < tile_vecs;
      v += step;
      col += dcol;
      off += doff;
      if (col >= row_vecs) {
        col -= row_vecs;
        off += wrap;
      }
    }
    R xr[U], yr[U];  // all of the round's loads, then its stores
#pragma unroll
    for (int k = 0; k < U; ++k)
      if (live[k]) xr[k] = ld_stream(reinterpret_cast<const R*>(x + offs[k]));
#pragma unroll
    for (int k = 0; k < U; ++k)
      if (live[k]) yr[k] = ld_stream(reinterpret_cast<const R*>(y + offs[k]));
#pragma unroll
    for (int k = 0; k < U; ++k) {
      if (live[k]) __stcs(reinterpret_cast<R*>(out + offs[k]), axpy_vec<T>(alpha, xr[k], yr[k]));
    }
  }
}

// threads and rounds are kernels/axpy.py::axpy_geometry's; a geometry that
// does not cover the tile at this width's unroll is refused.
template <typename T, int VB>
static int launch(float alpha, const void* x, const void* y, void* out, long long rows,
                  long long cols, int block_rows, int block_cols, int threads, int rounds,
                  cudaStream_t s) {
  const int col_tiles = static_cast<int>(cols / block_cols);
  const long long tiles = (rows / block_rows) * col_tiles;
  const int row_vecs = block_cols / (VB / static_cast<int>(sizeof(T)));
  if (threads < 32 || threads > kMaxThreads || threads % 32 ||
      static_cast<long long>(rounds) * threads * kUnrollAt<VB> <
          static_cast<long long>(block_rows) * row_vecs)
    return static_cast<int>(cudaErrorInvalidValue);
  axpy_kernel<T, VB, kUnrollAt<VB>><<<static_cast<unsigned>(tiles), threads, 0, s>>>(
      alpha, static_cast<const T*>(x), static_cast<const T*>(y), static_cast<T*>(out), cols,
      block_rows, row_vecs, col_tiles, rounds);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_width(int vec_bytes, float alpha, const void* x, const void* y, void* out,
                        long long rows, long long cols, int block_rows, int block_cols,
                        int threads, int rounds, cudaStream_t s) {
  switch (vec_bytes) {
    case 4:
      return launch<T, 4>(alpha, x, y, out, rows, cols, block_rows, block_cols, threads, rounds,
                          s);
    case 8:
      return launch<T, 8>(alpha, x, y, out, rows, cols, block_rows, block_cols, threads, rounds,
                          s);
    case 16:
      return launch<T, 16>(alpha, x, y, out, rows, cols, block_rows, block_cols, threads,
                           rounds, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int repro_axpy(int dtype, int vec_bytes, float alpha, const void* x, const void* y,
                          void* out, long long rows, long long cols, int block_rows,
                          int block_cols, int threads, int rounds, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_width<float>(vec_bytes, alpha, x, y, out, rows, cols, block_rows,
                                 block_cols, threads, rounds, s);
    case kBF16:
      return launch_width<__nv_bfloat16>(vec_bytes, alpha, x, y, out, rows, cols, block_rows,
                                         block_cols, threads, rounds, s);
    case kF16:
      return launch_width<__half>(vec_bytes, alpha, x, y, out, rows, cols, block_rows,
                                  block_cols, threads, rounds, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The vectors a thread of the kernel loads before it stores at `vec_bytes`,
// or 0 for a width the kernel does not take.
extern "C" int repro_axpy_unroll(int vec_bytes) {
  switch (vec_bytes) {
    case 4: return kUnrollAt<4>;
    case 8: return kUnrollAt<8>;
    case 16: return kUnrollAt<16>;
    default: return 0;
  }
}
