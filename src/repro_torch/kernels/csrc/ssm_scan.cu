// ssm_scan: the chunked Mamba2 SSD scan from a zero initial state, with no
// final-state output.
//
// Replaces src/repro/kernels/ssm_scan.py::_ssd_kernel (ssm_scan_pallas).
//
// Layouts are the model's, not ssm_scan_pallas's flattened (BH, S, .) one:
// u and y are (B, S, H, P) in the input dtype, a_log is (B, S, H) fp32, and
// b, c are (B, S, N) in u's dtype, shared by the H heads of a batch row: each
// head reads them (from L2) instead of a copy expanded H times in device
// memory.  S is a multiple of the chunk length L (the op's wrapper pads).
//
// Per (batch, head) and chunk of L steps, all in fp32 (the reference's
// numerics; y is cast to u's dtype):
//   acum = cumsum(a), atot = acum[L-1]
//   y_t  = sum_{s<=t} (C_t . B_s) exp(clip(acum_t - acum_s, -60, 0)) u_s
//          + exp(acum_t) (C_t . h_p)                      for each column p
//   h   <- h exp(atot) + sum_s exp(clip(atot - acum_s, -60, 0)) u_s B_s^T
//
// Bound on the H100: bytes, at zamba2-7b's shape (B 4, S 1024, H 112,
// P = N = 64, L 256).  u and y in bf16 are 58.7 MB each, a_log 1.8 MB and the
// head-shared B and C 0.5 MB each: ~120 MB, 0.036 ms at 3.35 TB/s.  The
// causal tiles are ~22.6 GFLOP: 0.023 ms at the bf16 tensor-core rate, but
// 0.34 ms on the FP32 pipes this kernel uses, so its floor is ~10x the bound;
// wgmma is later work (ROADMAP.md).
//
// Design: the TPU kernel walks the chunks as a sequential grid axis and keeps
// h in VMEM scratch.  Here one block of 256 threads owns one (batch, head,
// slice of up to 128 columns of P) and loops over the chunks itself, with its
// slice of h (fp32) in shared memory: the columns of P never mix (y[:, p] and
// h[p, :] read only u[:, p]), so P > 128 splits over the grid.  N is summed
// over (C.B^T, C.h) but its slabs never mix either: y is the sum over slabs
// of 128 of N of the scan run with B, C and h cut to the slab.  So the block
// runs the whole scan once per slab, and with more than one slab adds y into
// an fp32 scratch the wrapper allocates, casting to u's dtype after the last.
// The chunk's acum is a block scan in segments of 256 with a carry, into
// shared memory, or into a global scratch when a very long chunk leaves it no
// room.  The (L x L) score
// matrix does not fit (256 KB at L 256), so y is computed in 64-row tiles:
// for row tile i, C_i is staged in shared memory and the carried state's term
// C_i h^T starts the accumulator; then each key tile j <= i (the tiles above
// the diagonal are skipped) stages B_j and u_j, forms the 64 x 64
// decay-masked score tile W, and adds W u_j.  Only after every row tile of
// the chunk has read the old h does the state update re-stage B_j and the
// decayed u_j, tile by tile, into per-thread sums of h.  Tiles are zero-filled
// past the chunk's end and past P or N, so every L <= 256 and P, N <= 128
// run the same code; K = ceil(min(max(P, N), 128) / 16), rounded up to a power
// of two, picks the template.  Thread (ty, tx) of a 16 x 16 grid owns rows
// 4ty..4ty+3 of a tile, keys tx + 16j of a score tile, columns tx + 16k of y,
// and h[ty + 16a][tx + 16b].  Products run on the FP32 pipes.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;   // a 16 x 16 grid of (ty, tx)
constexpr int TR = 64;          // rows of a query or key tile
constexpr int WS = TR + 4;      // row stride of the transposed score tile, in floats
constexpr int kDimTile = 128;   // columns of P a block, values of N a slab
constexpr float kClipLo = -60.f;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float dot4(float4 x, float4 y, float acc) {
  return fmaf(x.w, y.w, fmaf(x.z, y.z, fmaf(x.y, y.y, fmaf(x.x, y.x, acc))));
}
__device__ __forceinline__ float clip_exp(float x) {
  return expf(fminf(fmaxf(x, kClipLo), 0.f));
}

// A TR-row tile into shared memory as fp32, row stride `ss`, WIDTH columns:
// element (r, col) is src[r * ld + col] for r < rows and col < cols, else 0.
// With `acum` given, row r is scaled by exp(clip(atot - acum[r], -60, 0)).
template <int WIDTH, typename T>
__device__ __forceinline__ void stage(float* dst, int ss, const T* src, long long ld, int rows,
                                      int cols, const float* acum = nullptr, float atot = 0.f) {
  for (int i = threadIdx.x; i < TR * WIDTH; i += kThreads) {
    const int r = i / WIDTH, col = i % WIDTH;
    float v = 0.f;
    if (r < rows && col < cols) {
      v = to_f32(src[r * ld + col]);
      if (acum) v *= clip_exp(atot - acum[r]);
    }
    dst[r * ss + col] = v;
  }
}

// Shared-memory floats of the tiles; acum's ceil(L / 64) * 64 come on top.
template <int K>
constexpr size_t smem_floats() {
  constexpr int W = 16 * K, NS = W + 4;
  return W * NS + 2 * TR * NS + TR * W + TR * WS;
}

// acum_g: null when acum fits in shared memory, else L_r floats a block.
// yacc: null with one slab of N, else an fp32 (B, S, H, P) scratch.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads, K <= 4 ? 2 : 1)
ssd_kernel(const T* __restrict__ u, const float* __restrict__ a, const T* __restrict__ b,
           const T* __restrict__ c, T* __restrict__ y, float* __restrict__ yacc,
           float* __restrict__ acum_g, int S, int H, int P, int N, int L) {
  constexpr int W = 16 * K;  // P and N, padded
  constexpr int NS = W + 4;  // row stride of h, C and B in shared memory
  extern __shared__ __align__(16) float smem[];
  float* Hs = smem;            // [W][NS]  the state h
  float* Cs = Hs + W * NS;     // [TR][NS] C rows of the current row tile
  float* Bs = Cs + TR * NS;    // [TR][NS] B rows of the current key tile
  float* Us = Bs + TR * NS;    // [TR][W]  u rows of the current key tile
  float* Wt = Us + TR * W;     // [TR][WS] the score tile, transposed: Wt[s][t]
  const int ntiles = (L + TR - 1) / TR;
  const int ptiles = (P + kDimTile - 1) / kDimTile;
  float* acum = acum_g ? acum_g + static_cast<long long>(blockIdx.x) * ntiles * TR
                       : Wt + TR * WS;  // [ntiles * TR]
  __shared__ float warp_tot[kThreads / 32];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x / ptiles, p0 = (blockIdx.x % ptiles) * kDimTile;
  const int bsz = bh / H, h = bh % H;
  const int pw = min(kDimTile, P - p0);  // this block's columns of P
  const long long ustep = static_cast<long long>(H) * P;  // elements between steps of u and y
  const T* ub = u + static_cast<long long>(h) * P + p0;
  T* yb = y + static_cast<long long>(h) * P + p0;
  float* yab = yacc ? yacc + static_cast<long long>(h) * P + p0 : nullptr;

  for (int n0 = 0; n0 < N; n0 += kDimTile) {
    const int nw = min(kDimTile, N - n0);  // this slab's values of N
    const bool first_slab = n0 == 0, last_slab = n0 + kDimTile >= N;
    __syncthreads();  // the last slab's readers of h are done
    for (int i = tid; i < W * NS; i += kThreads) Hs[i] = 0.f;

    for (int t0 = 0; t0 < S; t0 += L) {
      const long long step0 = static_cast<long long>(bsz) * S + t0;  // (bsz, t0) on the B*S axis

      // 1. acum = cumsum(a) over the chunk, 256 entries at a time with the sum
      //    so far carried; entries from L on hold atot
      __syncthreads();  // the last chunk's readers of acum and warp_tot are done
      {
        const int lane = tid & 31, warp = tid >> 5;
        float carry = 0.f;
        for (int base = 0; base < ntiles * TR; base += kThreads) {
          float v = base + tid < L ? a[(step0 + base + tid) * H + h] : 0.f;
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const float n = __shfl_up_sync(0xffffffffu, v, o);
            if (lane >= o) v += n;
          }
          if (lane == 31) warp_tot[warp] = v;
          __syncthreads();
          for (int w = 0; w < warp; ++w) v += warp_tot[w];
          if (base + tid < ntiles * TR) acum[base + tid] = v + carry;
          float seg = 0.f;
          for (int w = 0; w < kThreads / 32; ++w) seg += warp_tot[w];
          carry += seg;
          __syncthreads();  // warp_tot is read before the next segment writes it
        }
      }
      __syncthreads();
      const float atot = acum[L - 1];

      // 2. y, one row tile at a time
      for (int i = 0; i < ntiles; ++i) {
        const int r0 = i * TR;
        __syncthreads();  // the last row tile's readers of C are done
        stage<W>(Cs, NS, c + (step0 + r0) * N + n0, N, min(TR, L - r0), nw);
        __syncthreads();

        float acc[4][K];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int k = 0; k < K; ++k) acc[ii][k] = 0.f;
        if (t0 > 0) {  // the carried state's term; h is zero in the first chunk
#pragma unroll 2
          for (int d = 0; d < W; d += 4) {
            float4 cv[4];
#pragma unroll
            for (int ii = 0; ii < 4; ++ii) cv[ii] = ld4(Cs + (ty * 4 + ii) * NS + d);
#pragma unroll
            for (int k = 0; k < K; ++k) {
              const float4 hv = ld4(Hs + (tx + 16 * k) * NS + d);
#pragma unroll
              for (int ii = 0; ii < 4; ++ii) acc[ii][k] = dot4(cv[ii], hv, acc[ii][k]);
            }
          }
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) {
            const float e = expf(acum[r0 + ty * 4 + ii]);
#pragma unroll
            for (int k = 0; k < K; ++k) acc[ii][k] *= e;
          }
        }

        for (int j = 0; j <= i; ++j) {
          const int s0 = j * TR;
          __syncthreads();  // the last key tile's readers of B, u and W are done
          stage<W>(Bs, NS, b + (step0 + s0) * N + n0, N, min(TR, L - s0), nw);
          stage<W>(Us, W, ub + (step0 + s0) * ustep, ustep, min(TR, L - s0), pw);
          __syncthreads();

          float sc[4][4];
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) sc[ii][jj] = 0.f;
#pragma unroll 2
          for (int d = 0; d < W; d += 4) {
            float4 cv[4], bv[4];
#pragma unroll
            for (int ii = 0; ii < 4; ++ii) cv[ii] = ld4(Cs + (ty * 4 + ii) * NS + d);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) bv[jj] = ld4(Bs + (tx + 16 * jj) * NS + d);
#pragma unroll
            for (int ii = 0; ii < 4; ++ii)
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) sc[ii][jj] = dot4(cv[ii], bv[jj], sc[ii][jj]);
          }
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int sl = tx + 16 * jj, s = s0 + sl;
            float w[4];
#pragma unroll
            for (int ii = 0; ii < 4; ++ii) {
              const int t = r0 + ty * 4 + ii;
              w[ii] = (s <= t && t < L) ? sc[ii][jj] * clip_exp(acum[t] - acum[s]) : 0.f;
            }
            *reinterpret_cast<float4*>(Wt + sl * WS + ty * 4) = make_float4(w[0], w[1], w[2], w[3]);
          }
          __syncthreads();

#pragma unroll 4
          for (int sl = 0; sl < TR; ++sl) {
            const float4 w = ld4(Wt + sl * WS + ty * 4);
#pragma unroll
            for (int k = 0; k < K; ++k) {
              const float uv = Us[sl * W + tx + 16 * k];
              acc[0][k] = fmaf(w.x, uv, acc[0][k]);
              acc[1][k] = fmaf(w.y, uv, acc[1][k]);
              acc[2][k] = fmaf(w.z, uv, acc[2][k]);
              acc[3][k] = fmaf(w.w, uv, acc[3][k]);
            }
          }
        }

#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const int t = r0 + ty * 4 + ii;
          if (t >= L) continue;
          T* yr = yb + (step0 + t) * ustep;
          float* yar = yab ? yab + (step0 + t) * ustep : nullptr;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int p = tx + 16 * k;
            if (p >= pw) continue;
            // the slabs of N: this thread wrote yar[p] in the last slab itself
            const float v = first_slab ? acc[ii][k] : acc[ii][k] + yar[p];
            if (last_slab) {
              yr[p] = from_f32<T>(v);
            } else {
              yar[p] = v;
            }
          }
        }
      }

      // 3. h <- h exp(atot) + (u sdecay)^T B, once every row tile has read the old h
      __syncthreads();
      float hacc[K][K];
      const float decay = expf(atot);
#pragma unroll
      for (int pa = 0; pa < K; ++pa)
#pragma unroll
        for (int nb = 0; nb < K; ++nb) hacc[pa][nb] = Hs[(ty + 16 * pa) * NS + tx + 16 * nb] * decay;
      for (int j = 0; j < ntiles; ++j) {
        const int s0 = j * TR, rows = min(TR, L - s0);
        __syncthreads();  // the last readers of B and u are done
        stage<W>(Bs, NS, b + (step0 + s0) * N + n0, N, rows, nw);
        stage<W>(Us, W, ub + (step0 + s0) * ustep, ustep, rows, pw, acum + s0, atot);
        __syncthreads();
#pragma unroll 4
        for (int sl = 0; sl < TR; ++sl) {
          float uv[K], bv[K];
#pragma unroll
          for (int pa = 0; pa < K; ++pa) uv[pa] = Us[sl * W + ty + 16 * pa];
#pragma unroll
          for (int nb = 0; nb < K; ++nb) bv[nb] = Bs[sl * NS + tx + 16 * nb];
#pragma unroll
          for (int pa = 0; pa < K; ++pa)
#pragma unroll
            for (int nb = 0; nb < K; ++nb) hacc[pa][nb] = fmaf(uv[pa], bv[nb], hacc[pa][nb]);
        }
      }
      // each thread rewrites only the entries of h it read; the next reader of h
      // is the next chunk, after its first barrier
#pragma unroll
      for (int pa = 0; pa < K; ++pa)
#pragma unroll
        for (int nb = 0; nb < K; ++nb) Hs[(ty + 16 * pa) * NS + tx + 16 * nb] = hacc[pa][nb];
    }
  }  // slabs of N
}

template <typename T, int K>
int launch(const void* u, const void* a, const void* b, const void* c, void* y, void* yacc,
           void* acum, int batch, int S, int H, int P, int N, int L, cudaStream_t s) {
  constexpr size_t tiles = smem_floats<K>() * sizeof(float);
  constexpr size_t limit = 232448 - kThreads / 32 * sizeof(float);
  static_assert(tiles <= limit, "tiles do not fit one block's shared memory");
  const size_t acum_bytes = static_cast<size_t>((L + TR - 1) / TR) * TR * sizeof(float);
  const bool acum_shared = tiles + acum_bytes <= limit;
  const size_t bytes = tiles + (acum_shared ? acum_bytes : 0);
  if (!acum_shared && acum == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(ssd_kernel<T, K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ptiles = (P + kDimTile - 1) / kDimTile;
  ssd_kernel<T, K><<<batch * H * ptiles, kThreads, bytes, s>>>(
      static_cast<const T*>(u), static_cast<const float*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y), static_cast<float*>(yacc),
      acum_shared ? nullptr : static_cast<float*>(acum), S, H, P, N, L);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_k(const void* u, const void* a, const void* b, const void* c, void* y, void* yacc,
             void* acum, int batch, int S, int H, int P, int N, int L, cudaStream_t s) {
  const int k = (max(min(P, kDimTile), min(N, kDimTile)) + 15) / 16;
  if (k <= 1) return launch<T, 1>(u, a, b, c, y, yacc, acum, batch, S, H, P, N, L, s);
  if (k <= 2) return launch<T, 2>(u, a, b, c, y, yacc, acum, batch, S, H, P, N, L, s);
  if (k <= 4) return launch<T, 4>(u, a, b, c, y, yacc, acum, batch, S, H, P, N, L, s);
  return launch<T, 8>(u, a, b, c, y, yacc, acum, batch, S, H, P, N, L, s);
}

}  // namespace

// Shared-memory room for acum (ceil(L / 64) * 64 floats) beside the tiles of
// the template (P, N) pick: 1 when the kernel keeps acum in shared memory, 0
// when it needs the global scratch of repro_ssm_scan's `acum` argument.
extern "C" int repro_ssm_scan_acum_fits(int P, int N, int L) {
  const int k = (max(min(P, kDimTile), min(N, kDimTile)) + 15) / 16;
  const size_t tiles = (k <= 1   ? smem_floats<1>()
                        : k <= 2 ? smem_floats<2>()
                        : k <= 4 ? smem_floats<4>()
                                 : smem_floats<8>()) * sizeof(float);
  const size_t acum_bytes = static_cast<size_t>((L + TR - 1) / TR) * TR * sizeof(float);
  return tiles + acum_bytes <= 232448 - kThreads / 32 * sizeof(float);
}

// yacc: an fp32 (B, S, H, P) scratch when N > 128, else null.  acum: a scratch
// of B * H * ceil(P / 128) * ceil(L / 64) * 64 floats when
// repro_ssm_scan_acum_fits is 0, else null.
extern "C" int repro_ssm_scan(int dtype, const void* u, const void* a, const void* b,
                              const void* c, void* y, void* yacc, void* acum, int batch, int S,
                              int H, int P, int N, int L, void* stream) {
  if (L < 1 || S % L || P < 1 || N < 1 || (N > kDimTile && yacc == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_k<float>(u, a, b, c, y, yacc, acum, batch, S, H, P, N, L, s);
    case kBF16:
      return launch_k<__nv_bfloat16>(u, a, b, c, y, yacc, acum, batch, S, H, P, N, L, s);
    case kF16: return launch_k<__half>(u, a, b, c, y, yacc, acum, batch, S, H, P, N, L, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
