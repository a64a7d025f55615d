// flash_attention: out = softmax(mask(q k^T * hd^-0.5)) v over the head-flattened
// layout q (BH, Sq, hd), k/v (BH, Skv, hd); out in q's dtype.
//
// Replaces src/repro/kernels/flash_attention.py::_flash_kernel (flash_attention_pallas).
//
// Bound on the H100: operations at the model's shapes.  Causal attention does
// about 2*BH*Sq*Skv*hd FLOPs (half of the two full products) on
// 2*BH*(Sq+Skv)*hd elements; at hd 256 that is ~250 FLOPs per byte, near the
// bf16 ridge of the tensor cores.  This kernel runs on the FP32 pipes (67
// TFLOP/s, no tensor cores), so its floor is several times the card's bound;
// wgmma/TMA and native GQA are later work (ROADMAP.md).
//
// Numerics are the reference's: q is widened to fp32 and scaled by hd^-0.5
// before the dot; scores of invalid keys (k >= kv_len, or k > q_offset + q
// when causal) are -1e30 and their p is 0; m, l and acc are fp32 and the
// output is acc / max(l, 1e-30).
//
// Design: the TPU kernel walks KV blocks as a sequential grid axis with
// (m, l, acc) in VMEM scratch.  Here one block of 256 threads owns 64 query
// rows of one (batch*head) and loops over 64-key tiles itself, keeping m and
// l in registers and acc (64 x hd fp32) spread over the threads' registers:
// thread (ty, tx) of a 16x16 grid owns rows 4ty..4ty+3, keys tx+16j of each
// score tile, and the 4-wide column strips 64c+4tx of acc.  Per tile:
//   1. K and V are staged in dynamic shared memory in the input dtype (an fp32
//      hd-256 tile is 64 KB; Q, scaled, in fp32, is another 64 KB), rows past
//      the last visible key zero-filled;
//   2. the 64x64 score tile from 4-wide vector reads of Q and K rows (rows
//      padded by 4 elements so 16 different K rows hit different banks);
//   3. the online-softmax update, with row max and row sum reduced over the
//      16 threads of a row by warp shuffles; p goes to shared memory;
//   4. acc += p v from broadcast reads of p and contiguous reads of V.
// The key loop ends at the last key any row of the block may see (kv_len, or
// q_offset + last row when causal).  That skips every tile the reference's
// `run` predicate skips, and also the fully masked keys of the tiles it runs:
// in the reference's update such keys add exactly 0 (p = 0, and the running
// max, hence corr = 1, is unchanged), so the result is the same.  Blocks are
// issued longest causal rows first.  bq/bk of the wrapper keep the
// reference's meaning as the padding multiples; the CTA tile is this file's.
#include "common.cuh"

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BKV = 64;        // keys per shared-memory tile
constexpr int kThreads = 256;  // a 16 x 16 grid of (ty, tx)
constexpr int PAD = 4;         // elements of padding per Q / K row in shared memory
constexpr int PS = BQ + 4;     // row stride of the p tile, in floats
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&f)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}
__device__ __forceinline__ void load4(const __half* p, float (&f)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&v.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&v.y));
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float (&f)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&f)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(f[0], f[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(f[2], f[3]);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const unsigned*>(&a),
                                            *reinterpret_cast<const unsigned*>(&b));
}
__device__ __forceinline__ void store4(__half* p, const float (&f)[4]) {
  const __half2 a = __floats2half2_rn(f[0], f[1]);
  const __half2 b = __floats2half2_rn(f[2], f[3]);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const unsigned*>(&a),
                                            *reinterpret_cast<const unsigned*>(&b));
}

// Reduce over the 16 threads that share a row (one half of a warp).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Rows [row0, row0 + BKV) of a (rows, HD) matrix into shared memory with a
// row stride of `ld` elements, by 16-byte loads; rows >= `end` become zeros.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src, int row0, int end) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = HD / kVec;
  for (int i = threadIdx.x; i < BKV * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < end) v = *reinterpret_cast<const uint4*>(src + static_cast<long long>(row0 + r) * HD + c);
    uint2* d = reinterpret_cast<uint2*>(dst + r * ld + c);  // rows of K are only 8-byte aligned
    d[0] = make_uint2(v.x, v.y);
    d[1] = make_uint2(v.z, v.w);
  }
}

template <typename T, int HD>
constexpr size_t smem_bytes() {
  return BQ * (HD + PAD) * sizeof(float) + BKV * (HD + PAD) * sizeof(T) + BKV * HD * sizeof(T) +
         BKV * PS * sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int sq, int skv, int kv_len, int q_offset, int causal,
             float scale) {
  constexpr int QS = HD + PAD, KS = HD + PAD;
  constexpr int NC = HD / 64;  // 4-wide column strips of acc per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);   // [BQ][QS], fp32, scaled
  T* Ks = reinterpret_cast<T*>(Qs + BQ * QS);   // [BKV][KS]
  T* Vs = Ks + BKV * KS;                        // [BKV][HD]
  float* Ps = reinterpret_cast<float*>(Vs + BKV * HD);  // [BKV][PS], p transposed

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest causal rows first
  const long long bh = blockIdx.y;
  const T* qb = q + bh * sq * HD;
  const T* kb = k + bh * skv * HD;
  const T* vb = v + bh * skv * HD;
  T* ob = o + bh * sq * HD;

  const int q_last = min(q0 + BQ, sq) - 1;
  const int kv_hi = causal ? min(kv_len, q_offset + q_last + 1) : kv_len;

  for (int i = threadIdx.x; i < BQ * (HD / 4); i += kThreads) {
    const int r = i / (HD / 4), c = (i % (HD / 4)) * 4;
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    if (q0 + r < sq) {
      load4(qb + static_cast<long long>(q0 + r) * HD + c, f);
#pragma unroll
      for (int t = 0; t < 4; ++t) f[t] *= scale;
    }
    store4(Qs + r * QS + c, f);
  }

  float m[4], l[4], acc[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
  }

  for (int kv0 = 0; kv0 < kv_hi; kv0 += BKV) {
    __syncthreads();  // Q is in place; the last tile's K, V and p are read
    load_tile<T, HD>(Ks, KS, kb, kv0, kv_hi);
    load_tile<T, HD>(Vs, HD, vb, kv0, kv_hi);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float qv[4][4], kv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load4(Qs + (ty * 4 + i) * QS + d, qv[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) load4(Ks + (tx + 16 * j) * KS + d, kv[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int t = 0; t < 4; ++t) s[i][j] = fmaf(qv[i][t], kv[j][t], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + ty * 4 + i;
      bool valid[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kidx = kv0 + tx + 16 * j;
        valid[j] = kidx < kv_len && (!causal || kidx <= qpos);
        if (!valid[j]) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = valid[j] ? expf(s[i][j] - m_new) : 0.f;  // s now holds p
        rs += s[i][j];
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p[4] = {s[0][j], s[1][j], s[2][j], s[3][j]};
      store4(Ps + (tx + 16 * j) * PS + ty * 4, p);
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BKV; ++kk) {
      float p[4];
      load4(Ps + kk * PS + ty * 4, p);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float vv[4];
        load4(Vs + kk * HD + c * 64 + tx * 4, vv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int t = 0; t < 4; ++t) acc[i][c * 4 + t] = fmaf(p[i], vv[t], acc[i][c * 4 + t]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float f[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) f[t] = acc[i][c * 4 + t] / denom;
      store4(ob + static_cast<long long>(row) * HD + c * 64 + tx * 4, f);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int sq, int skv,
           int kv_len, int q_offset, int causal, float scale, cudaStream_t s) {
  constexpr size_t bytes = smem_bytes<T, HD>();
  static_assert(bytes <= 232448, "tile does not fit one block's shared memory");
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + BQ - 1) / BQ, bh);
  flash_kernel<T, HD><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, skv, kv_len, q_offset, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* o, int bh, int sq,
              int skv, int kv_len, int q_offset, int causal, float scale, cudaStream_t s) {
  switch (hd) {
    case 64: return launch<T, 64>(q, k, v, o, bh, sq, skv, kv_len, q_offset, causal, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, bh, sq, skv, kv_len, q_offset, causal, scale, s);
    case 256: return launch<T, 256>(q, k, v, o, bh, sq, skv, kv_len, q_offset, causal, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int repro_flash_attention(int dtype, int hd, const void* q, const void* k,
                                     const void* v, void* o, int bh, int sq, int skv, int kv_len,
                                     int q_offset, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_hd<float>(hd, q, k, v, o, bh, sq, skv, kv_len, q_offset, causal, scale, s);
    case kBF16:
      return launch_hd<__nv_bfloat16>(hd, q, k, v, o, bh, sq, skv, kv_len, q_offset, causal, scale, s);
    case kF16: return launch_hd<__half>(hd, q, k, v, o, bh, sq, skv, kv_len, q_offset, causal, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
