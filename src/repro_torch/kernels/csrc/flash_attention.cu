// flash_attention: out = softmax(mask(q k^T * hd^-0.5)) v, out in q's dtype.
//
// Replaces src/repro/kernels/flash_attention.py::_flash_kernel (flash_attention_pallas).
//
// Bound on the H100: causal attention does about 2*B*H*Sq*Skv*hd FLOPs (half
// of the two full products).  At the LMs' shapes that is 250-450 FLOPs per
// byte of q, k, v and out with grouped KV heads read once, around the bf16
// ridge of the tensor cores (989 TFLOP/s against 3.35 TB/s, 295 FLOPs per
// byte): the floor is the tensor cores' at gemma-2b's shape and HBM's at
// zamba2-7b's, and a kernel off the tensor cores is bound by the FP32 pipes
// at 15x either.
//
// Numerics are the reference's: scores are fp32 and scaled by hd^-0.5 in
// fp32; scores of invalid keys (k >= kv_len, or k > q_offset + q when
// causal) take no part in the max and their p is 0; m, l and acc are fp32 and
// the output is acc / max(l, 1e-30).  The 16-bit kernel rounds p to the input
// type for the second product, as the tensor cores take it.
//
// Two kernels, one per element type class:
//
// * bf16 / fp16 (`tma_kernel`, the model's path): tensor cores and the TMA.
//   One block of two warpgroups (256 threads) owns 128 query rows of one
//   (batch, query head), 64 rows a warpgroup.
//   - Q is loaded once and K/V tiles flow through a ring of two stages, each
//     a TMA load (cp.async.bulk.tensor) of 64-column boxes with 128-byte
//     swizzle.  A "full" mbarrier per stage counts the bytes in; an "empty"
//     mbarrier per stage counts the 256 threads out.  The block's first
//     thread issues the loads and refills a stage as soon as both warpgroups
//     have released it, so tile t+2 loads while tile t+1 is computed.  (A
//     producer warpgroup beside the two would make 384 threads, for which
//     ptxas allocates at most 168 registers a thread whatever setmaxnreg
//     gives: at hd 256 that spills the O accumulator and serialises the
//     wgmmas, and at hd 112 it was no faster on the card.)
//   - The tensor maps read the model layout, q/out (B, Sq, H, hd) and k/v
//     (B, Skv, Hkv, hd), with the strides the wrapper passes: query head h
//     reads KV head h / (H / Hkv), as jnp.repeat's order, so grouped KV
//     heads are never expanded, and rows past S and columns past hd arrive
//     as zeros, so nothing is padded in memory.  A head width whose row
//     pitch is not a multiple of 16 bytes (the TMA's stride unit) is
//     zero-padded by the wrapper.
//   - S = Q K^T: wgmma m64nBKVk16 over ceil(hd/16) k-steps, A (Q) and B (K)
//     K-major from shared memory.  The online softmax runs on the fp32
//     accumulator in registers, the row max over the 4 threads of a quad.
//     O += P V: P is rounded to the input type in registers and fed to wgmma
//     as A from registers (the accumulator's layout is the A fragment's);
//     V is B, MN-major (transpose bit), n = the instance's head width.  The
//     two warpgroups interleave, one's softmax running beside the other's
//     products.
//   - Instances: hd <= 64 at 64, 112 at 112 (7 k-steps, n 112), <= 128 at
//     128, key tiles of 128; <= 256 at 256 with key tiles of 64, where the
//     64 x 256 fp32 O accumulator alone takes 128 registers a thread.
//   - Stores are row-masked at Sq and column-masked at hd.
//   - The tensor maps are encoded on the host with cuTensorMapEncodeTiled,
//     reached through cudaGetDriverEntryPoint so that the library links with
//     plain nvcc and no -lcuda, and passed as __grid_constant__ parameters.
//
// * fp32 (`simt_kernel`): no tensor-core route keeps fp32's 1e-4 (TF32 would
//   not), so this stays on the FP32 pipes over the head-flattened layout
//   (BH, S, hd) at hd 64/128/256 (the wrapper zero-pads other widths).  One
//   block of 256 threads owns 64 query rows and loops over 64-key tiles
//   staged in shared memory; thread (ty, tx) of a 16x16 grid owns rows
//   4ty..4ty+3, keys tx+16j of each score tile and 4-wide column strips of
//   acc; p goes through shared memory to the second product.
//
// Both kernels end each block's key loop at the last key any of its rows may
// see (kv_len, or q_offset + last row when causal): that skips every tile the
// reference's `run` predicate skips, and the fully masked keys of the tiles it
// runs add exactly 0 there (p = 0, the running max unchanged).  Blocks are
// issued longest causal rows first.
#include <cuda.h>

#include <cmath>
#include <cstdio>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the reference's mask value and the initial max
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bf16 / fp16: wgmma + TMA
// ---------------------------------------------------------------------------
constexpr int kConsumerWGs = 2;
constexpr int kBQ = 64 * kConsumerWGs;                 // query rows per block
constexpr int kTmaThreads = 128 * kConsumerWGs;        // threads per block
constexpr int kStages = 2;
constexpr int kBox = 64;                               // columns per TMA box: 128 bytes

template <int HDP, int BKV>
struct TmaLayout {
  static constexpr int kQBytes = kBQ * HDP * 2;
  static constexpr int kTileBytes = BKV * HDP * 2;     // one K or one V tile
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kTileBytes;
  static constexpr int kBytes = 1024 + kBarOffset + 64;  // 1024: room to align the base
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Waits for the phase after `parity` to complete.  A wait that outlasts any
// real one (a lost transaction) traps, so a fault shows as an error, not a hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (long long spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins > (1LL << 26)) __trap();
  }
}
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap& map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: 8-row groups
// 1024 bytes apart (SBO); `lbo` (bytes) is the stride between 64-column boxes
// for an MN-major operand and unused (1) for a K-major one.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// HDP: the head width in shared memory (a multiple of the 64-column box);
// KSTEPS: k16 steps of Q K^T (ceil(hd / 16)); NV: n of P V; BKV: keys per tile.
template <typename T, int HDP, int KSTEPS, int NV, int BKV>
__global__ void __launch_bounds__(kTmaThreads, 1)
tma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv, T* __restrict__ o, long long o_ss,
           long long o_sh, long long o_sb, int sq, int hd, int group, int kv_len, int q_offset,
           int causal, float scale) {
  using L = TmaLayout<HDP, BKV>;
  constexpr int kBoxes = HDP / kBox;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t s_q = smem_u32(smem);
  const uint32_t s_kv = s_q + L::kQBytes;  // stage s: K at + 2s tiles, V at + (2s+1) tiles
  const uint32_t bar = s_q + L::kBarOffset;
  const uint32_t q_full = bar;             // then full[kStages], empty[kStages]
  auto full = [&](int s) { return bar + 8 + 8 * s; };
  auto empty = [&](int s) { return bar + 8 + 8 * kStages + 8 * s; };

  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // longest causal rows first
  const int q_end = min(q0 + kBQ, sq);
  const int kv_hi = causal ? min(kv_len, q_offset + q_end) : kv_len;
  const int n_tiles = kv_hi > 0 ? (kv_hi + BKV - 1) / BKV : 0;

  auto load_q = [&]() {
    mbar_expect_tx(q_full, L::kQBytes);
    for (int c = 0; c < kBoxes; ++c)
      tma_load_4d(s_q + c * kBQ * 128, tq, c * kBox, h, q0, b, q_full);
  };
  auto load_kv = [&](int t) {  // key tile t into stage t % kStages, once it is empty
    const int s = t % kStages;
    if (t >= kStages) mbar_wait(empty(s), ((t / kStages) - 1) & 1);
    const uint32_t k_dst = s_kv + 2 * s * L::kTileBytes, v_dst = k_dst + L::kTileBytes;
    mbar_expect_tx(full(s), 2 * L::kTileBytes);
    for (int c = 0; c < kBoxes; ++c) {
      tma_load_4d(k_dst + c * BKV * 128, tk, c * kBox, hk, t * BKV, b, full(s));
      tma_load_4d(v_dst + c * BKV * 128, tv, c * kBox, hk, t * BKV, b, full(s));
    }
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kTmaThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x == 0) {  // the loads: Q, then the first tiles of the ring
    load_q();
    for (int t = 0; t < min(kStages, n_tiles); ++t) load_kv(t);
  }
  __syncwarp();  // the warp reconverges before its next warpgroup-wide instruction
  // consumer warpgroup `wg`: rows q0 + 64 wg + [0, 64)
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8
  const int wg_first = q0 + 64 * wg;
  const int wg_hi = causal ? min(kv_len, q_offset + min(wg_first + 64, sq)) : kv_len;
  const float sl2 = scale * kLog2e;

  float acc[NV / 2];
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this thread's share of the row sum
  const uint32_t q_wg = s_q + 64 * wg * 128;

  mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const int kv0 = t * BKV;
    mbar_wait(full(s), (t / kStages) & 1);
    if (kv0 < wg_hi) {
      const uint32_t k_s = s_kv + 2 * s * L::kTileBytes, v_s = k_s + L::kTileBytes;
      float sc[BKV / 2];
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) reg_fence(sc[i]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 columns into the 128-byte swizzle atom
        const uint64_t da = sw128_desc(q_wg + (kk / 4) * kBQ * 128 + off, 16);
        const uint64_t db = sw128_desc(k_s + (kk / 4) * BKV * 128 + off, 16);
        WgmmaSS<BKV, T>::mma(sc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) reg_fence(sc[i]);

      // mask: only a tile that crosses kv_len or this warpgroup's diagonal
      const bool edge = kv0 + BKV > kv_len || (causal && kv0 + BKV - 1 > q_offset + wg_first);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e / 2, key = kv0 + 8 * j + 2 * (lane % 4) + (e % 2);
          float& x = sc[4 * j + e];
          if (edge && (key >= kv_len || (causal && key > q_offset + row0 + 8 * r)))
            x = -INFINITY;
          mx[r] = fmaxf(mx[r], x);
        }
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = exp2f((m[r] - mx[r]) * sl2);
        m[r] = mx[r];
        l[r] *= corr[r];
      }
      uint32_t pa[BKV / 16][4];
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = exp2f((sc[4 * j + e] - m[e / 2]) * sl2);  // masked: exp2(-inf) = 0
          l[e / 2] += p[e];
        }
        // the accumulator's (row, key) layout is the m64k16 A fragment's
        pa[j / 2][(j % 2) * 2 + 0] = pack2<T>(p[0], p[1]);
        pa[j / 2][(j % 2) * 2 + 1] = pack2<T>(p[2], p[3]);
      }
#pragma unroll
      for (int i = 0; i < NV / 2; ++i) {
        acc[i] *= corr[(i % 4) / 2];
        reg_fence(acc[i]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        const uint64_t db = sw128_desc(v_s + kk * 16 * 128, BKV * 128);
        WgmmaRS<NV, T>::mma(acc, pa[kk], db, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < NV / 2; ++i) reg_fence(acc[i]);
    }
    mbar_arrive(empty(s));
    // the first thread refills the stage once both warpgroups released it
    if (threadIdx.x == 0 && t + kStages < n_tiles) load_kv(t + kStages);
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  T* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int j = 0; j < NV / 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < sq && col < hd)
        *reinterpret_cast<uint32_t*>(ob + row * o_ss + col) =
            pack2<T>(acc[4 * j + 2 * r] * l[r], acc[4 * j + 2 * r + 1] * l[r]);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over (hd, heads, rows, batch), innermost first, with the caller's
// byte strides of heads, rows and batch; boxes of 64 columns x `rows` rows.
bool encode(CUtensorMap* map, int dtype, const void* ptr, const unsigned long long* dims,
            const unsigned long long* strides, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) {
    fprintf(stderr, "flash_attention: cuTensorMapEncodeTiled is not available\n");
    return false;
  }
  const cuuint64_t gdim[4] = {dims[0], dims[1], dims[2], dims[3]};
  const cuuint64_t gstride[3] = {strides[0], strides[1], strides[2]};
  const cuuint32_t box[4] = {kBox, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, dtype == kBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                            : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                        4, const_cast<void*>(ptr), gdim, gstride, box, estride,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    fprintf(stderr, "flash_attention: cuTensorMapEncodeTiled failed with CUresult %d\n",
            static_cast<int>(r));
    return false;
  }
  return true;
}

struct TmaArgs {
  int dtype;
  const void *q, *k, *v;
  void* o;
  const unsigned long long *q_dims, *q_strides, *kv_dims, *k_strides, *v_strides;
  long long o_ss, o_sh, o_sb;
  int kv_len, q_offset, causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, int HDP, int KSTEPS, int NV, int BKV>
int launch_tma(const TmaArgs& a) {
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, a.dtype, a.q, a.q_dims, a.q_strides, kBQ) ||
      !encode(&tk, a.dtype, a.k, a.kv_dims, a.k_strides, BKV) ||
      !encode(&tv, a.dtype, a.v, a.kv_dims, a.v_strides, BKV))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int bytes = TmaLayout<HDP, BKV>::kBytes;
  static_assert(bytes <= 232448, "tiles do not fit one block's shared memory");
  auto kernel = tma_kernel<T, HDP, KSTEPS, NV, BKV>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int hd = static_cast<int>(a.q_dims[0]), h = static_cast<int>(a.q_dims[1]);
  const int sq = static_cast<int>(a.q_dims[2]), b = static_cast<int>(a.q_dims[3]);
  const int hkv = static_cast<int>(a.kv_dims[1]);
  const dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  kernel<<<grid, kTmaThreads, bytes, a.stream>>>(tq, tk, tv, static_cast<T*>(a.o), a.o_ss, a.o_sh,
                                                a.o_sb, sq, hd, h / hkv, a.kv_len, a.q_offset,
                                                a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tma_hd(const TmaArgs& a) {
  const unsigned long long hd = a.q_dims[0];
  if (hd <= 64) return launch_tma<T, 64, 4, 64, 128>(a);
  if (hd == 112) return launch_tma<T, 128, 7, 112, 128>(a);
  if (hd <= 128) return launch_tma<T, 128, 8, 128, 128>(a);
  if (hd <= 256) return launch_tma<T, 256, 16, 256, 64>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// fp32: the FP32 pipes, head-flattened layout
// ---------------------------------------------------------------------------
constexpr int BQ = 64;         // query rows per block
constexpr int BKV = 64;        // keys per shared-memory tile
constexpr int kThreads = 256;  // a 16 x 16 grid of (ty, tx)
constexpr int PAD = 4;         // elements of padding per Q / K row in shared memory
constexpr int PS = BQ + 4;     // row stride of the p tile, in floats

__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void store4(float* p, const float (&f)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
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
// row stride of `ld` floats, by 16-byte loads; rows >= `end` become zeros.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src, int row0, int end) {
  constexpr int kPerRow = HD / 4;
  for (int i = threadIdx.x; i < BKV * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < end) v = *reinterpret_cast<const float4*>(src + static_cast<long long>(row0 + r) * HD + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = v;
  }
}

template <int HD>
constexpr size_t simt_smem_bytes() {
  return (BQ * (HD + PAD) + BKV * (HD + PAD) + BKV * HD + BKV * PS) * sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
simt_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
            float* __restrict__ o, int sq, int skv, int kv_len, int q_offset, int causal,
            float scale) {
  constexpr int QS = HD + PAD, KS = HD + PAD;
  constexpr int NC = HD / 64;  // 4-wide column strips of acc per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [BQ][QS], scaled
  float* Ks = Qs + BQ * QS;                    // [BKV][KS]
  float* Vs = Ks + BKV * KS;                   // [BKV][HD]
  float* Ps = Vs + BKV * HD;                   // [BKV][PS], p transposed

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest causal rows first
  const long long bh = blockIdx.y;
  const float* qb = q + bh * sq * HD;
  const float* kb = k + bh * skv * HD;
  const float* vb = v + bh * skv * HD;
  float* ob = o + bh * sq * HD;

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
    load_tile<HD>(Ks, KS, kb, kv0, kv_hi);
    load_tile<HD>(Vs, HD, vb, kv0, kv_hi);
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

template <int HD>
int launch_simt(const void* q, const void* k, const void* v, void* o, int bh, int sq, int skv,
                int kv_len, int q_offset, int causal, float scale, cudaStream_t s) {
  constexpr size_t bytes = simt_smem_bytes<HD>();
  static_assert(bytes <= 232448, "tile does not fit one block's shared memory");
  cudaError_t err = cudaFuncSetAttribute(simt_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + BQ - 1) / BQ, bh);
  simt_kernel<HD><<<grid, kThreads, bytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), sq, skv, kv_len, q_offset, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// fp32, head-flattened (BH, S, hd) at hd 64, 128 or 256.
extern "C" int repro_flash_attention(int dtype, int hd, const void* q, const void* k,
                                     const void* v, void* o, int bh, int sq, int skv, int kv_len,
                                     int q_offset, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != kF32) return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 64: return launch_simt<64>(q, k, v, o, bh, sq, skv, kv_len, q_offset, causal, scale, s);
    case 128: return launch_simt<128>(q, k, v, o, bh, sq, skv, kv_len, q_offset, causal, scale, s);
    case 256: return launch_simt<256>(q, k, v, o, bh, sq, skv, kv_len, q_offset, causal, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// bf16 / fp16 in the model layout.  q_dims = (hd, H, Sq, B) and kv_dims =
// (hd, Hkv, Skv, B), innermost first; *_strides are the byte strides of the
// head, row and batch axes (multiples of 16); out has q's shape with element
// strides o_ss (row), o_sh (head), o_sb (batch).
extern "C" int repro_flash_attention_tma(int dtype, const void* q, const void* k, const void* v,
                                         void* o, const unsigned long long* q_dims,
                                         const unsigned long long* q_strides,
                                         const unsigned long long* kv_dims,
                                         const unsigned long long* k_strides,
                                         const unsigned long long* v_strides, long long o_ss,
                                         long long o_sh, long long o_sb, int kv_len, int q_offset,
                                         int causal, float scale, void* stream) {
  const TmaArgs a{dtype, q, k, v, o, q_dims, q_strides, kv_dims, k_strides, v_strides,
                  o_ss, o_sh, o_sb, kv_len, q_offset, causal, scale,
                  static_cast<cudaStream_t>(stream)};
  if (q_dims[0] != kv_dims[0] || q_dims[3] != kv_dims[3] || kv_dims[1] == 0 ||
      q_dims[1] % kv_dims[1] != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case kBF16: return launch_tma_hd<__nv_bfloat16>(a);
    case kF16: return launch_tma_hd<__half>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
