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
// causal tiles are ~22.6 GFLOP: 0.023 ms at the bf16 tensor-core rate, 0.34
// ms on the FP32 pipes.
//
// Two routes, chosen by the wrapper (kernels/ssm_scan.py::tc_route):
//
// * bf16 / fp16 with P and N multiples of 16 up to 128, at any L (the
//   models' path): the state-passing form of SSD (Dao & Gu, arXiv:2405.21060,
//   section 6) on wgmma and the TMA.  The sequential walk over the chunks
//   becomes two parallel passes around one short sequential one, three
//   launches from one entry point (repro_ssm_scan_tc; each pass also has its
//   own, for the card tests):
//   1. Chunk states (ssd_states_kernel), one block per (batch, head, chunk)
//      with one warpgroup per 64 columns of P: a block scan of a_log gives
//      acum, written to an fp32 (B*H, S) scratch; then
//      S_c = u^T (sdecay B) over the chunk's 64-step tiles, u (A) and the
//      scaled B (B) both MN-major from shared memory (WgmmaSStt), into an fp32
//      (B, H, chunks, P, N) scratch.
//   2. State passing (ssd_pass_kernel): h_0 = 0, h_{c+1} = h_c exp(atot_c)
//      + S_c in place, one float4 of the state a thread, so the scratch holds
//      the state entering each chunk.
//   3. Chunk outputs (ssd_out_kernel), one warpgroup per (batch, head, chunk,
//      64-row tile i): acc = exp(acum_t) (C_i h_c^T) (C_i and h K-major,
//      WgmmaSS<P>), then for each key tile j <= i the score tile C_i B_j^T
//      (WgmmaSS<64>), masked in registers by the causal mask and
//      exp(clip(acum_t - acum_s)) into W, and acc += W u_j with W from
//      registers and u_j MN-major (WgmmaRS<P>, as flash computes P V).
//   Tiles of u, B and C come in by TMA (4-D map over u's (P, H, S, B), 3-D
//   over B's and C's (N, S, B); boxes of 64 steps x 64 columns, 128-byte
//   swizzle) through a two-stage mbarrier ring that the block's first thread
//   refills.  Columns past P or N, and steps past S, arrive as zeros (P and N
//   run at instances of 64 or 128); steps past the chunk's end are masked
//   (sdecay 0 in pass 1, W 0 in pass 3) and their rows not stored, so every L
//   runs.  Blocks: at zamba2-7b's shape 1,792 + 1,792 + 7,168 (chunk 256)
//   where the SIMT kernel had 448.
//   Precision: W, sdecay B and h are fp32 values; each enters its product as
//   a hi + lo pair of the input type (hi = T(v), lo = T(v - hi)), two wgmmas,
//   so it keeps ~16 bits.  One rounding of W to bf16 is coherent across a
//   row whose diagonal term dominates y_t, and one of h across the first
//   rows of a chunk; either alone took a row's ||err|| / ||y|| to about twice
//   y's own rounding (tools/ssd_rounding.py), past chip_smoke's limit.  TF32
//   would need u K-major (wgmma transposes only 16-bit operands), so the
//   split is the cheaper fix: it doubles the W u and state products, not the
//   score tile.
//   Bytes of this design at zamba2-7b's shape: the bound's 120 MB plus the
//   fp32 chunk states (29.4 MB at L 256, 14.7 MB at 512) written by pass 1,
//   read and written by pass 2 and read by pass 3, and acum (1.8 MB)
//   written once and read twice: ~242 MB at L 256 (0.072 ms at 3.35 TB/s),
//   ~183 MB at 512 (0.055 ms).
//
// * fp32, and P or N past 128 or not a multiple of 16 (ssd_kernel): the FP32
//   pipes.  No tensor-core route keeps fp32's 1e-4, and wgmma takes widths
//   in steps of 16 bytes; this is how flash keeps SIMT for fp32 and past hd
//   256.  The TPU kernel walks the chunks as a sequential grid axis and keeps
//   h in VMEM scratch.  Here one block of 256 threads owns one (batch, head,
//   slice of up to 128 columns of P) and loops over the chunks itself, with
//   its slice of h (fp32) in shared memory: the columns of P never mix (y[:, p]
//   and h[p, :] read only u[:, p]), so P > 128 splits over the grid.  N is
//   summed over (C.B^T, C.h) but its slabs never mix either: y is the sum over
//   slabs of 128 of N of the scan run with B, C and h cut to the slab.  So the
//   block runs the whole scan once per slab, and with more than one slab adds
//   y into an fp32 scratch the wrapper allocates, casting to u's dtype after
//   the last.  The chunk's acum is a block scan in segments of 256 with a
//   carry, into shared memory, or into a global scratch when a very long
//   chunk leaves it no room.  The (L x L) score matrix does not fit (256 KB
//   at L 256), so y is computed in 64-row tiles: for row tile i, C_i is
//   staged in shared memory and the carried state's term C_i h^T starts the
//   accumulator; then each key tile j <= i (the tiles above the diagonal are
//   skipped) stages B_j and u_j, forms the 64 x 64 decay-masked score tile W,
//   and adds W u_j.  Only after every row tile of the chunk has read the old
//   h does the state update re-stage B_j and the decayed u_j, tile by tile,
//   into per-thread sums of h.  Tiles are zero-filled past the chunk's end
//   and past P or N, so every L and P, N <= 128 run the same code;
//   K = ceil(min(max(P, N), 128) / 16), rounded up to a power of two, picks
//   the template.  Thread (ty, tx) of a 16 x 16 grid owns rows 4ty..4ty+3 of
//   a tile, keys tx + 16j of a score tile, columns tx + 16k of y, and
//   h[ty + 16a][tx + 16b].
#include <cuda.h>

#include <cstdio>

#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr float kClipLo = -60.f;

__device__ __forceinline__ float clip_exp(float x) {
  return expf(fminf(fmaxf(x, kClipLo), 0.f));
}

// ---------------------------------------------------------------------------
// bf16 / fp16: the state-passing SSD on wgmma + TMA
// ---------------------------------------------------------------------------
constexpr int kTR = 64;            // steps a tile: the rows of a TMA box
constexpr int kBox = kTR * 128;    // one box: 64 rows of 64 16-bit columns (128 bytes), swizzled
constexpr int kStages = 2;
constexpr int kPassThreads = 256;  // pass 2: one float4 of a (P, N) state a thread

__device__ __forceinline__ uint32_t bits16(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }
__device__ __forceinline__ uint32_t bits16(__half v) { return __half_as_ushort(v); }
template <typename T> __device__ __forceinline__ T from_bits16(unsigned short v);
template <> __device__ __forceinline__ __nv_bfloat16 from_bits16<__nv_bfloat16>(unsigned short v) {
  return __ushort_as_bfloat16(v);
}
template <> __device__ __forceinline__ __half from_bits16<__half>(unsigned short v) {
  return __ushort_as_half(v);
}

// v as hi + lo, each of type T (hi = T(v), lo = T(v - hi)), returned as their bits.
template <typename T>
__device__ __forceinline__ void split16(float v, uint32_t& hi, uint32_t& lo) {
  const T h = from_f32<T>(v);
  hi = bits16(h);
  lo = bits16(from_f32<T>(v - to_f32(h)));
}

// Two 32-bit words of two T each, every value times f, as hi (in place) and lo parts.
template <typename T>
__device__ __forceinline__ void scale_split(uint32_t& w, uint32_t& lo, float f) {
  uint32_t h0, l0, h1, l1;
  split16<T>(to_f32(from_bits16<T>(w & 0xFFFFu)) * f, h0, l0);
  split16<T>(to_f32(from_bits16<T>(w >> 16)) * f, h1, l1);
  w = h0 | (h1 << 16);
  lo = l0 | (l1 << 16);
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~static_cast<uintptr_t>(1023));
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Generic-proxy writes to shared memory made visible to wgmma (the async proxy).
__device__ __forceinline__ void fence_to_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// acum[t] = a[0] + ... + a[t] for t < n_out (n_out >= L), a read with a stride
// of `lda` and 0 from L on, so the entries from L on hold the sum of all L: a
// block scan blockDim.x steps at a time with the sum so far carried.
__device__ void chunk_cumsum(const float* a, long long lda, float* acum, int L, int n_out) {
  __shared__ float warp_tot[32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  float carry = 0.f;
  for (int base = 0; base < n_out; base += blockDim.x) {
    float v = base + tid < L ? a[(base + tid) * lda] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float n = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += n;
    }
    if (lane == 31) warp_tot[warp] = v;
    __syncthreads();
    for (int w = 0; w < warp; ++w) v += warp_tot[w];
    if (base + tid < n_out) acum[base + tid] = v + carry;
    for (int w = 0; w < nwarps; ++w) carry += warp_tot[w];
    __syncthreads();  // warp_tot is read before the next segment writes it
  }
}

// Pass 1, chunk states: one block per (batch, head, chunk), one warpgroup per
// 64 columns of P (PW = P padded to 64 or 128, NW = N likewise).  acum goes to
// its (B*H, S) scratch; states[bh, c] = (u)^T (sdecay B) over the chunk, from
// the 64-step tiles of u and B that a two-stage TMA ring brings in.
template <typename T, int PW, int NW>
__global__ void __launch_bounds__(2 * PW)
ssd_states_kernel(const __grid_constant__ CUtensorMap tu, const __grid_constant__ CUtensorMap tb,
                  const float* __restrict__ a, float* __restrict__ states, float* acum, int S,
                  int H, int P, int N, int L) {
  constexpr int MT = PW / 64, NB = NW / 64, kThreadsS = 128 * MT;
  constexpr int kStage = (MT + NB) * kBox;  // u's boxes, then B's
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t s_stage = smem_u32(smem);
  unsigned char* blo = smem + kStages * kStage;  // B's lo part, NB boxes
  float* sd = reinterpret_cast<float*>(blo + NB * kBox);  // sdecay of the tile's 64 steps
  const uint32_t bar = smem_u32(sd + kTR);
  auto full = [&](int s) { return bar + 8 * s; };

  const int nc = S / L, c = blockIdx.x % nc, bh = blockIdx.x / nc;
  const int b = bh / H, h = bh % H, t0 = c * L;
  const int tid = threadIdx.x, ntiles = (L + kTR - 1) / kTR;
  // written here and read back, so never through the non-coherent path
  float* acum_c = acum + static_cast<long long>(bh) * S + t0;

  auto load = [&](int j) {  // tile j of u and B into stage j % kStages
    const int s = j % kStages;
    const uint32_t dst = s_stage + s * kStage;
    mbar_expect_tx(full(s), kStage);
    for (int m = 0; m < MT; ++m)
      tma_load_4d(dst + m * kBox, tu, 64 * m, h, t0 + kTR * j, b, full(s));
    for (int k = 0; k < NB; ++k)
      tma_load_3d(dst + (MT + k) * kBox, tb, 64 * k, t0 + kTR * j, b, full(s));
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(full(s), 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int j = 0; j < min(kStages, ntiles); ++j) load(j);

  chunk_cumsum(a + (static_cast<long long>(b) * S + t0) * H + h, H, acum_c, L, L);  // loads fly
  __syncthreads();
  const float atot = acum_c[L - 1];

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  float acc[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
  for (int j = 0; j < ntiles; ++j) {
    const int s = j % kStages;
    const uint32_t u_s = s_stage + s * kStage, b_s = u_s + MT * kBox;
    if (tid < kTR) sd[tid] = kTR * j + tid < L ? clip_exp(atot - acum_c[kTR * j + tid]) : 0.f;
    __syncthreads();
    mbar_wait(full(s), (j / kStages) & 1);
    // B's rows times sdecay, hi in place and lo into blo: the swizzle moves 16-byte
    // chunks within their 128-byte row, so a chunk's row is its offset in the box / 128
    uint4* bv = reinterpret_cast<uint4*>(smem + s * kStage + MT * kBox);
    uint4* lv = reinterpret_cast<uint4*>(blo);
    for (int q = tid; q < NB * kBox / 16; q += kThreadsS) {
      const float f = sd[(q % (kBox / 16)) / 8];
      uint4 x = bv[q], lo;
      scale_split<T>(x.x, lo.x, f);
      scale_split<T>(x.y, lo.y, f);
      scale_split<T>(x.z, lo.z, f);
      scale_split<T>(x.w, lo.w, f);
      bv[q] = x;
      lv[q] = lo;
    }
    fence_to_async();
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) reg_fence(acc[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTR / 16; ++kk) {  // 16 steps of the chunk a k-step
      const uint64_t da = sw128_desc(u_s + wg * kBox + kk * 16 * 128, kBox);
      WgmmaSStt<NW, T>::mma(acc, da, sw128_desc(b_s + kk * 16 * 128, kBox), 1);
      WgmmaSStt<NW, T>::mma(acc, da, sw128_desc(smem_u32(blo) + kk * 16 * 128, kBox), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) reg_fence(acc[i]);
    __syncthreads();  // stage s and blo are free
    if (tid == 0 && j + kStages < ntiles) load(j + kStages);
  }
  float* st = states + (static_cast<long long>(bh) * nc + c) * P * N;
  const int p0 = 64 * wg + 16 * warp + lane / 4;
#pragma unroll
  for (int jj = 0; jj < NW / 8; ++jj) {
    const int n = 8 * jj + 2 * (lane % 4);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = p0 + 8 * r;
      if (p < P && n < N)
        *reinterpret_cast<float2*>(st + p * N + n) =
            make_float2(acc[4 * jj + 2 * r], acc[4 * jj + 2 * r + 1]);
    }
  }
}

// Pass 2, state passing: the chunk states of one (batch, head) become the
// states entering each chunk, in place: h_0 = 0, h_{c+1} = h_c exp(atot_c) + S_c,
// one float4 of the (P, N) state a thread (pn4 = P * N / 4 of them).
__global__ void __launch_bounds__(kPassThreads)
ssd_pass_kernel(float4* states, const float* __restrict__ acum, int S, int L, int pn4) {
  const int per = (pn4 + kPassThreads - 1) / kPassThreads;
  const int bh = blockIdx.x / per, e = (blockIdx.x % per) * kPassThreads + threadIdx.x;
  if (e >= pn4) return;
  const int nc = S / L;
  float4* st = states + static_cast<long long>(bh) * nc * pn4 + e;
  const float* atot = acum + static_cast<long long>(bh) * S + L - 1;
  float4 h = make_float4(0.f, 0.f, 0.f, 0.f), next = st[0];
  for (int c = 0; c < nc; ++c) {
    const float4 sc = next;
    if (c + 1 < nc) next = st[static_cast<long long>(c + 1) * pn4];
    const float d = expf(atot[static_cast<long long>(c) * L]);
    st[static_cast<long long>(c) * pn4] = h;
    h = make_float4(__fadd_rn(__fmul_rn(h.x, d), sc.x), __fadd_rn(__fmul_rn(h.y, d), sc.y),
                    __fadd_rn(__fmul_rn(h.z, d), sc.z), __fadd_rn(__fmul_rn(h.w, d), sc.w));
  }
}

// Pass 3, chunk outputs: one warpgroup per (batch, head, chunk, 64-row tile i),
// the tiles of a chunk issued longest first.  acc = exp(acum_t) (C_i h_c^T),
// then for each key tile j <= i: the score tile C_i B_j^T, decay-masked in
// registers into W, and acc += W u_j with W from registers.  h_c's hi and lo
// parts lie in the last bytes of the stage ring (42 KB a block in all at
// P = N = 64, so 4 blocks share an SM): a stage under them is loaded once the
// entering state's product is done.
template <typename T, int PW, int NW>
__global__ void __launch_bounds__(128)
ssd_out_kernel(const __grid_constant__ CUtensorMap tu, const __grid_constant__ CUtensorMap tb,
               const __grid_constant__ CUtensorMap tc, T* __restrict__ y,
               const float* __restrict__ states, const float* __restrict__ acum, int S, int H,
               int P, int N, int L) {
  constexpr int MT = PW / 64, NB = NW / 64;
  constexpr int kHBytes = NB * PW * 128;  // h_c as [p][n], K-major: NB boxes of PW rows
  constexpr int kStage = (NB + MT) * kBox;  // B_j's boxes, then u_j's
  constexpr int kRing = kStages * kStage;
  static_assert(2 * kHBytes <= kRing, "h_c's two parts do not fit in the stage ring");
  constexpr int kFree = (kRing - 2 * kHBytes) / kStage;  // stages clear of h_c
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t c_s = smem_u32(smem);  // C_i: NB boxes
  const uint32_t stg = c_s + NB * kBox;
  const uint32_t h_hi = stg + kRing - 2 * kHBytes, h_lo = h_hi + kHBytes;
  const uint32_t bar = stg + kRing;  // c_full, then full[kStages]
  auto full = [&](int s) { return bar + 8 + 8 * s; };

  const int ntr = (L + kTR - 1) / kTR, nc = S / L;
  const int i = ntr - 1 - static_cast<int>(blockIdx.x % ntr);
  const int c = (blockIdx.x / ntr) % nc, bh = blockIdx.x / ntr / nc;
  const int b = bh / H, h = bh % H, t0 = c * L, r0 = kTR * i;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float* acum_c = acum + static_cast<long long>(bh) * S + t0;

  auto load = [&](int j) {  // key tile j of B and u into stage j % kStages
    const int s = j % kStages;
    const uint32_t dst = stg + s * kStage;
    mbar_expect_tx(full(s), kStage);
    for (int k = 0; k < NB; ++k) tma_load_3d(dst + k * kBox, tb, 64 * k, t0 + kTR * j, b, full(s));
    for (int m = 0; m < MT; ++m)
      tma_load_4d(dst + (NB + m) * kBox, tu, 64 * m, h, t0 + kTR * j, b, full(s));
  };
  if (tid == 0) {
    mbar_init(bar, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(full(s), 1);
    fence_barrier_init();
  }
  __syncthreads();
  const int first = min(kStages, i + 1);  // the ring's first tiles
  const int early = c > 0 ? min(kFree, first) : first;  // those loaded before h_c's product
  if (tid == 0) {
    mbar_expect_tx(bar, NB * kBox);
    for (int k = 0; k < NB; ++k) tma_load_3d(c_s + k * kBox, tc, 64 * k, t0 + r0, b, bar);
    for (int j = 0; j < early; ++j) load(j);
  }
  __syncwarp();

  int trow[2];  // this thread's rows of the tile, in the chunk; rows past L are not stored
  float at[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    trow[r] = r0 + 16 * warp + lane / 4 + 8 * r;
    at[r] = acum_c[min(trow[r], L - 1)];
  }
  float acc[PW / 2];
#pragma unroll
  for (int k = 0; k < PW / 2; ++k) acc[k] = 0.f;
  if (c > 0) {  // the entering state's term; h is zero in the first chunk
    const float* hc = states + (static_cast<long long>(bh) * nc + c) * P * N;
    for (int q = tid; q < PW * NW / 4; q += 128) {
      const int p = q / (NW / 4), n = (q % (NW / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (p < P && n < N) v = *reinterpret_cast<const float4*>(hc + p * N + n);
      uint32_t hi[4], lo[4];
      split16<T>(v.x, hi[0], lo[0]);
      split16<T>(v.y, hi[1], lo[1]);
      split16<T>(v.z, hi[2], lo[2]);
      split16<T>(v.w, hi[3], lo[3]);
      // the TMA's 128-byte swizzle: 16-byte chunk k of row p at chunk k ^ (p % 8)
      const int col = n % 64;
      const uint32_t off =
          (n / 64) * PW * 128 + p * 128 + (((col / 8) ^ (p & 7)) << 4) + (col % 8) * 2;
      *reinterpret_cast<uint2*>(smem + (h_hi - c_s) + off) =
          make_uint2(hi[0] | (hi[1] << 16), hi[2] | (hi[3] << 16));
      *reinterpret_cast<uint2*>(smem + (h_lo - c_s) + off) =
          make_uint2(lo[0] | (lo[1] << 16), lo[2] | (lo[3] << 16));
    }
    fence_to_async();
    __syncthreads();
    mbar_wait(bar, 0);
#pragma unroll
    for (int k = 0; k < PW / 2; ++k) reg_fence(acc[k]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NW / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBox, hoff = (kk / 4) * PW * 128, sw = (kk % 4) * 32;
      const uint64_t da = sw128_desc(c_s + off + sw, 16);
      WgmmaSS<PW, T>::mma(acc, da, sw128_desc(h_hi + hoff + sw, 16), 1);
      WgmmaSS<PW, T>::mma(acc, da, sw128_desc(h_lo + hoff + sw, 16), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    __syncthreads();  // h_c is read: its bytes of the ring are free
    if (tid == 0)
      for (int j = early; j < first; ++j) load(j);
    __syncwarp();
    const float e[2] = {expf(at[0]), expf(at[1])};
#pragma unroll
    for (int k = 0; k < PW / 2; ++k) {
      reg_fence(acc[k]);
      acc[k] *= e[(k % 4) / 2];
    }
  } else {
    mbar_wait(bar, 0);
  }

  for (int j = 0; j <= i; ++j) {
    const int s = j % kStages;
    const uint32_t b_s = stg + s * kStage, u_s = b_s + NB * kBox;
    float as[16];  // acum of this thread's keys: 8 jj + 2 (lane % 4) + {0, 1} of the tile
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        as[2 * jj + e] = acum_c[min(kTR * j + 8 * jj + 2 * (lane % 4) + e, L - 1)];
    mbar_wait(full(s), (j / kStages) & 1);
    float sc[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) reg_fence(sc[k]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NW / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
      WgmmaSS<64, T>::mma(sc, sw128_desc(c_s + off, 16), sw128_desc(b_s + off, 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    uint32_t ph[4][4], pl[4][4];  // W's hi and lo parts: the m64k16 A fragments of 4 k-steps
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        reg_fence(sc[4 * jj + e]);
        const int key = kTR * j + 8 * jj + 2 * (lane % 4) + (e % 2);
        const float w = key <= trow[e / 2]
                            ? sc[4 * jj + e] * clip_exp(at[e / 2] - as[2 * jj + (e % 2)])
                            : 0.f;
        split16<T>(w, hi[e], lo[e]);
      }
      // the accumulator's (row, key) layout is the A fragment's, as flash's P
      ph[jj / 2][(jj % 2) * 2 + 0] = hi[0] | (hi[1] << 16);
      ph[jj / 2][(jj % 2) * 2 + 1] = hi[2] | (hi[3] << 16);
      pl[jj / 2][(jj % 2) * 2 + 0] = lo[0] | (lo[1] << 16);
      pl[jj / 2][(jj % 2) * 2 + 1] = lo[2] | (lo[3] << 16);
    }
#pragma unroll
    for (int k = 0; k < PW / 2; ++k) reg_fence(acc[k]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTR / 16; ++kk) {
      const uint64_t db = sw128_desc(u_s + kk * 16 * 128, kBox);  // u_j, MN-major
      WgmmaRS<PW, T>::mma(acc, ph[kk], db, 1);
      WgmmaRS<PW, T>::mma(acc, pl[kk], db, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int k = 0; k < PW / 2; ++k) reg_fence(acc[k]);
    __syncthreads();  // stage s is free
    if (tid == 0 && j + kStages <= i) load(j + kStages);
    __syncwarp();
  }

  T* yb = y + ((static_cast<long long>(b) * S + t0) * H + h) * P;
  const long long ystep = static_cast<long long>(H) * P;
#pragma unroll
  for (int jj = 0; jj < PW / 8; ++jj) {
    const int col = 8 * jj + 2 * (lane % 4);
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (trow[r] < L && col < P)
        *reinterpret_cast<uint32_t*>(yb + trow[r] * ystep + col) =
            bits16(from_f32<T>(acc[4 * jj + 2 * r])) |
            (bits16(from_f32<T>(acc[4 * jj + 2 * r + 1])) << 16);
  }
}

// The operands of the three passes; states and acum are the wrapper's scratch.
struct TcArgs {
  int dtype;
  const void *u, *a, *b, *c;
  void* y;
  float *states, *acum;
  int batch, S, H, P, N, L;
  cudaStream_t stream;
};

// A tensor map of `rank` dims over 16-bit elements, innermost first, with the
// byte strides of dims 1.., boxes of 64 columns x 64 rows (rank - 1 dims of 1 but
// the rows') and the 128-byte swizzle; out-of-bounds elements load as zeros.
bool encode_map(CUtensorMap* map, int dtype, const void* ptr, int rank, const cuuint64_t* dims,
                const cuuint64_t* strides, const cuuint32_t* box) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) {
    fprintf(stderr, "ssm_scan: cuTensorMapEncodeTiled is not available\n");
    return false;
  }
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, dtype == kBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                            : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                        rank, const_cast<void*>(ptr), dims, strides, box, estride,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) {
    fprintf(stderr, "ssm_scan: cuTensorMapEncodeTiled failed with CUresult %d\n",
            static_cast<int>(r));
    return false;
  }
  return true;
}

// u (B, S, H, P) as (P, H, S, B); b or c (B, S, N) as (N, S, B).
bool encode_u(CUtensorMap* map, const TcArgs& x) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(x.P), static_cast<cuuint64_t>(x.H),
                              static_cast<cuuint64_t>(x.S), static_cast<cuuint64_t>(x.batch)};
  const cuuint64_t row = 2ull * x.H * x.P;
  const cuuint64_t strides[3] = {2ull * x.P, row, row * x.S};
  const cuuint32_t box[4] = {64, 1, kTR, 1};
  return encode_map(map, x.dtype, x.u, 4, dims, strides, box);
}
bool encode_bc(CUtensorMap* map, const TcArgs& x, const void* ptr) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(x.N), static_cast<cuuint64_t>(x.S),
                              static_cast<cuuint64_t>(x.batch)};
  const cuuint64_t strides[2] = {2ull * x.N, 2ull * x.N * x.S};
  const cuuint32_t box[3] = {64, kTR, 1};
  return encode_map(map, x.dtype, ptr, 3, dims, strides, box);
}

template <typename T, int PW, int NW>
int run_states(const TcArgs& x) {
  CUtensorMap tu, tb;
  if (!encode_u(&tu, x) || !encode_bc(&tb, x, x.b))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int MT = PW / 64, NB = NW / 64;
  constexpr int bytes = 1024 + kStages * (MT + NB) * kBox + NB * kBox + kTR * 4 + 8 * kStages;
  auto kernel = ssd_states_kernel<T, PW, NW>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<x.batch * x.H * (x.S / x.L), 128 * MT, bytes, x.stream>>>(
      tu, tb, static_cast<const float*>(x.a), x.states, x.acum, x.S, x.H, x.P, x.N, x.L);
  return static_cast<int>(cudaGetLastError());
}

int run_pass(const TcArgs& x) {
  const int pn4 = x.P * x.N / 4, per = (pn4 + kPassThreads - 1) / kPassThreads;
  ssd_pass_kernel<<<x.batch * x.H * per, kPassThreads, 0, x.stream>>>(
      reinterpret_cast<float4*>(x.states), x.acum, x.S, x.L, pn4);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int PW, int NW>
int run_outputs(const TcArgs& x) {
  CUtensorMap tu, tb, tc;
  if (!encode_u(&tu, x) || !encode_bc(&tb, x, x.b) || !encode_bc(&tc, x, x.c))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int MT = PW / 64, NB = NW / 64;
  constexpr int bytes = 1024 + NB * kBox + kStages * (NB + MT) * kBox + 8 * (1 + kStages);
  static_assert(bytes <= 232448, "tiles do not fit one block's shared memory");
  auto kernel = ssd_out_kernel<T, PW, NW>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ntr = (x.L + kTR - 1) / kTR;
  kernel<<<x.batch * x.H * (x.S / x.L) * ntr, 128, bytes, x.stream>>>(
      tu, tb, tc, static_cast<T*>(x.y), x.states, x.acum, x.S, x.H, x.P, x.N, x.L);
  return static_cast<int>(cudaGetLastError());
}

// The passes in `passes` (bit 0: chunk states, 1: state passing, 2: chunk
// outputs), in that order; the first error code stops the rest.
template <typename T, int PW, int NW>
int run_tc(const TcArgs& x, int passes) {
  int rc = 0;
  if (!rc && (passes & 1)) rc = run_states<T, PW, NW>(x);
  if (!rc && (passes & 2)) rc = run_pass(x);
  if (!rc && (passes & 4)) rc = run_outputs<T, PW, NW>(x);
  return rc;
}

template <typename T>
int run_tc_widths(const TcArgs& x, int passes) {
  const bool p64 = x.P <= 64, n64 = x.N <= 64;
  if (p64 && n64) return run_tc<T, 64, 64>(x, passes);
  if (p64) return run_tc<T, 64, 128>(x, passes);
  if (n64) return run_tc<T, 128, 64>(x, passes);
  return run_tc<T, 128, 128>(x, passes);
}

bool tc_dims_ok(const TcArgs& x) {
  return x.P >= 16 && x.P <= 128 && x.P % 16 == 0 && x.N >= 16 && x.N <= 128 && x.N % 16 == 0 &&
         x.L >= 1 && x.S % x.L == 0;
}

int dispatch_tc(const TcArgs& x, int passes) {
  if (!tc_dims_ok(x)) return static_cast<int>(cudaErrorInvalidValue);
  if (x.dtype == kBF16) return run_tc_widths<__nv_bfloat16>(x, passes);
  if (x.dtype == kF16) return run_tc_widths<__half>(x, passes);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// fp32, and P or N past 128 or off the multiples of 16: the FP32 pipes
// ---------------------------------------------------------------------------
constexpr int kThreads = 256;   // a 16 x 16 grid of (ty, tx)
constexpr int TR = 64;          // rows of a query or key tile
constexpr int WS = TR + 4;      // row stride of the transposed score tile, in floats
constexpr int kDimTile = 128;   // columns of P a block, values of N a slab

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float dot4(float4 x, float4 y, float acc) {
  return fmaf(x.w, y.w, fmaf(x.z, y.z, fmaf(x.y, y.y, fmaf(x.x, y.x, acc))));
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

      // 1. acum = cumsum(a) over the chunk; entries from L on hold atot
      __syncthreads();  // the last chunk's readers of acum are done
      chunk_cumsum(a + step0 * H + h, H, acum, L, ntiles * TR);
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
  constexpr size_t limit = 232448 - 32 * sizeof(float);  // less chunk_cumsum's warp sums
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

// The tensor-core route (bf16 / fp16, P and N multiples of 16 up to 128).
// states: an fp32 (B, H, S / L, P, N) scratch; acum: an fp32 (B * H, S) one.
extern "C" int repro_ssm_scan_tc(int dtype, const void* u, const void* a, const void* b,
                                 const void* c, void* y, void* states, void* acum, int batch,
                                 int S, int H, int P, int N, int L, void* stream) {
  const TcArgs x{dtype, u, a, b, c, y, static_cast<float*>(states), static_cast<float*>(acum),
                 batch, S, H, P, N, L, static_cast<cudaStream_t>(stream)};
  return dispatch_tc(x, 7);
}

// Its passes one at a time: 1 writes states (each chunk's own) and acum, 2
// turns states into the states entering each chunk, 3 writes y from them.
extern "C" int repro_ssd_chunk_states(int dtype, const void* u, const void* a, const void* b,
                                      void* states, void* acum, int batch, int S, int H, int P,
                                      int N, int L, void* stream) {
  const TcArgs x{dtype, u, a, b, nullptr, nullptr, static_cast<float*>(states),
                 static_cast<float*>(acum), batch, S, H, P, N, L,
                 static_cast<cudaStream_t>(stream)};
  return dispatch_tc(x, 1);
}
extern "C" int repro_ssd_pass_states(void* states, void* acum, int batch, int S, int H, int P,
                                     int N, int L, void* stream) {
  const TcArgs x{kF32, nullptr, nullptr, nullptr, nullptr, nullptr, static_cast<float*>(states),
                 static_cast<float*>(acum), batch, S, H, P, N, L,
                 static_cast<cudaStream_t>(stream)};
  return tc_dims_ok(x) ? run_pass(x) : static_cast<int>(cudaErrorInvalidValue);
}
extern "C" int repro_ssd_chunk_outputs(int dtype, const void* u, const void* b, const void* c,
                                       void* y, void* states, void* acum, int batch, int S,
                                       int H, int P, int N, int L, void* stream) {
  const TcArgs x{dtype, u, nullptr, b, c, y, static_cast<float*>(states),
                 static_cast<float*>(acum), batch, S, H, P, N, L,
                 static_cast<cudaStream_t>(stream)};
  return dispatch_tc(x, 4);
}

// The FP32-pipe route.
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
  return tiles + acum_bytes <= 232448 - 32 * sizeof(float);
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
