// Pointer chase: idx = perm[idx], `steps` fully dependent loads from idx 0.
//
// Replaces src/repro/kernels/pchase.py::_pchase_kernel (pchase_pallas).
//
// Bound on the H100: the load-to-use latency of the level that holds `perm`
// (L1, L2 or HBM), once per step; the bytes moved are negligible.  The design
// keeps that latency alone on the timeline: one thread in one block, so no
// other load overlaps the chain, and each address comes from the previous
// load.  The load is ld.global.ca, the default caching (L1 and L2), written
// as volatile PTX so the compiler neither hoists it, moves it to the
// read-only path, nor drops the loop; the final index is stored so the chain
// is live.  The caller's timer brackets the launch, so per-step times carry
// launch overhead / steps.
#include "common.cuh"

__device__ __forceinline__ int load_ca(const int* p) {
  int v;
  asm volatile("ld.global.ca.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__global__ void pchase_kernel(const int* perm, long long steps, int* out) {
  int idx = 0;
  for (long long s = 0; s < steps; ++s) idx = load_ca(perm + idx);
  out[0] = idx;
}

extern "C" int repro_pchase(const void* perm, long long steps, void* out, void* stream) {
  pchase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(perm), steps, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
