// The checked build's guard: a bounds check on every global and shared
// access of the kernels, and a coverage count of their dense outputs.
//
// Built with -DRT_CHECK (kernels/build.load(name, checked=True), which only
// the kernel verifier asks for), every access a kernel routes through
// rt::ok / rt::ld / rt::st compares its index with its operand's extent.
// Out of range, it records the first violation in a record (its site, the
// index and the extent; the first one wins through atomicCAS) and counts
// it, then skips the access: a skipped load reads 0, a skipped store does
// not happen, so the checked kernel never reads or writes past an operand.
// rt::cover adds one to a shadow int32 buffer (set by rt_check_coverage)
// for each element of a dense output written, so that a run can show that
// every element was written exactly once.
//
// Without RT_CHECK both compile to the plain access (ok() is `true`, cover
// does nothing), so the release build's code and times do not change.
//
// Counterpart of the JAX verifier's kernel-bounds and kernel-tiling
// families (analysis/kernel_check.py of the JAX package), which prove the
// same properties of the Pallas kernels statically; here the checked build
// shows them on every launch it runs.
//
// The functions are __host__ __device__: a g++ build of huffman.cuh or
// color.cuh with -DRT_CHECK (tests/test_torch_kernel_check.py) runs the
// same guards on the CPU, with host globals in place of the device record.
#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

namespace rt {

// Where a violation happened; analysis/kernel_check.py reads these names
// from this enum.
enum CheckSite : int {
  kSiteNone = 0,
  kSiteWords = 1,         // the words window (huffman.cuh load_word32)
  kSiteTable = 2,         // a compact table entry (CompactLut)
  kSiteTableRow = 3,      // a tableset's row start (unit_lut_off)
  kSiteLane = 4,          // per-lane metadata and exit states
  kSiteStream = 5,        // a (pos, val) row of the stream kernel
  kSiteCoef = 6,          // the store kernel's coefficient target
  kSiteSlot = 7,          // a store kernel unit slot (shared)
  kSiteStageTables = 8,   // the tables staged in shared memory
  kSiteCoeffs = 9,        // the IDCT / pixel kernels' coefficient copy
  kSiteUnitRow = 10,      // unit_mrow
  kSiteMatrix = 11,       // the folded matrices
  kSiteTile = 12,         // a tile's shared staging
  kSiteSamples = 13,      // the IDCT kernel's output samples
  kSiteMcuOut = 14,       // the pixel kernel's RGB MCU blocks
  kSitePlane = 15,        // a color kernel plane sample (its column)
  kSitePlaneRow = 16,     // a color kernel plane row
  kSiteRgb = 17,          // a color kernel RGB byte
  kSiteColorStage = 18,   // the color kernel's warp stage (shared)
  kSiteSeedRows = 19,     // seed S1: the off-by-one row read
  kSiteSeedCopy = 20,     // seed S2: the identity copy
  kSiteCover = 21,        // a coverage count outside the shadow buffer
};

struct CheckRecord {
  int site;          // the first violation's site (kSiteNone: none)
  int count;         // violations seen
  long long index;   // the first violation's index
  long long extent;  // and its operand's extent
};

#ifdef RT_CHECK
#ifdef __CUDACC__
__device__ CheckRecord g_check_record = {0, 0, 0, 0};
__device__ int* g_check_cover = nullptr;
__device__ long long g_check_cover_n = 0;
#endif
// the host build's record (and the nvcc host pass's, never used there)
inline CheckRecord h_check_record = {0, 0, 0, 0};
inline int* h_check_cover = nullptr;
inline long long h_check_cover_n = 0;
#endif

__host__ __device__ __forceinline__ void check_fail(int site, long long i,
                                                    long long n) {
#ifdef RT_CHECK
#ifdef __CUDA_ARCH__
  if (atomicCAS(&g_check_record.site, 0, site) == 0) {
    g_check_record.index = i;
    g_check_record.extent = n;
  }
  atomicAdd(&g_check_record.count, 1);
#else
  if (h_check_record.site == 0) {
    h_check_record = CheckRecord{site, 0, i, n};
  }
  ++h_check_record.count;
#endif
#else
  (void)site;
  (void)i;
  (void)n;
#endif
}

// Whether index i lies in [0, n); records a violation at `site` if not.
__host__ __device__ __forceinline__ bool ok(long long i, long long n,
                                            int site) {
#ifdef RT_CHECK
  if (i >= 0 && i < n) return true;
  check_fail(site, i, n);
  return false;
#else
  (void)i;
  (void)n;
  (void)site;
  return true;
#endif
}

// p[i], or 0 (T{}) where i is out of [0, n)
template <class T>
__host__ __device__ __forceinline__ T ld(const T* p, long long i,
                                         long long n, int site) {
  return ok(i, n, site) ? p[i] : T{};
}

// p[i] = v where i lies in [0, n)
template <class T>
__host__ __device__ __forceinline__ void st(T* p, long long i, long long n,
                                            int site, const T& v) {
  if (ok(i, n, site)) p[i] = v;
}

// One write each of `count` consecutive elements from element i of the
// covered output (rt_check_coverage).
__host__ __device__ __forceinline__ void cover(long long i,
                                               long long count = 1) {
#ifdef RT_CHECK
#ifdef __CUDA_ARCH__
  int* c = g_check_cover;
  const long long n = g_check_cover_n;
#else
  int* c = h_check_cover;
  const long long n = h_check_cover_n;
#endif
  if (c == nullptr) return;
  for (long long k = i; k < i + count; ++k) {
    if (!ok(k, n, kSiteCover)) continue;
#ifdef __CUDA_ARCH__
    atomicAdd(c + k, 1);
#else
    ++c[k];
#endif
  }
#else
  (void)i;
  (void)count;
#endif
}

// The dynamic shared memory of the running block, in bytes (the extent the
// shared staging is checked against); 0 outside the checked device build.
__device__ __forceinline__ unsigned dynamic_smem_bytes() {
#if defined(RT_CHECK) && defined(__CUDA_ARCH__)
  unsigned r;
  asm volatile("mov.u32 %0, %%dynamic_smem_size;" : "=r"(r));
  return r;
#else
  return 0;
#endif
}

}  // namespace rt

// -- the record's C entries -------------------------------------------------
//
// rt_check_read(out): out[0..3] = site, count, index, extent of the record;
// rt_check_reset(): empty it; rt_check_coverage(buf, n): count the covered
// writes into buf (n int32, zeroed by the caller), or none for buf NULL.
// Each returns a cudaError_t (0 in the host build). Defined once per
// library (each .cu is one translation unit) in the checked build only.
#ifdef RT_CHECK
#ifdef __CUDACC__
#include <cuda_runtime.h>

extern "C" {
int rt_check_read(long long* out) {
  rt::CheckRecord r;
  const cudaError_t err =
      cudaMemcpyFromSymbol(&r, rt::g_check_record, sizeof(r));
  out[0] = r.site;
  out[1] = r.count;
  out[2] = r.index;
  out[3] = r.extent;
  return err;
}

int rt_check_reset() {
  const rt::CheckRecord z = {0, 0, 0, 0};
  return cudaMemcpyToSymbol(rt::g_check_record, &z, sizeof(z));
}

int rt_check_coverage(void* buf, long long n) {
  int* p = static_cast<int*>(buf);
  const long long m = buf == nullptr ? 0 : n;
  cudaError_t err = cudaMemcpyToSymbol(rt::g_check_cover, &p, sizeof(p));
  if (err != cudaSuccess) return err;
  return cudaMemcpyToSymbol(rt::g_check_cover_n, &m, sizeof(m));
}
}  // extern "C"
#else
extern "C" {
int rt_check_read(long long* out) {
  out[0] = rt::h_check_record.site;
  out[1] = rt::h_check_record.count;
  out[2] = rt::h_check_record.index;
  out[3] = rt::h_check_record.extent;
  return 0;
}

int rt_check_reset() {
  rt::h_check_record = rt::CheckRecord{0, 0, 0, 0};
  return 0;
}

int rt_check_coverage(void* buf, long long n) {
  rt::h_check_cover = static_cast<int*>(buf);
  rt::h_check_cover_n = buf == nullptr ? 0 : n;
  return 0;
}
}  // extern "C"
#endif
#endif
