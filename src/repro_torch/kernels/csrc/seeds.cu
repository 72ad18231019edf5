// The kernel verifier's seeded faults, S1 and S2, as small CUDA kernels
// (S3 is the real pixel kernel, pixels.cu rt_fused_pixels_geometry).
//
// Replaces the seeds of the JAX package's verifier self-test
// (analysis/kernel_check.py run_self_test):
//   rt_seed_oob_rows <- `bad_kernel` (:1706), an off-by-one pl.ds: it sums
//                       rows i + 1 of an (8, 4) f32 operand for i in 0..7
//                       into a (1, 1) f32, so its last read is row 8, one
//                       past the end;
//   rt_seed_ident    <- `ident` (:1738), an identity copy over grid (2,)
//                       with blocks of 4 onto a (10,) f32: two elements are
//                       never written.
// Each makes the same fault on the card, and the checked build (this source
// is only built with -DRT_CHECK, check.cuh) must show it: S1's read of row
// 8 is recorded at site kSiteSeedRows and skipped (read as 0), S2's output
// coverage counts 0 for elements 8 and 9. kernels/seeds.py holds each
// against its plain version.
//
// What bounds them: nothing of note (a few hundred bytes, one block); they
// exist to be caught, and their times in PERF.md are launch overhead.
#include <cuda_runtime.h>
#include <stdint.h>

#include "check.cuh"

#ifndef RT_CHECK
#error "seeds.cu makes its faults on purpose: build it checked (-DRT_CHECK)"
#endif

namespace {

constexpr int kRows = 8, kCols = 4;

// one warp: lane k of the first kRows * kCols reads element k of row
// i + 1 (the off-by-one), the warp sums them into out[0]
__global__ void oob_rows_kernel(const float* __restrict__ x,
                                float* __restrict__ out) {
  const int t = threadIdx.x;
  float v = 0.f;
  if (t < kRows * kCols) {
    const int i = t / kCols, k = t % kCols;
    const int row = i + 1;  // the seeded fault: rows 1..8 of 8
    v = rt::ld(x, (long long)row * kCols + k, (long long)kRows * kCols,
               rt::kSiteSeedRows);
  }
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  if (t == 0) {
    out[0] = v;
    rt::cover(0);
  }
}

// a grid of `blocks` blocks of `tile` threads copies x[b * tile + t]: the
// Pallas grid and BlockSpec; with 2 x 4 over 10 elements, 8 are written
__global__ void ident_kernel(const float* __restrict__ x,
                             float* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (rt::ok(i, n, rt::kSiteSeedCopy)) {
    out[i] = x[i];
    rt::cover(i);
  }
}

}  // namespace

extern "C" {

// x: (8, 4) f32, out: (1,) f32
int rt_seed_oob_rows(const void* x, void* out, void* stream) {
  oob_rows_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out));
  return cudaGetLastError();
}

// x, out: (n,) f32; `blocks` blocks of `tile` threads
int rt_seed_ident(const void* x, void* out, long long n, int tile,
                  int blocks, void* stream) {
  if (tile < 1 || tile > 1024 || blocks < 1) return cudaErrorInvalidValue;
  ident_kernel<<<blocks, tile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n);
  return cudaGetLastError();
}

}  // extern "C"
