// Dequant + de-zigzag + 2-D IDCT of every data unit on Hopper: the folded
// 64x64 product per unit, then clip(round(+128)).
//
// Replaces `fused_idct` (kernels/idct/idct.py of the JAX package), the
// first stage of the unfused pixel chain (fuse="none", and grayscale
// batches under every fuse mode). Each unit's sample k is
// sum_j x[u, j] * M[unit_mrow[u]][k, j] (idct.cuh); the JAX kernel
// computes every matrix q and selects, which gives the same value, and
// this kernel computes only the unit's own. The TPU kernel's two-unit
// pairing (to fill a 128-wide matrix unit) is gone.
//
// What bounds it on this card: bytes, barely. Per unit it reads 64 int32
// coefficients and writes 64 f32 samples (512 B), and does 64*64
// multiply-adds (8 kFLOP): 16 FLOP per byte, under the ridge of 20
// (67 TFLOP/s f32 over 3.35 TB/s). The products run as a separate f32
// multiply and add (for bit parity with the plain version), which halves
// the f32 peak and puts the kernel at about twice the ridge in practice.
//
// Design: one block per tile of kUnits units; the block stages the tile's
// coefficients (as f32) and matrix row ids in shared memory, so a warp's
// 32 threads, which take 32 consecutive samples k of one unit, read each
// x[u, j] as a shared-memory broadcast and M's column as consecutive
// words from L1/L2 (NQ matrices of 16 KB).
//
// Output: (U, 64) f32, row-major pixel samples of each unit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "idct.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnits = 32;  // units per block: 2048 samples, 8 per thread

__global__ void __launch_bounds__(kThreads)
idct_kernel(const int32_t* __restrict__ coeffs,
            const float* __restrict__ mt,  // (NQ, 64 j, 64 k)
            const int32_t* __restrict__ unit_mrow,
            float* __restrict__ out, long long n_units) {
  __shared__ float xs[kUnits * 64];
  __shared__ int rows[kUnits];
  const int64_t u0 = (int64_t)blockIdx.x * kUnits;
  const int nu = (int)min((long long)kUnits, n_units - u0);
  for (int i = threadIdx.x; i < nu * 64; i += blockDim.x) {
    xs[i] = (float)coeffs[u0 * 64 + i];
  }
  for (int i = threadIdx.x; i < nu; i += blockDim.x) {
    rows[i] = unit_mrow[u0 + i];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nu * 64; i += blockDim.x) {
    const int u = i >> 6, k = i & 63;
    out[u0 * 64 + i] =
        rt::idct_sample(xs + u * 64, mt + (int64_t)rows[u] * 4096 + k);
  }
}

}  // namespace

extern "C" {

int rt_idct_units(const void* coeffs, const void* mt, const void* unit_mrow,
                  void* out, long long n_units, void* stream) {
  if (n_units <= 0) return cudaSuccess;
  const long long blocks = (n_units + kUnits - 1) / kUnits;
  idct_kernel<<<(unsigned)blocks, kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(coeffs), static_cast<const float*>(mt),
      static_cast<const int32_t*>(unit_mrow), static_cast<float*>(out),
      n_units);
  return cudaGetLastError();
}

}  // extern "C"
