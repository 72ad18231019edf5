// The fused post-entropy pixel stage on Hopper: from zig-zag coefficients
// to RGB, one launch.
//
// Replaces `fused_pixels_pallas` (kernels/fused/pixels.py of the JAX
// package): dequant + de-zigzag + IDCT as one 64x64 product per data unit
// with the folded operator M[unit_mrow], clip(round(+128)), per-MCU plane
// assembly, replicate chroma upsample and BT.601 color convert. The
// intermediate unit pixels and YCbCr planes live only in shared memory.
//
// What bounds it on this card: it sits at the f32 ridge. Per 4:2:0 MCU it
// reads 6*64 int32 coefficients (1536 B) and writes 16*16*3 uint8 (768 B),
// and does 6*64*64 multiply-adds (49 kFLOP): about 21 FLOP per byte,
// against a ridge of 20 (67 TFLOP/s f32 over 3.35 TB/s). The products run
// as plain f32 instructions, not on the tensor cores, and as a separate
// multiply and add (see below), which halves the f32 peak; no library is
// called.
//
// Design:
//   * one block per tile of whole MCUs; the block stages the tile's
//     coefficients (as f32) and each unit's matrix row id in shared memory;
//   * each thread computes output samples as 64-term dot products, with
//     M read transposed (mt[q][j][k], made once per plan) so that the
//     threads of a warp, which take consecutive k, read consecutive words;
//   * the TPU kernel's two-unit pairing (to fill a 128-wide matrix unit)
//     is gone;
//   * bit-exact with the plain version (core/decode.folded_product and
//     ycbcr_to_rgb): each sum runs over j = 0..63 in order, and every
//     multiply and add is written as __fmul_rn / __fadd_rn so that nvcc
//     does not contract them into FMAs; rintf rounds half to even like
//     torch.round and jnp.round (roundf would round half away from zero).
//     The IDCT sample is idct.cuh's, shared with the IDCT kernel.
//
// Output: (n_mcus, 8*v_max, 8*h_max, 3) uint8; the wrapper reshapes and
// crops it to (B, H, W, 3).
#include <cuda_runtime.h>
#include <stdint.h>

#include "idct.cuh"

namespace {

constexpr int kThreads = 256;

struct Geometry {
  int upm;           // data units per MCU
  int comp_h[3];
  int comp_v[3];
  int comp_off[3];   // first unit of each component within the MCU
  int h_max, v_max;
};

__device__ __forceinline__ float sample(const float* px, const Geometry& g,
                                        int m, int ci, int y, int x) {
  // replicate upsample: full-resolution (y, x) -> component sample
  const int ys = y / (g.v_max / g.comp_v[ci]);
  const int xs = x / (g.h_max / g.comp_h[ci]);
  const int unit = g.comp_off[ci] + (ys >> 3) * g.comp_h[ci] + (xs >> 3);
  return px[(m * g.upm + unit) * 64 + (ys & 7) * 8 + (xs & 7)];
}

__device__ __forceinline__ uint8_t to_u8(float v) {
  return (uint8_t)fminf(fmaxf(rintf(v), 0.f), 255.f);
}

__global__ void __launch_bounds__(kThreads)
pixels_kernel(const int32_t* __restrict__ coeffs,
              const float* __restrict__ mt,         // (NQ, 64 j, 64 k)
              const int32_t* __restrict__ unit_mrow,
              uint8_t* __restrict__ out, Geometry g, int n_mcus,
              int tile_m) {
  extern __shared__ float smem[];
  const int m0 = blockIdx.x * tile_m;
  const int tm = min(tile_m, n_mcus - m0);
  const int nu = tm * g.upm;
  float* xs = smem;                          // (nu, 64) coefficients
  float* px = xs + tile_m * g.upm * 64;      // (nu, 64) unit pixels
  int* rows = reinterpret_cast<int*>(px + tile_m * g.upm * 64);

  const int64_t u0 = (int64_t)m0 * g.upm;
  for (int i = threadIdx.x; i < nu * 64; i += blockDim.x) {
    xs[i] = (float)coeffs[u0 * 64 + i];
  }
  for (int i = threadIdx.x; i < nu; i += blockDim.x) {
    rows[i] = unit_mrow[u0 + i];
  }
  __syncthreads();

  // IDCT: px[u, k] = clip(rint(sum_j x[u, j] * M[q_u][k, j] + 128), 0, 255)
  for (int i = threadIdx.x; i < nu * 64; i += blockDim.x) {
    const int u = i >> 6, k = i & 63;
    px[i] = rt::idct_sample(xs + u * 64, mt + (int64_t)rows[u] * 4096 + k);
  }
  __syncthreads();

  // plane assembly + replicate upsample + color, one output pixel each
  const int mh = 8 * g.v_max, mw = 8 * g.h_max;
  const float c_r = (float)1.402, c_gb = (float)0.344136286,
              c_gr = (float)0.714136286, c_b = (float)1.772;
  for (int i = threadIdx.x; i < tm * mh * mw; i += blockDim.x) {
    const int m = i / (mh * mw);
    const int y = (i / mw) % mh, x = i % mw;
    const float Y = sample(px, g, m, 0, y, x);
    const float cb = __fsub_rn(sample(px, g, m, 1, y, x), 128.f);
    const float cr = __fsub_rn(sample(px, g, m, 2, y, x), 128.f);
    const float r = __fadd_rn(Y, __fmul_rn(cr, c_r));
    const float gg = __fsub_rn(__fsub_rn(Y, __fmul_rn(cb, c_gb)),
                               __fmul_rn(cr, c_gr));
    const float b = __fadd_rn(Y, __fmul_rn(cb, c_b));
    uint8_t* o = out + ((int64_t)(m0 + m) * mh * mw + y * mw + x) * 3;
    o[0] = to_u8(r);
    o[1] = to_u8(gg);
    o[2] = to_u8(b);
  }
}

}  // namespace

extern "C" {

// Shared memory a block of `tile_m` MCUs needs.
long long rt_pixels_smem_bytes(int tile_m, int upm) {
  return (long long)tile_m * upm * (2 * 64 * sizeof(float) + sizeof(int));
}

int rt_fused_pixels(const void* coeffs, const void* mt, const void* unit_mrow,
                    void* out, int n_mcus, int upm, const int* comp_h,
                    const int* comp_v, int h_max, int v_max, int tile_m,
                    void* stream) {
  if (n_mcus <= 0) return cudaSuccess;
  Geometry g;
  g.upm = upm;
  int off = 0;
  for (int c = 0; c < 3; ++c) {
    g.comp_h[c] = comp_h[c];
    g.comp_v[c] = comp_v[c];
    g.comp_off[c] = off;
    off += comp_h[c] * comp_v[c];
  }
  g.h_max = h_max;
  g.v_max = v_max;
  const long long smem = rt_pixels_smem_bytes(tile_m, upm);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pixels_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (n_mcus + tile_m - 1) / tile_m;
  pixels_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(coeffs), static_cast<const float*>(mt),
      static_cast<const int32_t*>(unit_mrow), static_cast<uint8_t*>(out), g,
      n_mcus, tile_m);
  return cudaGetLastError();
}

}  // extern "C"
