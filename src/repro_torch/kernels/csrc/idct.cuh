// The folded IDCT of pixel samples: the shared bodies of the IDCT kernel
// (idct.cu) and of the pixel kernel's first stage (pixels.cu), so that the
// two compute the same value by construction, and the tile staging both
// kernels use.
//
// sample = clip(rint(sum_{j=0..63} x[j] * M[k][j] + 128), 0, 255), with M
// read transposed, mt[q][j][k] = M_q[k][j] (made once per plan).
// Bit-exact with the plain version (core/decode.folded_product and
// idct_units_folded): the sum runs over j = 0..63 in order, every multiply
// and add is written as __fmul_rn / __fadd_rn so that nvcc does not
// contract them into FMAs, and rintf rounds half to even like torch.round
// and jnp.round (roundf would round half away from zero).
//
// idct_sample computes one sample k (mtk = &mt[q][0][k]; consecutive
// threads take consecutive k, so a warp reads consecutive words).
// idct_group computes a register tile: 8 samples, k0..k0+3 and
// k0+32..k0+35, of each of U units. Every sample has its own accumulator,
// summed over j = 0..63 in order with the same intrinsics and the same
// rounding, so each of its samples is the value idct_sample gives for that
// unit and k. Per j it reads U values of x and 8 of M (two 16-byte loads)
// for 8U multiplies and 8U adds; when the U units share one matrix it
// reads M once for all of them, else once per unit.
//
// The checked build (-DRT_CHECK, check.cuh) guards the tile's copies (the
// coefficients and matrix ids in global memory, their shared rows), the
// matrix each unit names (a row of 64 x 64 floats within the NQ staged or
// global ones) and the tile's reads of its shared rows.
#pragma once

#include <stdint.h>

#include "check.cuh"
#include "geometry.cuh"

namespace rt {

__device__ __forceinline__ float idct_round(float acc) {
  return fminf(fmaxf(rintf(__fadd_rn(acc, 128.f)), 0.f), 255.f);
}

__device__ __forceinline__ float idct_sample(const float* xu,
                                             const float* __restrict__ mtk) {
  float acc = 0.f;
#pragma unroll 8
  for (int j = 0; j < 64; ++j) {
    acc = __fadd_rn(acc, __fmul_rn(xu[j], __ldg(mtk + j * 64)));
  }
  return idct_round(acc);
}

// acc[r] += x * m[r] for the 8 samples of one unit, each as a separate
// multiply and add.
__device__ __forceinline__ void idct_mac8(float (&acc)[8], float x,
                                          const float4& lo,
                                          const float4& hi) {
  acc[0] = __fadd_rn(acc[0], __fmul_rn(x, lo.x));
  acc[1] = __fadd_rn(acc[1], __fmul_rn(x, lo.y));
  acc[2] = __fadd_rn(acc[2], __fmul_rn(x, lo.z));
  acc[3] = __fadd_rn(acc[3], __fmul_rn(x, lo.w));
  acc[4] = __fadd_rn(acc[4], __fmul_rn(x, hi.x));
  acc[5] = __fadd_rn(acc[5], __fmul_rn(x, hi.y));
  acc[6] = __fadd_rn(acc[6], __fmul_rn(x, hi.z));
  acc[7] = __fadd_rn(acc[7], __fmul_rn(x, hi.w));
}

// xu[i]: unit i's 64 coefficients as f32; mqk[i]: &mt[q_i][0][k0],
// 16-byte aligned, rows 64 floats apart (shared or global memory);
// same_q: every q_i is q_0. out[i][r] is sample k0 + r (r < 4) or
// k0 + 28 + r (r >= 4) of unit i.
template <int U>
__device__ __forceinline__ void idct_group(const float* const (&xu)[U],
                                           const float* const (&mqk)[U],
                                           bool same_q, float (&out)[U][8]) {
  float acc[U][8];
#pragma unroll
  for (int i = 0; i < U; ++i) {
#pragma unroll
    for (int r = 0; r < 8; ++r) acc[i][r] = 0.f;
  }
  if (same_q) {
#pragma unroll 2
    for (int j = 0; j < 64; ++j) {
      const float4 lo = *reinterpret_cast<const float4*>(mqk[0] + j * 64);
      const float4 hi =
          *reinterpret_cast<const float4*>(mqk[0] + j * 64 + 32);
#pragma unroll
      for (int i = 0; i < U; ++i) idct_mac8(acc[i], xu[i][j], lo, hi);
    }
  } else {
#pragma unroll 2
    for (int j = 0; j < 64; ++j) {
#pragma unroll
      for (int i = 0; i < U; ++i) {
        const float4 lo = *reinterpret_cast<const float4*>(mqk[i] + j * 64);
        const float4 hi =
            *reinterpret_cast<const float4*>(mqk[i] + j * 64 + 32);
        idct_mac8(acc[i], xu[i][j], lo, hi);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < U; ++i) {
#pragma unroll
    for (int r = 0; r < 8; ++r) out[i][r] = idct_round(acc[i][r]);
  }
}

// -- a tile of units, as the IDCT and pixel kernels stage and compute it --
//
// A thread group of kThreadsPerGroup threads computes kUnits units that lie
// `stride` units apart (idct_group): group g of a tile takes units
// group_unit(g, i, stride) = a + i * stride, i < kUnits, a = (g / stride) *
// kUnits * stride + g % stride, and thread t of the group samples
// k0 = 4 t .. +3 and k0 + 32 .. +35. A tile of groups * kUnits units
// (groups a multiple of stride) is then covered once (geometry.cuh). The
// tile's coefficients are copied with cp.async (fetch_tile) and converted
// to f32 rows of kXStride floats (convert_tile), padded so that the groups
// of a warp read distinct banks.

__device__ __forceinline__ void copy_async16(void* smem, const void* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void copy_async4(void* smem, const void* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem));
}

// Start copying tile `t`'s coefficients and matrix ids into raw, raw_rows
// (shared rows for `tile` units).
__device__ __forceinline__ void fetch_tile(const int32_t* coeffs,
                                           const int32_t* unit_mrow,
                                           long long n_units, int tile,
                                           long long t, int32_t* raw,
                                           int32_t* raw_rows) {
  const long long u0 = t * tile;
  const int nu = (int)min((long long)tile, n_units - u0);
  for (int i = threadIdx.x; i < nu * 16; i += blockDim.x) {
    if (ok(u0 * 64 + i * 4 + 3, n_units * 64, kSiteCoeffs) &&
        ok(i * 4 + 3, (long long)tile * 64, kSiteTile)) {
      copy_async16(raw + i * 4, coeffs + u0 * 64 + i * 4);
    }
  }
  for (int i = threadIdx.x; i < nu; i += blockDim.x) {
    if (ok(u0 + i, n_units, kSiteUnitRow) && ok(i, tile, kSiteTile)) {
      copy_async4(raw_rows + i, unit_mrow + u0 + i);
    }
  }
  asm volatile("cp.async.commit_group;\n");
}

// The landed tile's nu units as f32 rows of kXStride, and their ids (shared
// rows for `tile` units).
__device__ __forceinline__ void convert_tile(const int32_t* raw,
                                             const int32_t* raw_rows, int nu,
                                             int tile, float* xs,
                                             int* rows) {
  for (int i = threadIdx.x; i < nu * 16; i += blockDim.x) {
    const int4 v = ld(reinterpret_cast<const int4*>(raw), i,
                      (long long)tile * 16, kSiteTile);
    const long long xi = (long long)(i >> 4) * kXStride + (i & 15) * 4;
    if (!ok(xi + 3, (long long)tile * kXStride, kSiteTile)) continue;
    float* x = xs + xi;
    x[0] = (float)v.x;
    x[1] = (float)v.y;
    x[2] = (float)v.z;
    x[3] = (float)v.w;
  }
  for (int i = threadIdx.x; i < nu; i += blockDim.x) {
    st(rows, i, tile, kSiteTile, ld(raw_rows, i, tile, kSiteTile));
  }
}

// The samples of group unit a's kUnits units (a < nu) from the converted
// tile; m: the nq matrices (shared or global). Units past the tile's end
// compute on unit a; the caller does not store them. The checked build
// holds each unit's row and its matrix's last word (k0 + 35 of row 63)
// within the tile's rows and the nq matrices; a unit that fails computes
// on unit a and matrix 0.
__device__ __forceinline__ void idct_tile_group(const float* xs,
                                                const int* rows,
                                                const float* m, int nq,
                                                int a, int stride, int nu,
                                                int k0,
                                                float (&s)[kUnits][8]) {
  const float* xu[kUnits];
  const float* mqk[kUnits];
  bool same_q = true;
  const int q0 = rows[a];
#pragma unroll
  for (int i = 0; i < kUnits; ++i) {
    int u = a + i * stride < nu ? a + i * stride : a;
    if (!ok(u, nu, kSiteTile)) u = a;
    int q = rows[u];
    if (!ok((long long)q * 4096 + 63 * 64 + k0 + 35, (long long)nq * 4096,
            kSiteMatrix)) {
      q = 0;
    }
    xu[i] = xs + u * kXStride;
    mqk[i] = m + q * 4096 + k0;
    same_q = same_q && q == q0;
  }
  idct_group<kUnits>(xu, mqk, same_q, s);
}

}  // namespace rt
