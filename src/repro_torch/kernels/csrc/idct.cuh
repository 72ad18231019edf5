// The folded IDCT of pixel samples: the shared bodies of the IDCT kernel
// (idct.cu) and of the pixel kernel's first stage (pixels.cu), so that the
// two compute the same value by construction.
//
// sample = clip(rint(sum_{j=0..63} x[j] * M[k][j] + 128), 0, 255), with M
// read transposed, mt[q][j][k] = M_q[k][j] (made once per plan).
// Bit-exact with the plain version (core/decode.folded_product and
// idct_units_folded): the sum runs over j = 0..63 in order, every multiply
// and add is written as __fmul_rn / __fadd_rn so that nvcc does not
// contract them into FMAs, and rintf rounds half to even like torch.round
// and jnp.round (roundf would round half away from zero).
//
// idct_sample computes one sample k (mtk = &mt[q][0][k]; the pixel
// kernel's threads take consecutive k, so a warp reads consecutive words).
// idct_group computes a register tile: 8 samples, k0..k0+3 and
// k0+32..k0+35, of each of U units. Every sample has its own accumulator,
// summed over j = 0..63 in order with the same intrinsics and the same
// rounding, so each of its samples is the value idct_sample gives for that
// unit and k. Per j it reads U values of x and 8 of M (two 16-byte loads)
// for 8U multiplies and 8U adds; when the U units share one matrix it
// reads M once for all of them, else once per unit.
#pragma once

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

}  // namespace rt
