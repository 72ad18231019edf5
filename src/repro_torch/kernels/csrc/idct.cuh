// The folded IDCT of one pixel sample: the shared body of the IDCT kernel
// (idct.cu) and of the pixel kernel's first stage (pixels.cu), so that the
// two compute the same value by construction.
//
// sample = clip(rint(sum_{j=0..63} x[j] * M[k][j] + 128), 0, 255), with M
// read transposed, mtk = &mt[q][0][k] (mt[q][j][k] = M_q[k][j], made once
// per plan), so the threads of a warp, which take consecutive k, read
// consecutive words. Bit-exact with the plain version
// (core/decode.folded_product and idct_units_folded): the sum runs over
// j = 0..63 in order, every multiply and add is written as __fmul_rn /
// __fadd_rn so that nvcc does not contract them into FMAs, and rintf
// rounds half to even like torch.round and jnp.round (roundf would round
// half away from zero).
#pragma once

namespace rt {

__device__ __forceinline__ float idct_sample(const float* xu,
                                             const float* __restrict__ mtk) {
  float acc = 0.f;
#pragma unroll 8
  for (int j = 0; j < 64; ++j) {
    acc = __fadd_rn(acc, __fmul_rn(xu[j], __ldg(mtk + j * 64)));
  }
  return fminf(fmaxf(rintf(__fadd_rn(acc, 128.f)), 0.f), 255.f);
}

}  // namespace rt
