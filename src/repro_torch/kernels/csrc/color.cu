// Replicate upsample + BT.601 YCbCr -> RGB + clip(round) on Hopper.
//
// Replaces `upsample_color` (kernels/color/color.py of the JAX package),
// the last stage of the unfused pixel chain (fuse="none"): from the three
// assembled component planes to (B, H, W, 3) uint8 RGB, cropped to the
// image size. The JAX kernel takes full-resolution luma and one chroma
// factor (fh, fv); this one takes a vertical and horizontal factor per
// component from the geometry (v_max / v_c, h_max / h_c), so it covers
// every layout that core/decode.upsample_color covers, and the JAX
// kernel's signature is the special case (1, 1), (fv, fh), (fv, fh).
//
// What bounds it on this card: bytes. Per output pixel it reads one luma
// sample and, for 4:2:0, a quarter of a chroma sample of each plane (f32),
// and writes 3 bytes; a handful of f32 operations each.
//
// Design: one thread per output pixel, in row-major order, so a warp reads
// 32 consecutive luma words and writes 96 consecutive bytes; the chroma
// reads of neighbouring threads fall on the same words. Bit-exact with
// the plain version (core/decode.ycbcr_to_rgb): the transform is written
// in the JAX order with __fmul_rn / __fadd_rn / __fsub_rn, because nvcc
// would otherwise contract y + 1.402f * cr into an FMA (one rounding
// instead of two), and rintf rounds half to even like torch.round.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Planes {
  const float* p[3];  // (B, h[c], w[c]) f32 each
  int h[3], w[3];
  int fv[3], fh[3];   // replicate factors: output row y reads row y / fv
};

__device__ __forceinline__ uint8_t to_u8(float v) {
  return (uint8_t)fminf(fmaxf(rintf(v), 0.f), 255.f);
}

__global__ void __launch_bounds__(kThreads)
color_kernel(Planes pl, uint8_t* __restrict__ out, int height, int width,
             long long n_pixels) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pixels) return;
  const int x = (int)(i % width);
  const int64_t row = i / width;
  const int y = (int)(row % height);
  const int64_t b = row / height;
  float s[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int64_t at = (b * pl.h[c] + y / pl.fv[c]) * pl.w[c] + x / pl.fh[c];
    s[c] = __ldg(pl.p[c] + at);
  }
  const float c_r = (float)1.402, c_gb = (float)0.344136286,
              c_gr = (float)0.714136286, c_b = (float)1.772;
  const float Y = s[0];
  const float cb = __fsub_rn(s[1], 128.f);
  const float cr = __fsub_rn(s[2], 128.f);
  const float r = __fadd_rn(Y, __fmul_rn(cr, c_r));
  const float g = __fsub_rn(__fsub_rn(Y, __fmul_rn(cb, c_gb)),
                            __fmul_rn(cr, c_gr));
  const float bl = __fadd_rn(Y, __fmul_rn(cb, c_b));
  uint8_t* o = out + i * 3;
  o[0] = to_u8(r);
  o[1] = to_u8(g);
  o[2] = to_u8(bl);
}

}  // namespace

extern "C" {

int rt_upsample_color(const void* const* planes, const int* h, const int* w,
                      const int* fv, const int* fh, void* out, int n_images,
                      int height, int width, void* stream) {
  const long long n_pixels = (long long)n_images * height * width;
  if (n_pixels <= 0) return cudaSuccess;
  Planes pl;
  for (int c = 0; c < 3; ++c) {
    pl.p[c] = static_cast<const float*>(planes[c]);
    pl.h[c] = h[c];
    pl.w[c] = w[c];
    pl.fv[c] = fv[c];
    pl.fh[c] = fh[c];
  }
  const long long blocks = (n_pixels + kThreads - 1) / kThreads;
  color_kernel<<<(unsigned)blocks, kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      pl, static_cast<uint8_t*>(out), height, width, n_pixels);
  return cudaGetLastError();
}

}  // extern "C"
