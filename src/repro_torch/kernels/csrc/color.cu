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
// and writes 3 bytes; a handful of f32 operations each. One thread per
// pixel, finding its samples with 64-bit divisions and remainders by the
// width and height and six divisions by run-time factors, would spend a
// few hundred instructions a pixel and be bound by instruction issue.
//
// Design: a thread colors a run of kColorRun consecutive pixels of one
// row (rt::color_run, color.cuh: no division inside the run, 16-byte
// loads) and stores its 3 kColorRun bytes with 8- or 16-byte stores where
// every output row is aligned to them; otherwise the warp's 32 runs,
// consecutive in one row, are staged in shared memory and written out by
// the warp together with 4-byte stores (rt::copy_span), so that a width
// such as 1918 costs no byte-wise stores. The grid lies over (runs of a
// row, rows, images): a block is kRunsX = 32 runs (a warp) across x
// kRowsY rows, and rows and images are stride loops, so no grid dimension
// grows past its limit with the batch and no thread divides by the width
// or the height. The layout's factors are template constants for the
// standard forms (color.cuh's with_form). kColorRun = 8 (8-byte stores)
// and kRowsY = 8 measured best of runs of 8 and 16 and 2 to 8 rows, by
// 1-3% (PERF.md, tools/kernel_times.py --color-variants). Bit-exact with
// the plain version (core/decode.ycbcr_to_rgb; see color.cuh). The grid
// and the run are geometry.cuh's (color_grid, kColorRun, kRunsX, kRowsY).
//
// The checked build (check.cuh) guards the plane reads (color.cuh), the
// warp's stage and every RGB store within its row, and counts each RGB
// byte written (coverage).
#include <cuda_runtime.h>
#include <stdint.h>

#include "color.cuh"
#include "geometry.cuh"

namespace {

using rt::kColorRun;
using rt::kRowsY;
using rt::kRunsX;
constexpr int kWords = 3 * kColorRun / 4;  // a run's RGB bytes, as words
constexpr int kStageWords = kRunsX * kWords + 1;
static_assert(kRunsX == 32, "a warp stages the runs of one row");

template <int kFh, int kFv>
__global__ void __launch_bounds__(kRunsX * kRowsY)
color_kernel(rt::ColorPlanes pl, uint8_t* __restrict__ out, int n_images,
             int height, int width, bool store_vec) {
  __shared__ uint32_t stage[kRowsY][kStageWords];
  const int x_w = blockIdx.x * kRunsX * kColorRun;  // the warp's first x
  const int x0 = x_w + threadIdx.x * kColorRun;
  const bool active = x0 < width;
  if (store_vec && !active) return;  // the staged path needs every lane
  const int n = width - x0 < kColorRun ? width - x0 : kColorRun;
  const int nbytes = rt::span_bytes<kColorRun, kRunsX>(x_w, width);
  uint32_t* own = stage[threadIdx.y];
  for (int b = blockIdx.z; b < n_images; b += gridDim.z) {
    for (int y = blockIdx.y * kRowsY + threadIdx.y; y < height;
         y += gridDim.y * kRowsY) {
      uint32_t words[kWords];
      if (active) {
        rt::color_run<kColorRun, kFh, kFv>(pl, b, y, x0, n, words);
      }
      uint8_t* row = rt::row_out(out, b, y, height, width);
      const long long at = ((long long)b * height + y) * width * 3;
      if (store_vec) {
        if (rt::ok(3LL * x0 + 3 * kColorRun - 1, 3LL * width, rt::kSiteRgb)) {
          rt::store_run<kColorRun>(row + 3 * x0, words);
          rt::cover(at + 3 * x0, 3 * kColorRun);
        }
      } else {
        if (active) {
#pragma unroll
          for (int i = 0; i < kWords; ++i) {
            rt::st(own, threadIdx.x * kWords + i, kStageWords,
                   rt::kSiteColorStage, words[i]);
          }
        }
        __syncwarp();
        rt::copy_span<kRunsX>(row + 3 * x_w, own, nbytes, threadIdx.x,
                              3LL * (width - x_w), at + 3LL * x_w);
        __syncwarp();
      }
    }
  }
}

}  // namespace

extern "C" {

int rt_upsample_color(const void* const* planes, const int* h, const int* w,
                      const int* fv, const int* fh, void* out, int n_images,
                      int height, int width, void* stream) {
  if (n_images <= 0 || height <= 0 || width <= 0) return cudaSuccess;
  rt::ColorPlanes pl;
  for (int c = 0; c < 3; ++c) {
    pl.p[c] = static_cast<const float*>(planes[c]);
    pl.h[c] = h[c];
    pl.w[c] = w[c];
    pl.fv[c] = fv[c];
    pl.fh[c] = fh[c];
    if (fv[c] <= 0 || fh[c] <= 0) return cudaErrorInvalidValue;
  }
  pl.n = n_images;
  pl.vec_w = rt::vector_width(pl);
  uint8_t* o = static_cast<uint8_t*>(out);
  const bool store_vec = rt::rows_aligned<kColorRun>(o, width);
  const rt::ColorGrid g = rt::color_grid(n_images, height, width);
  const dim3 grid(g.x, g.y, g.z);
  const dim3 block(kRunsX, kRowsY);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  rt::with_form(pl, [&](auto form) {
    using F = decltype(form);
    color_kernel<F::fh, F::fv><<<grid, block, 0, s>>>(
        pl, o, n_images, height, width, store_vec);
  });
  return cudaGetLastError();
}

}  // extern "C"
