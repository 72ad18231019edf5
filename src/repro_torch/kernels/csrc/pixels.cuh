// Where each output pixel of an MCU takes its three samples from: the
// pixel kernel's (pixels.cu) plane assembly and replicate upsample, as
// index arithmetic within one MCU's unit pixels.
//
// An MCU of a 3-component layout holds upm = sum(h_c * v_c) units,
// component-blocked (component 0's v_0 x h_0 units row-major, then
// component 1's, ...), and covers 8 v_max x 8 h_max output pixels. Output
// pixel (y, x) takes component c's sample (y / fv_c, x / fh_c) with
// fv_c = v_max / v_c and fh_c = h_max / h_c (replicate upsample):
//   unit = comp_off[c] + (ys >> 3) * h_c + (xs >> 3), offset (ys & 7) * 8 +
//   (xs & 7) in the unit's 64 row-major samples.
// The index math of fused_pixels_plain (kernels/fused/pixels.py):
// tests/test_torch_pixel_layout.py runs these functions in a g++ build
// for every layout the fused path accepts and compares.
//
// No integer division at run time: a quotient n / d is (n * recip) >> 16
// with recip = ceil(2^16 / d), exact for n < 1024 and d <= 64 (the error
// n * (recip * d - 2^16) / (d 2^16) stays under 1/d). Here n < 32 and
// d <= 4. For a layout known at compile time (standard_layout) the
// compiler folds it into a shift.
//
// The functions are __host__ __device__ so that a host-only build (g++)
// runs the same code on the CPU.
#pragma once

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

namespace rt {

struct McuLayout {
  int upm;            // units per MCU
  int h_max, v_max;   // output pixels: 8 v_max x 8 h_max
  int comp_h[3];      // units across, per component
  int comp_off[3];    // first unit of each component within the MCU
  int recip_h[3];     // ceil(2^16 / fh_c), fh_c = h_max / comp_h[c]
  int recip_v[3];     // ceil(2^16 / fv_c)
};

__host__ __device__ constexpr int recip16(int d) {
  return (65536 + d - 1) / d;
}

__host__ __device__ __forceinline__ int div_small(int n, int recip) {
  return (n * recip) >> 16;
}

// The layout of components with sampling factors (comp_h[c], comp_v[c]).
// Every factor must divide the largest (the fused path's precondition).
__host__ __device__ constexpr McuLayout make_layout(int h0, int v0, int h1,
                                                    int v1, int h2, int v2) {
  McuLayout l{};
  const int h[3] = {h0, h1, h2}, v[3] = {v0, v1, v2};
  l.h_max = h0 > h1 ? (h0 > h2 ? h0 : h2) : (h1 > h2 ? h1 : h2);
  l.v_max = v0 > v1 ? (v0 > v2 ? v0 : v2) : (v1 > v2 ? v1 : v2);
  int off = 0;
  for (int c = 0; c < 3; ++c) {
    l.comp_h[c] = h[c];
    l.comp_off[c] = off;
    l.recip_h[c] = recip16(l.h_max / h[c]);
    l.recip_v[c] = recip16(l.v_max / v[c]);
    off += h[c] * v[c];
  }
  l.upm = off;
  return l;
}

// The layouts with a kernel of their own; kGeneric takes the layout at run
// time.
enum LayoutKind { k420 = 0, k422 = 1, k444 = 2, kGeneric = 3 };

__host__ __device__ constexpr McuLayout standard_layout(int kind) {
  return kind == k420   ? make_layout(2, 2, 1, 1, 1, 1)
         : kind == k422 ? make_layout(2, 1, 1, 1, 1, 1)
                        : make_layout(1, 1, 1, 1, 1, 1);
}

// The first sample of component c's row that output row y reads, as an
// index into the MCU's unit pixels: unit * 64 + (ys & 7) * 8, for the
// unit column of output column x. An 8-pixel run of output columns x0..
// x0+7 (x0 a multiple of 8) lies in one unit column of every component
// (8 fh_c is a multiple of 8), so the run reads one 8-sample row.
__host__ __device__ __forceinline__ int row_source(const McuLayout& l, int c,
                                                   int y, int x) {
  const int ys = div_small(y, l.recip_v[c]);
  const int xs = div_small(x, l.recip_h[c]);
  return (l.comp_off[c] + (ys >> 3) * l.comp_h[c] + (xs >> 3)) * 64 +
         (ys & 7) * 8;
}

// The sample's column within that row.
__host__ __device__ __forceinline__ int col_source(const McuLayout& l, int c,
                                                   int x) {
  return div_small(x, l.recip_h[c]) & 7;
}

// Output pixel (y, x) of the MCU takes component c from this index of its
// unit pixels (unit * 64 + offset).
__host__ __device__ __forceinline__ int pixel_source(const McuLayout& l,
                                                     int c, int y, int x) {
  return row_source(l, c, y, x) + col_source(l, c, x);
}

}  // namespace rt
