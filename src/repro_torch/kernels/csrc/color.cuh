// The color kernel's body (color.cu): replicate upsample + BT.601 YCbCr ->
// RGB + clip(round) of a run of consecutive pixels of one output row.
//
// Output pixel (y, x) of image b takes component c's sample
// (y / fv[c], x / fh[c]) of its plane (core/decode.upsample_color). A run
// is kRun pixels starting at a multiple of kRun; the row's sample rows
// are found once per run, and no division is done inside the run:
//   * the standard forms (luma factors (1, 1), both chroma planes
//     (kFh, kFv) with factors 1 or 2: 4:2:0, 4:2:2, 4:4:4, 4:4:0) have
//     their factors as template constants, which fold to shifts. Luma
//     comes in with 16-byte loads, and each chroma sample is loaded once
//     for its kFh pixels, also with 16-byte loads, where every plane's
//     rows are 16-byte aligned and the run's samples lie within them
//     (x0 + kRun <= vec_w); else one sample at a time;
//   * the generic form (kFh = 0) reads every factor at run time: one
//     division per component where the run starts, then a counter per
//     component moves to the next sample every fh[c] pixels.
// The arithmetic is core/decode.ycbcr_to_rgb's, in its order, with one
// rounding per operation (nvcc would contract y + 1.402 * cr into an FMA;
// the host build takes -ffp-contract=off), and rintf rounds half to even
// like torch.round, so the result equals the plain version bit for bit.
// The run's 3 kRun bytes go out as 16-byte stores (8-byte ones where
// 3 kRun is not a multiple of 16) where every output row starts aligned
// to them (store_vec; then every run is whole). Otherwise the runs of a
// warp, consecutive in one row, are staged in shared memory and the warp
// writes their bytes out together, 4-byte aligned (copy_span).
//
// The functions are __host__ __device__ so that a host-only build of this
// header (g++, see tests/test_torch_color_layout.py) runs the same code
// on the CPU.
//
// The checked build (-DRT_CHECK, check.cuh) holds every sample read within
// its plane's rows (b * h[c] + ys of n * h[c]) and columns (w[c]), and
// every byte copy_span writes within its row, counting each byte written.
#pragma once

#include <math.h>
#include <stdint.h>

#include "check.cuh"

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

#ifdef __CUDACC__
#define RT_COLOR_UNROLL _Pragma("unroll")
#else
#define RT_COLOR_UNROLL
#endif

namespace rt {

#ifdef __CUDACC__
using F4 = float4;
using U4 = uint4;
using U2 = uint2;
#else
struct alignas(16) F4 {
  float x, y, z, w;
};
struct alignas(16) U4 {
  uint32_t x, y, z, w;
};
struct alignas(8) U2 {
  uint32_t x, y;
};
#endif

struct ColorPlanes {
  const float* p[3];  // (B, h[c], w[c]) f32 each
  int h[3], w[3];
  int fv[3], fh[3];   // replicate factors: output row y reads row y / fv
  int vec_w;          // runs with x0 + kRun <= vec_w load 16 bytes at once
  int n = 0x7fffffff; // images (the checked build's bound; unchecked default)
};

// one rounding per operation
__host__ __device__ __forceinline__ float mul_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

__host__ __device__ __forceinline__ float add_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}

__host__ __device__ __forceinline__ float sub_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}

__host__ __device__ __forceinline__ uint32_t to_u8(float v) {
  return (uint32_t)fminf(fmaxf(rintf(v), 0.f), 255.f);
}

__host__ __device__ __forceinline__ F4 load4(const float* p) {
#ifdef __CUDA_ARCH__
  return __ldg(reinterpret_cast<const float4*>(p));
#else
  return *reinterpret_cast<const F4*>(p);
#endif
}

// kN samples from row[x]: by 16-byte loads (`vec`), else the first n one
// at a time (the others 0); `w`: the row's samples (the checked bound)
template <int kN>
__host__ __device__ __forceinline__ void load_samples(const float* row,
                                                      int x, int n,
                                                      bool vec, float* s,
                                                      int w) {
  if (vec) {
    RT_COLOR_UNROLL
    for (int i = 0; i < kN / 4; ++i) {
      const F4 v = ok(x + 4 * i + 3, w, kSitePlane) ? load4(row + x + 4 * i)
                                                    : F4{};
      s[4 * i] = v.x;
      s[4 * i + 1] = v.y;
      s[4 * i + 2] = v.z;
      s[4 * i + 3] = v.w;
    }
  } else {
    RT_COLOR_UNROLL
    for (int i = 0; i < kN; ++i) {
      s[i] = i < n ? ld(row, x + i, w, kSitePlane) : 0.f;
    }
  }
}

// RGB of pixels x0 .. x0 + n - 1 (n <= kRun) of output row y of image b,
// as 3 kRun bytes packed little-endian into `words` (the bytes of pixels
// past n are not defined). (kFh, kFv): the chroma factors of a standard
// form, or kFh = 0 for the generic form.
template <int kRun, int kFh, int kFv>
__host__ __device__ __forceinline__ void color_run(const ColorPlanes& pl,
                                                   int b, int y, int x0,
                                                   int n,
                                                   uint32_t* words) {
  static_assert(kRun % 8 == 0, "a run is a multiple of 8 pixels");
  static_assert((kRun / (kFh ? kFh : 1)) % 4 == 0, "whole 16-byte loads");
  const float* row[3];
  RT_COLOR_UNROLL
  for (int c = 0; c < 3; ++c) {
    const int ys = kFh == 0 ? y / pl.fv[c] : (c == 0 ? y : y / kFv);
    int64_t r = (int64_t)b * pl.h[c] + ys;
    if (!ok(r, (int64_t)pl.n * pl.h[c], kSitePlaneRow)) r = 0;
    row[c] = pl.p[c] + r * pl.w[c];
  }
  float s[3][kRun];
  if constexpr (kFh != 0) {
    constexpr int kC = kRun / kFh;  // chroma samples of a run
    const bool vec = x0 + kRun <= pl.vec_w;
    load_samples<kRun>(row[0], x0, n, vec, s[0], pl.w[0]);
    float ch[2][kC];
    RT_COLOR_UNROLL
    for (int c = 1; c < 3; ++c) {
      load_samples<kC>(row[c], x0 / kFh, (n + kFh - 1) / kFh, vec,
                       ch[c - 1], pl.w[c]);
      RT_COLOR_UNROLL
      for (int j = 0; j < kRun; ++j) s[c][j] = ch[c - 1][j / kFh];
    }
  } else {
    int q[3], r[3];
    float cur[3];
    RT_COLOR_UNROLL
    for (int c = 0; c < 3; ++c) {
      q[c] = x0 / pl.fh[c];
      r[c] = x0 - q[c] * pl.fh[c];
      cur[c] = 0.f;
    }
    RT_COLOR_UNROLL
    for (int j = 0; j < kRun; ++j) {
      RT_COLOR_UNROLL
      for (int c = 0; c < 3; ++c) {
        if (j < n) {
          if (j == 0 || r[c] == 0) {
            cur[c] = ld(row[c], q[c], pl.w[c], kSitePlane);
          }
          if (++r[c] == pl.fh[c]) {
            r[c] = 0;
            ++q[c];
          }
        }
        s[c][j] = cur[c];
      }
    }
  }
  const float c_r = (float)1.402, c_gb = (float)0.344136286,
              c_gr = (float)0.714136286, c_b = (float)1.772;
  RT_COLOR_UNROLL
  for (int i = 0; i < 3 * kRun / 4; ++i) words[i] = 0;
  RT_COLOR_UNROLL
  for (int j = 0; j < kRun; ++j) {
    const float Y = s[0][j];
    const float cb = sub_rn(s[1][j], 128.f);
    const float cr = sub_rn(s[2][j], 128.f);
    const uint32_t rgb[3] = {
        to_u8(add_rn(Y, mul_rn(cr, c_r))),
        to_u8(sub_rn(sub_rn(Y, mul_rn(cb, c_gb)), mul_rn(cr, c_gr))),
        to_u8(add_rn(Y, mul_rn(cb, c_b)))};
    RT_COLOR_UNROLL
    for (int k = 0; k < 3; ++k) {
      const int i = 3 * j + k;
      words[i / 4] |= rgb[k] << (8 * (i % 4));
    }
  }
}

// The run's 3 kRun bytes to an aligned o: 16-byte stores, or 8-byte
// ones where 3 kRun is not a multiple of 16.
template <int kRun>
__host__ __device__ __forceinline__ void store_run(uint8_t* o,
                                                   const uint32_t* words) {
  constexpr int kWords = 3 * kRun / 4;
  if constexpr (kWords % 4 == 0) {
    U4* d = reinterpret_cast<U4*>(o);
    RT_COLOR_UNROLL
    for (int i = 0; i < kWords / 4; ++i) {
      d[i] = U4{words[4 * i], words[4 * i + 1], words[4 * i + 2],
                words[4 * i + 3]};
    }
  } else {
    U2* d = reinterpret_cast<U2*>(o);
    RT_COLOR_UNROLL
    for (int i = 0; i < kWords / 2; ++i) {
      d[i] = U2{words[2 * i], words[2 * i + 1]};
    }
  }
}

// One lane's share of writing `nbytes` staged bytes (`stage`, packed
// little-endian, with one word to spare past them) to o, at any
// alignment: the bytes before the first 4-byte boundary of o one at a
// time, then 4-byte stores (word k by lane k mod kLanes, so that a warp
// stores 128 consecutive bytes at once), then the last bytes one at a
// time. The checked build's bounds: `room`, the bytes writable from o
// (its row's), and `at`, o's byte in the covered output.
template <int kLanes>
__host__ __device__ __forceinline__ void copy_span(uint8_t* o,
                                                   const uint32_t* stage,
                                                   int nbytes, int lane,
                                                   int64_t room = INT64_MAX,
                                                   int64_t at = 0) {
  const uint8_t* bytes = reinterpret_cast<const uint8_t*>(stage);
  int head = (int)((4u - (uint32_t)(reinterpret_cast<uintptr_t>(o) & 3u)) &
                   3u);
  head = head < nbytes ? head : nbytes;
  if (lane < head && ok(lane, room, kSiteRgb)) {
    o[lane] = bytes[lane];
    cover(at + lane);
  }
  const int n_words = (nbytes - head) / 4;
  uint32_t* dst = reinterpret_cast<uint32_t*>(o + head);
  for (int k = lane; k < n_words; k += kLanes) {
    const uint64_t pair = ((uint64_t)stage[k + 1] << 32) | stage[k];
    if (ok(head + 4 * k + 3, room, kSiteRgb)) {
      dst[k] = (uint32_t)(pair >> (8 * head));
      cover(at + head + 4 * k, 4);
    }
  }
  const int tail = head + 4 * n_words + lane;
  if (lane < 4 && tail < nbytes && ok(tail, room, kSiteRgb)) {
    o[tail] = bytes[tail];
    cover(at + tail);
  }
}

// The bytes of the runs from x_w up to kLanes runs on (cut at width) in
// their output row
template <int kRun, int kLanes>
__host__ __device__ __forceinline__ int span_bytes(int x_w, int width) {
  const int end = x_w + kLanes * kRun < width ? x_w + kLanes * kRun : width;
  return 3 * (end - x_w);
}

// The start of output row y of image b in the (B, height, width, 3)
// uint8 output
__host__ __device__ __forceinline__ uint8_t* row_out(uint8_t* out, int b,
                                                     int y, int height,
                                                     int width) {
  return out + ((int64_t)b * height + y) * width * 3;
}

// -- host side: the form of a layout, and the 16-byte load width ---------

template <int kFh, int kFv>
struct Form {
  static constexpr int fh = kFh, fv = kFv;
};

// Calls f(Form<kFh, kFv>{}) with the form of the planes' factors: a
// standard one (luma (1, 1), both chroma planes alike with factors 1 or
// 2), else the generic Form<0, 0>.
template <class F>
inline void with_form(const ColorPlanes& pl, F f) {
  const bool standard = pl.fh[0] == 1 && pl.fv[0] == 1 &&
                        pl.fh[1] == pl.fh[2] && pl.fv[1] == pl.fv[2] &&
                        (pl.fh[1] == 1 || pl.fh[1] == 2) &&
                        (pl.fv[1] == 1 || pl.fv[1] == 2);
  if (!standard) return f(Form<0, 0>{});
  if (pl.fh[1] == 2) {
    if (pl.fv[1] == 2) return f(Form<2, 2>{});
    return f(Form<2, 1>{});
  }
  if (pl.fv[1] == 2) return f(Form<1, 2>{});
  return f(Form<1, 1>{});
}

// store_vec for runs of kRun pixels: every output row of the
// (B, height, width, 3) uint8 output starts aligned to store_run's vector
// stores (16 bytes, or 8 where 3 kRun is not a multiple of 16).
template <int kRun>
inline bool rows_aligned(const uint8_t* out, int width) {
  const int bytes = (3 * kRun / 4) % 4 == 0 ? 16 : 8;
  return reinterpret_cast<uintptr_t>(out) % bytes == 0 &&
         ((int64_t)width * 3) % bytes == 0;
}

// vec_w for runs of kRun pixels: a standard form's run may load its
// samples 16 bytes at a time when every plane's rows start 16-byte
// aligned and the run's samples lie within every plane's row
// (x0 + kRun <= w[c] * fh[c]); 0 where a plane is not aligned.
inline int vector_width(const ColorPlanes& pl) {
  int w = pl.w[0] * pl.fh[0];
  for (int c = 0; c < 3; ++c) {
    if ((reinterpret_cast<uintptr_t>(pl.p[c]) & 15) != 0 || pl.w[c] % 4) {
      return 0;
    }
    const int wc = pl.w[c] * pl.fh[c];
    w = wc < w ? wc : w;
  }
  return w;
}

}  // namespace rt
