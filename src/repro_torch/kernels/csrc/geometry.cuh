// Launch geometry of every kernel: the arithmetic that decides how many
// blocks a launch takes and which items each block and thread covers.
//
// The kernels (huffman.cu, idct.cu, pixels.cu, color.cu) and the host
// verifier share these functions: `python -m repro_torch.analysis kernels`
// builds this header with g++ and checks, for every bucket-ladder rung up
// to the largest batch and every launch candidate of kernels/autotune.py,
// that the blocks cover the lanes, units and MCUs exactly and that the
// persistent loops of the IDCT and pixel kernels reach every tile
// (analysis/kernel_check.py, the counterpart of the JAX verifier's
// check_tiling and check_ladder_alignment). No CUDA intrinsic appears
// here, so a host build runs the same code.
#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

namespace rt {

// -- the Huffman kernels: one thread per chunk lane -------------------------

// the launch sizes each kernel is instantiated for (kernels/autotune.py's
// candidates); a value outside these is refused with cudaErrorInvalidValue
constexpr int kExitThreadChoices[] = {128, 256, 512};
constexpr int kStreamThreadChoices[] = {256, 512, 1024};
constexpr int kStoreThreadChoices[] = {128, 256};

// the store kernel's writer of whole units: by lane count (auto), each
// lane its own (lane) or the warp together (warp)
enum StoreWriter { kWriterAuto = 0, kWriterLane = 1, kWriterWarp = 2 };

// blocks of `threads` threads that cover `n` items, one a thread
__host__ __device__ __forceinline__ long long blocks_for(long long n,
                                                        int threads) {
  return (n + threads - 1) / threads;
}

// the store kernel's unit slots: 64 int32 a thread, kSlotStride apart (a
// thread's slot row by row; 66 keeps rows 8-byte aligned and moves each
// row two banks on from the last one's)
constexpr int kSlotStride = 66;

__host__ __device__ constexpr int store_slot_bytes(int threads) {
  return kSlotStride * (int)sizeof(int32_t) * threads;
}

// whether the store kernel's writer choice takes the warp's writes: auto
// picks them when the lanes fill at least a warp an SM; `warp` is refused
// (-1) where the launch has fewer lanes than a warp
__host__ __device__ __forceinline__ int store_warp_units(int writer,
                                                         int n_lanes,
                                                         int sms) {
  if (writer == kWriterAuto) return n_lanes >= 32 * sms ? 1 : 0;
  if (writer == kWriterLane) return 0;
  if (writer == kWriterWarp) return n_lanes >= 32 ? 1 : -1;
  return -1;
}

// -- the IDCT and pixel kernels: tiles of thread groups ---------------------
//
// A thread group of kThreadsPerGroup threads computes kUnits units that lie
// `stride` units apart: group g of a tile takes units group_unit(g, i,
// stride), i < kUnits. A tile of groups * kUnits units (groups a multiple
// of stride) is then covered once.

constexpr int kUnits = 6;            // units of a thread's group
constexpr int kThreadsPerGroup = 8;  // 8 samples each
constexpr int kMaxGroups = 48;       // per tile
constexpr int kMaxThreads = kMaxGroups * kThreadsPerGroup;  // 384
constexpr int kXStride = 65;         // padded row of x (floats)
constexpr int kMaxStride = 6;        // units per MCU (bitstream.MAX_UPM)

// Groups per tile by default: the most, up to kMaxGroups, that is a
// multiple of the stride (whole blocks of kUnits * stride units) and fills
// whole warps.
__host__ __device__ __forceinline__ int groups_for(int stride) {
  int groups = kMaxGroups - kMaxGroups % stride;
  while ((groups * kThreadsPerGroup) % 32 != 0) groups -= stride;
  return groups;
}

// The groups of a launch for a knob value: 0 is groups_for(stride); any
// other value must be a multiple of the stride that fills whole warps and
// is at most kMaxGroups. -1 where it is not (or the stride is out of
// 1..kMaxStride).
__host__ __device__ __forceinline__ int launch_groups(int knob, int stride) {
  if (stride < 1 || stride > kMaxStride) return -1;
  if (knob == 0) return groups_for(stride);
  if (knob < 0 || knob > kMaxGroups || knob % stride != 0 ||
      (knob * kThreadsPerGroup) % 32 != 0) {
    return -1;
  }
  return knob;
}

// the unit of a tile that group g's i-th unit is
__host__ __device__ __forceinline__ int group_unit(int g, int i, int stride) {
  return (g / stride) * kUnits * stride + g % stride + i * stride;
}

// units a tile of `groups` groups
__host__ __device__ __forceinline__ int tile_units(int groups) {
  return groups * kUnits;
}

// tiles of `tile` items over n items
__host__ __device__ __forceinline__ long long tiles_for(long long n,
                                                       long long tile) {
  return (n + tile - 1) / tile;
}

// Shared memory of the IDCT kernel: the matrices (when staged), then a
// tile's coefficients as copied (int32) and their matrix ids, then the
// coefficients as f32 in padded rows and the ids.
__host__ __device__ __forceinline__ int idct_shared_bytes(bool shared_m,
                                                          int nq, int tile) {
  return (shared_m ? nq * 64 * 64 * (int)sizeof(float) : 0) +
         tile * 64 * (int)sizeof(int32_t) + tile * (int)sizeof(int32_t) +
         tile * kXStride * (int)sizeof(float) + tile * (int)sizeof(int);
}

// The pixel kernel's: the IDCT kernel's, then the unit pixels (uint8).
// Every part is a multiple of 8 bytes (a tile is a multiple of 6 units), so
// the unit pixels' rows are 8-byte aligned.
__host__ __device__ __forceinline__ int pixels_shared_bytes(bool shared_m,
                                                            int nq,
                                                            int tile) {
  return idct_shared_bytes(shared_m, nq, tile) + tile * 64;
}

// The pixel kernel's second stage: a thread takes chunk c (16 pixels) of
// MCUs mc, mc + mstep, ...: cpm chunks an MCU of 8 v_max x 8 h_max pixels.
__host__ __device__ __forceinline__ int chunks_per_mcu(int h_max, int v_max) {
  return 4 * h_max * v_max;
}

// -- the color kernel: runs of pixels over a grid of (runs, rows, images) ---

constexpr int kColorRun = 8;   // pixels a thread
constexpr int kRunsX = 32;     // a block: a warp of kRunsX runs across ...
constexpr int kRowsY = 8;      // ... x kRowsY rows
constexpr int kMaxGrid = 65535;

struct ColorGrid {
  int x, y, z;
};

// The color kernel's grid: blocks across the runs of a row; rows and
// images are stride loops past kMaxGrid.
__host__ __device__ __forceinline__ ColorGrid color_grid(int n_images,
                                                         int height,
                                                         int width) {
  const int runs = (width + kColorRun - 1) / kColorRun;
  const int rows = (height + kRowsY - 1) / kRowsY;
  return ColorGrid{(runs + kRunsX - 1) / kRunsX,
                   rows < kMaxGrid ? rows : kMaxGrid,
                   n_images < kMaxGrid ? n_images : kMaxGrid};
}

}  // namespace rt
