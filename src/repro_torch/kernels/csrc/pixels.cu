// The fused post-entropy pixel stage on Hopper: from zig-zag coefficients
// to RGB, one launch.
//
// Replaces `fused_pixels_pallas` (kernels/fused/pixels.py of the JAX
// package): dequant + de-zigzag + IDCT as one 64x64 product per data unit
// with the folded operator M[unit_mrow], clip(round(+128)), per-MCU plane
// assembly, replicate chroma upsample and BT.601 color convert. The
// intermediate unit pixels and YCbCr planes live only in shared memory.
//
// What bounds it on this card: the f32 pipes, as for the IDCT kernel
// (idct.cu). Per 4:2:0 MCU it reads 6*64 int32 coefficients (1536 B) and
// writes 16*16*3 uint8 (768 B), and does 6*64*64 multiply-adds. Bit parity
// with the plain version (core/decode.folded_product and ycbcr_to_rgb)
// rules out FMA contraction, TF32 and tensor cores, so each multiply-add is
// a separate f32 multiply and add: two instructions a lane a clock, twice
// the f32 FMA bound. No library is called.
//
// Design: the IDCT kernel's, with a color stage behind it.
//   * First stage: the register tile of idct.cuh (idct_tile_group), 6
//     units x 8 samples a thread, over units one MCU apart (stride = the
//     units per MCU), which share a matrix; the folded matrices staged in
//     shared memory when NQ <= kSharedMatrices, else read through L1; each
//     tile's coefficients copied with cp.async while the tile before is
//     computed. A tile is whole MCUs (groups * 6 units, groups a multiple
//     of the units per MCU). Every sample is rt::idct_sample's: the sum
//     runs over j = 0..63 in order with __fmul_rn / __fadd_rn, and rintf
//     rounds half to even like torch.round.
//   * The unit pixels, exact integers in 0..255, are kept in shared memory
//     as uint8 (a quarter of f32's room), 4 samples a 32-bit store.
//   * Second stage: each thread takes 16 consecutive output pixels of an
//     MCU (its chunk; the same chunk of every MCU it visits), as two runs
//     of 8 pixels in one output row. A run reads one 8-sample unit row of
//     each component (pixels.cuh: row_source, col_source) as one 8-byte
//     load, with no integer division: the mapping folds into shifts for
//     the layouts with a kernel of their own (4:2:0, 4:2:2, 4:4:4) and is
//     a multiply and a shift for the generic one. The color arithmetic is
//     ycbcr_to_rgb's, in its order, each multiply and add rounded on its
//     own. The chunk's 48 bytes go out as three 16-byte stores: a tile's
//     MCUs are contiguous in `out`, and a chunk starts at a multiple of 48
//     bytes.
//
// Output: (n_mcus, 8*v_max, 8*h_max, 3) uint8; the wrapper reshapes and
// crops it to (B, H, W, 3).
//
// Launch size: `groups` thread groups a block (geometry.cuh launch_groups:
// 0 is groups_for(upm), the default; kernels/autotune.py's pixel_groups
// candidates), a tile of 6 * groups units, groups * 6 / upm MCUs. The
// checked build (check.cuh) also guards the unit pixels' shared stores and
// reads and the output stores, counts each output byte written
// (coverage), and holds the block's shared layout within its dynamic
// shared memory. There only, rt_fused_pixels_geometry launches the kernel
// with a tile and a grid the caller gives, as the JAX package's verifier
// launches the Pallas kernel with a misaligned tile (its self-test seed
// S3, kernels/seeds.py).
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "idct.cuh"
#include "pixels.cuh"

namespace {

using rt::kMaxThreads;
using rt::kThreadsPerGroup;
using rt::kUnits;
using rt::kXStride;
using rt::McuLayout;

constexpr int kMaxUpm = rt::kMaxStride;  // units per MCU (bitstream.MAX_UPM)
// matrices staged in shared memory: with the uint8 unit pixels, four would
// pass the 227 KB a block may have at the largest tile
constexpr int kSharedMatrices = 3;

__device__ __forceinline__ uint32_t to_u8(float v) {
  return (uint32_t)fminf(fmaxf(rintf(v), 0.f), 255.f);
}

// Four samples (integers in 0..255) as the bytes of one word.
__device__ __forceinline__ uint32_t pack4(float a, float b, float c,
                                          float d) {
  return __float2uint_rz(a) | __float2uint_rz(b) << 8 |
         __float2uint_rz(c) << 16 | __float2uint_rz(d) << 24;
}

// Byte `col` of an 8-sample row.
__device__ __forceinline__ float byte_of(unsigned long long row, int col) {
  return (float)(uint32_t)((row >> (8 * col)) & 0xFFu);
}

// One run of 8 output pixels (y, x0..x0+7) of an MCU whose unit pixels
// are `px`, as 24 RGB bytes into words w[12] from byte `b0` (0 or 24).
// `n_px`: the unit pixels' bytes from px on (the checked build's bound).
template <int kB0>
__device__ __forceinline__ void color_run(const McuLayout& l,
                                          const uint8_t* px, long long n_px,
                                          int y, int x0, uint32_t (&w)[12]) {
  unsigned long long row[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int src = rt::row_source(l, c, y, x0);
    row[c] = rt::ok(src + 7, n_px, rt::kSiteTile)
                 ? *reinterpret_cast<const unsigned long long*>(px + src)
                 : 0ull;
  }
  const float c_r = (float)1.402, c_gb = (float)0.344136286,
              c_gr = (float)0.714136286, c_b = (float)1.772;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int x = x0 + i;
    const float Y = byte_of(row[0], rt::col_source(l, 0, x));
    const float cb = __fsub_rn(byte_of(row[1], rt::col_source(l, 1, x)),
                               128.f);
    const float cr = __fsub_rn(byte_of(row[2], rt::col_source(l, 2, x)),
                               128.f);
    const float r = __fadd_rn(Y, __fmul_rn(cr, c_r));
    const float g = __fsub_rn(__fsub_rn(Y, __fmul_rn(cb, c_gb)),
                              __fmul_rn(cr, c_gr));
    const float b = __fadd_rn(Y, __fmul_rn(cb, c_b));
    const uint32_t rgb[3] = {to_u8(r), to_u8(g), to_u8(b)};
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const int byte = kB0 + 3 * i + ch;
      w[byte >> 2] |= rgb[ch] << (8 * (byte & 3));
    }
  }
}

template <bool kSharedM, int kKind>
__global__ void __launch_bounds__(kMaxThreads)
pixels_kernel(const int32_t* __restrict__ coeffs,
              const float* __restrict__ mt,  // (NQ, 64 j, 64 k)
              int nq, const int32_t* __restrict__ unit_mrow,
              uint8_t* __restrict__ out, McuLayout layout, long long n_mcus,
              int tile_mcus, long long grid_tiles) {
  // a standard layout is a constant, so its mapping folds into shifts
  constexpr McuLayout kFixed =
      rt::standard_layout(kKind == rt::kGeneric ? rt::k444 : kKind);
  const McuLayout l = kKind == rt::kGeneric ? layout : kFixed;
  extern __shared__ __align__(16) float smem[];
  const int tile = tile_mcus * l.upm;  // units
  float* ms = smem;
  int32_t* raw = reinterpret_cast<int32_t*>(smem + (kSharedM ? nq * 4096 : 0));
  int32_t* raw_rows = raw + tile * 64;
  float* xs = reinterpret_cast<float*>(raw_rows + tile);
  int* rows = reinterpret_cast<int*>(xs + tile * kXStride);
  uint8_t* px = reinterpret_cast<uint8_t*>(rows + tile);
  const long long n_units = n_mcus * l.upm;
#ifdef RT_CHECK
  // the layout above must fit the block's shared memory
  rt::ok(rt::pixels_shared_bytes(kSharedM, nq, tile) - 1,
         rt::dynamic_smem_bytes(), rt::kSiteTile);
  // the tiles the launch covers: every tile, or the grid that
  // rt_fused_pixels_geometry gives
  const long long n_tiles = grid_tiles;
#else
  // every tile, counted here: with the count as an argument the compiler
  // schedules the kernel otherwise, 1.4% slower (tools/kernel_times.py)
  const long long n_tiles = rt::tiles_for(n_mcus, tile_mcus);
#endif
  if (blockIdx.x < n_tiles) {
    rt::fetch_tile(coeffs, unit_mrow, n_units, tile, blockIdx.x, raw,
                   raw_rows);
  }
  const float* m = mt;
  if (kSharedM) {
    const float4* src = reinterpret_cast<const float4*>(mt);
    float4* dst = reinterpret_cast<float4*>(ms);
    const long long room = rt::dynamic_smem_bytes() / 16;  // checked build
    for (int i = threadIdx.x; i < nq * 1024; i += blockDim.x) {
      rt::st(dst, i, room, rt::kSiteTile, src[i]);
    }
    m = ms;  // the first tile's barrier orders these stores
  }
  // first stage: group g's units a + i * upm
  const int g = threadIdx.x / kThreadsPerGroup;
  const int k0 = (threadIdx.x % kThreadsPerGroup) * 4;
  const int a = rt::group_unit(g, 0, l.upm);
  // second stage: chunk c (16 pixels) of MCUs mc, mc + mstep, ...; its two
  // runs start at pixels 16 c and 16 c + 8 of the MCU, row-major
  const int mw = 8 * l.h_max;
  const int cpm = rt::chunks_per_mcu(l.h_max, l.v_max);
  const int mstep = blockDim.x / cpm;
  const int mc = threadIdx.x / cpm, c = threadIdx.x % cpm;
  const int y0 = 16 * c / mw, x0 = 16 * c % mw;
  const int y1 = (16 * c + 8) / mw, x1 = (16 * c + 8) % mw;
  const int mcu_bytes = 8 * l.v_max * mw * 3;
  const long long n_out = n_mcus * mcu_bytes;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long m0 = t * tile_mcus;
    const int tm = (int)min((long long)tile_mcus, n_mcus - m0);
    const int nu = tm * l.upm;
    asm volatile("cp.async.wait_all;\n");
    __syncthreads();  // tile t has landed; xs and px are free
    rt::convert_tile(raw, raw_rows, nu, tile, xs, rows);
    __syncthreads();  // xs ready, raw free
    if (t + gridDim.x < n_tiles) {  // the next tile lands while this computes
      rt::fetch_tile(coeffs, unit_mrow, n_units, tile, t + gridDim.x, raw,
                     raw_rows);
    }
    if (a < nu) {
      float s[kUnits][8];
      rt::idct_tile_group(xs, rows, m, nq, a, l.upm, nu, k0, s);
#pragma unroll
      for (int i = 0; i < kUnits; ++i) {
        if (a + i * l.upm < nu) {
          const int b = (a + i * l.upm) * 64 + k0;
          uint32_t* dst = reinterpret_cast<uint32_t*>(px + b);
          if (rt::ok(b + 3, tile * 64LL, rt::kSiteTile)) {
            dst[0] = pack4(s[i][0], s[i][1], s[i][2], s[i][3]);
          }
          if (rt::ok(b + 35, tile * 64LL, rt::kSiteTile)) {  // k0 + 32
            dst[8] = pack4(s[i][4], s[i][5], s[i][6], s[i][7]);
          }
        }
      }
    }
    __syncthreads();  // the tile's unit pixels are ready
    if (mc < mstep) {
      for (int mm = mc; mm < tm; mm += mstep) {
        const uint8_t* pm = px + mm * l.upm * 64;
        const long long n_pm = (long long)(tile - mm * l.upm) * 64;
        uint32_t w[12] = {};
        color_run<0>(l, pm, n_pm, y0, x0, w);
        color_run<24>(l, pm, n_pm, y1, x1, w);
        const long long o = (m0 + mm) * mcu_bytes + 48 * c;
        if (rt::ok(o + 47, n_out, rt::kSiteMcuOut)) {
          uint4* dst = reinterpret_cast<uint4*>(out + o);
          dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
          dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
          dst[2] = make_uint4(w[8], w[9], w[10], w[11]);
          rt::cover(o, 48);
        }
      }
    }
  }
}

// The blocks that fit the card at once (SMs x blocks an SM) for a kernel
// form, device, layout and NQ, worked out at the first launch of each and
// kept, with the shared-memory opt-in (once per form and device, to the
// most any layout and NQ <= kSharedMatrices take): host calls whose
// answers do not change.
constexpr int kMaxDevices = 64;

template <bool kSharedM, int kKind>
cudaError_t resident_blocks(int upm, int groups, int nq, int* slots) {
  static std::mutex mu;
  static bool opted_in[kMaxDevices];
  static int cache[kMaxDevices][kMaxUpm + 1][rt::kMaxGroups + 1]
                  [kSharedMatrices + 1];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  const int q = kSharedM ? nq : 0;  // the global form's bytes ignore NQ
  std::lock_guard<std::mutex> lock(mu);
  int& cached = cache[device][upm][groups][q];
  if (cached > 0) {
    *slots = cached;
    return cudaSuccess;
  }
  auto kernel = pixels_kernel<kSharedM, kKind>;
  if (!opted_in[device]) {
    int most = 0;
    for (int u = 3; u <= kMaxUpm; ++u) {
      const int b = rt::pixels_shared_bytes(
          kSharedM, kSharedMatrices, rt::tile_units(rt::groups_for(u)));
      most = b > most ? b : most;
    }
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return err;
    opted_in[device] = true;
  }
  const int threads = groups * kThreadsPerGroup;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, threads,
        rt::pixels_shared_bytes(kSharedM, q, rt::tile_units(groups)));
  }
  if (err != cudaSuccess) return err;
  *slots = cached = sms * (per_sm > 0 ? per_sm : 1);
  return cudaSuccess;
}

// The launch's geometry: `groups` thread groups a block over tiles of
// tile_mcus MCUs. The release entry takes tile_mcus = groups * 6 / upm
// and blocks = 0: as many blocks as fit the card, at most one a tile,
// walking every tile. Only the checked build's rt_fused_pixels_geometry
// gives its own tile_mcus (at most the groups' tile) and blocks, which
// are then the tiles the launch covers, the Pallas grid.
struct Geometry {
  int groups;
  int tile_mcus;
  int blocks;
};

template <bool kSharedM, int kKind>
cudaError_t launch(const int32_t* coeffs, const float* mt, int nq,
                   const int32_t* unit_mrow, uint8_t* out,
                   const McuLayout& l, long long n_mcus, const Geometry& geo,
                   cudaStream_t stream) {
  const int tile = rt::tile_units(geo.groups);
  int slots = 0;
  const cudaError_t err =
      resident_blocks<kSharedM, kKind>(l.upm, geo.groups, nq, &slots);
  if (err != cudaSuccess) return err;
  long long n_tiles = rt::tiles_for(n_mcus, geo.tile_mcus);
  int blocks = (int)(n_tiles < slots ? n_tiles : slots);
  if (geo.blocks > 0) blocks = (int)(n_tiles = geo.blocks);
  pixels_kernel<kSharedM, kKind>
      <<<blocks, geo.groups * kThreadsPerGroup,
         rt::pixels_shared_bytes(kSharedM, nq, tile), stream>>>(
          coeffs, mt, nq, unit_mrow, out, l, n_mcus, geo.tile_mcus, n_tiles);
  return cudaGetLastError();
}

template <int kKind>
cudaError_t launch_kind(const int32_t* coeffs, const float* mt, int nq,
                        const int32_t* unit_mrow, uint8_t* out,
                        const McuLayout& l, long long n_mcus,
                        const Geometry& geo, cudaStream_t stream) {
  return nq <= kSharedMatrices
             ? launch<true, kKind>(coeffs, mt, nq, unit_mrow, out, l, n_mcus,
                                   geo, stream)
             : launch<false, kKind>(coeffs, mt, nq, unit_mrow, out, l,
                                    n_mcus, geo, stream);
}

bool same_layout(const McuLayout& a, const McuLayout& b) {
  for (int c = 0; c < 3; ++c) {
    if (a.comp_h[c] != b.comp_h[c] || a.comp_off[c] != b.comp_off[c] ||
        a.recip_h[c] != b.recip_h[c] || a.recip_v[c] != b.recip_v[c]) {
      return false;
    }
  }
  return a.upm == b.upm && a.h_max == b.h_max && a.v_max == b.v_max;
}


// The layout of the factors comp_h, comp_v (each must divide the largest,
// the units per MCU at most 6), or false.
bool layout_of(const int* comp_h, const int* comp_v, McuLayout* l) {
  // the factors are checked before make_layout divides by them
  int h_max = 0, v_max = 0, upm = 0;
  for (int c = 0; c < 3; ++c) {
    if (comp_h[c] < 1 || comp_v[c] < 1 || comp_h[c] > kMaxUpm ||
        comp_v[c] > kMaxUpm) {
      return false;
    }
    h_max = comp_h[c] > h_max ? comp_h[c] : h_max;
    v_max = comp_v[c] > v_max ? comp_v[c] : v_max;
    upm += comp_h[c] * comp_v[c];
  }
  for (int c = 0; c < 3; ++c) {
    if (h_max % comp_h[c] || v_max % comp_v[c]) return false;
  }
  if (upm > kMaxUpm) return false;
  *l = rt::make_layout(comp_h[0], comp_v[0], comp_h[1], comp_v[1], comp_h[2],
                       comp_v[2]);
  return true;
}

cudaError_t run(const void* coeffs, const void* mt, int nq,
                const void* unit_mrow, void* out, long long n_mcus,
                const McuLayout& l, const Geometry& geo, void* stream) {
  auto c = static_cast<const int32_t*>(coeffs);
  auto m = static_cast<const float*>(mt);
  auto r = static_cast<const int32_t*>(unit_mrow);
  auto o = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (same_layout(l, rt::standard_layout(rt::k420))) {
    return launch_kind<rt::k420>(c, m, nq, r, o, l, n_mcus, geo, s);
  }
  if (same_layout(l, rt::standard_layout(rt::k422))) {
    return launch_kind<rt::k422>(c, m, nq, r, o, l, n_mcus, geo, s);
  }
  if (same_layout(l, rt::standard_layout(rt::k444))) {
    return launch_kind<rt::k444>(c, m, nq, r, o, l, n_mcus, geo, s);
  }
  return launch_kind<rt::kGeneric>(c, m, nq, r, o, l, n_mcus, geo, s);
}

}  // namespace

extern "C" {

// MCUs per tile of a layout with `upm` units per MCU at a groups knob (0:
// the default), for the tests of a partial last tile; -1 for a knob the
// layout refuses.
int rt_pixels_tile_mcus(int upm, int groups) {
  if (upm < 3 || upm > kMaxUpm) return -1;
  const int g = rt::launch_groups(groups, upm);
  return g < 0 ? -1 : rt::tile_units(g) / upm;
}

// comp_h, comp_v: the three components' sampling factors; each must divide
// the largest, and the units per MCU be at most 6. `groups`: the launch's
// thread groups a block (geometry.cuh launch_groups; 0 the default).
int rt_fused_pixels(const void* coeffs, const void* mt, int nq,
                    const void* unit_mrow, void* out, long long n_mcus,
                    const int* comp_h, const int* comp_v, int groups,
                    void* stream) {
  McuLayout l;
  if (!layout_of(comp_h, comp_v, &l) || nq < 1) return cudaErrorInvalidValue;
  const int g = rt::launch_groups(groups, l.upm);
  if (g < 0) return cudaErrorInvalidValue;
  if (n_mcus <= 0) return cudaSuccess;
  return run(coeffs, mt, nq, unit_mrow, out, n_mcus, l,
             Geometry{g, rt::tile_units(g) / l.upm, 0}, stream);
}

#ifdef RT_CHECK
// The checked build only: the kernel launched over `blocks` tiles of
// `tile_mcus` MCUs (at most the default tile's), one block a tile, as the
// Pallas kernel runs over its grid. A grid that does not cover n_mcus
// leaves the rest unwritten, which the coverage count shows.
int rt_fused_pixels_geometry(const void* coeffs, const void* mt, int nq,
                             const void* unit_mrow, void* out,
                             long long n_mcus, const int* comp_h,
                             const int* comp_v, int tile_mcus, int blocks,
                             void* stream) {
  McuLayout l;
  if (!layout_of(comp_h, comp_v, &l) || nq < 1) return cudaErrorInvalidValue;
  const int g = rt::groups_for(l.upm);
  if (tile_mcus < 1 || tile_mcus * l.upm > rt::tile_units(g) || blocks < 1) {
    return cudaErrorInvalidValue;
  }
  if (n_mcus <= 0) return cudaSuccess;
  return run(coeffs, mt, nq, unit_mrow, out, n_mcus, l,
             Geometry{g, tile_mcus, blocks}, stream);
}
#endif

}  // extern "C"
