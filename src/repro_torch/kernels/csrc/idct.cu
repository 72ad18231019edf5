// Dequant + de-zigzag + 2-D IDCT of every data unit on Hopper: the folded
// 64x64 product per unit, then clip(round(+128)).
//
// Replaces `fused_idct` (kernels/idct/idct.py of the JAX package), the
// first stage of the unfused pixel chain (fuse="none", and grayscale
// batches under every fuse mode). Each unit's sample k is
// sum_j x[u, j] * M[unit_mrow[u]][k, j] (idct.cuh); the JAX kernel
// computes every matrix q and selects, which gives the same value, and
// this kernel computes only the unit's own. The TPU kernel's two-unit
// pairing (to fill a 128-wide matrix unit) is gone.
//
// What bounds it on this card: the f32 pipes. Per unit it reads 64 int32
// coefficients and writes 64 f32 samples (512 B), a 0.24 ms byte bound for
// 1.57M units, and does 64*64 multiply-adds. Bit parity with the plain
// version rules out FMA contraction, TF32 and tensor cores (another order
// of summation), so each multiply-add is two f32 instructions: 8192 per
// unit, at one per lane per clock (33.5 T/s) a floor of about 0.38 ms for
// the same batch. Feeding them is the design's problem: an SM's shared
// memory hands its threads 32 words a clock, against 128 f32 lanes, so a
// thread must use each word it loads for at least two multiply-adds. A
// thread that computes samples of one unit uses each M word once.
//
// Design: a register tile of 6 units x 8 samples a thread (idct_group):
// per j, 6 words of x and 8 of M for 48 multiply-adds. The units must
// share their matrix to share the M words, so a thread takes units that
// lie `stride` apart: with stride = the units per MCU, the same component
// of 6 consecutive MCUs, one matrix except where an image with other
// tables begins (then each unit reads its own M words; same values, more
// loads). A block of 8 * groups threads (one block an SM: its shared
// memory) walks over tiles of 6 * groups units, grid-stride; thread t
// takes samples k0 = 4 (t % 8) .. +3 and k0 + 32 .. +35 of group g = t / 8,
// whose units are a + i * stride, i < 6, with
// a = (g / stride) * 6 stride + g % stride. The 8 threads of a group read
// one 128-byte run of an M row together (one wavefront, no bank conflict).
// The block stages all NQ folded matrices once, when NQ <= kSharedMatrices
// (16 KB each; a batch of baseline images with standard tables has 2),
// else reads them through L1. Each tile's coefficients and matrix ids are
// copied with cp.async while the tile before is computed, then converted
// to f32 rows padded to 65 floats (so the groups of a warp read distinct
// banks). A partial last tile's missing units are neither read nor
// written.
//
// Its times on the card, against the thread-per-sample version it
// replaces and the library call, are in PERF.md (chip_smoke.py).
//
// Launch size: `groups` thread groups a block (geometry.cuh launch_groups:
// 0 is groups_for(stride), the default; kernels/autotune.py's idct_groups
// candidates), a tile of 6 * groups units. The checked build (check.cuh)
// also guards the output stores, counts each output sample written
// (coverage), and holds the block's shared layout within its dynamic
// shared memory.
//
// Output: (U, 64) f32, row-major pixel samples of each unit.
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "idct.cuh"

namespace {

using rt::kMaxStride;
using rt::kMaxThreads;
using rt::kThreadsPerGroup;
using rt::kUnits;
using rt::kXStride;

constexpr int kSharedMatrices = 4;   // JPEG's quantization tables

template <bool kSharedM>
__global__ void __launch_bounds__(kMaxThreads)
idct_kernel(const int32_t* __restrict__ coeffs,
            const float* __restrict__ mt,  // (NQ, 64 j, 64 k)
            int nq, const int32_t* __restrict__ unit_mrow,
            float* __restrict__ out, long long n_units, int stride,
            int tile) {
  extern __shared__ __align__(16) float smem[];
  float* ms = smem;
  int32_t* raw = reinterpret_cast<int32_t*>(smem + (kSharedM ? nq * 4096 : 0));
  int32_t* raw_rows = raw + tile * 64;
  float* xs = reinterpret_cast<float*>(raw_rows + tile);
  int* rows = reinterpret_cast<int*>(xs + tile * kXStride);
  const long long n_tiles = rt::tiles_for(n_units, tile);
#ifdef RT_CHECK
  // the layout above must fit the block's shared memory
  rt::ok(rt::idct_shared_bytes(kSharedM, nq, tile) - 1,
         rt::dynamic_smem_bytes(), rt::kSiteTile);
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
  const int g = threadIdx.x / kThreadsPerGroup;
  const int k0 = (threadIdx.x % kThreadsPerGroup) * 4;
  const int a = rt::group_unit(g, 0, stride);
  const long long n_out = n_units * 64;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long u0 = t * tile;
    const int nu = (int)min((long long)tile, n_units - u0);
    asm volatile("cp.async.wait_all;\n");
    __syncthreads();  // tile t has landed; the last tile's xs is free
    rt::convert_tile(raw, raw_rows, nu, tile, xs, rows);
    __syncthreads();  // xs ready, raw free
    if (t + gridDim.x < n_tiles) {  // the next tile lands while this computes
      rt::fetch_tile(coeffs, unit_mrow, n_units, tile, t + gridDim.x, raw,
                     raw_rows);
    }
    if (a < nu) {
      float s[kUnits][8];
      rt::idct_tile_group(xs, rows, m, nq, a, stride, nu, k0, s);
#pragma unroll
      for (int i = 0; i < kUnits; ++i) {
        if (a + i * stride < nu) {
          const long long o = (u0 + a + i * stride) * 64 + k0;
          float* dst = out + o;
          if (rt::ok(o + 3, n_out, rt::kSiteSamples)) {
            *reinterpret_cast<float4*>(dst) =
                make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
            rt::cover(o, 4);
          }
          if (rt::ok(o + 35, n_out, rt::kSiteSamples)) {
            *reinterpret_cast<float4*>(dst + 32) =
                make_float4(s[i][4], s[i][5], s[i][6], s[i][7]);
            rt::cover(o + 32, 4);
          }
        }
      }
    }
  }
}

// The blocks that fit the card at once (SMs x blocks an SM) for a kernel
// form, device, stride and NQ, worked out at the first launch of each and
// kept: the shared-memory opt-in (set once per form and device, to the
// most any stride and NQ <= kSharedMatrices take) and the occupancy query
// are host calls whose answers do not change.
constexpr int kMaxDevices = 64;

template <bool kSharedM>
cudaError_t resident_blocks(int stride, int groups, int nq, int* slots) {
  static std::mutex mu;
  static bool opted_in[kMaxDevices];
  static int cache[kMaxDevices][kMaxStride + 1][rt::kMaxGroups + 1]
                  [kSharedMatrices + 1];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  const int q = kSharedM ? nq : 0;  // the global form's bytes ignore NQ
  std::lock_guard<std::mutex> lock(mu);
  int& cached = cache[device][stride][groups][q];
  if (cached > 0) {
    *slots = cached;
    return cudaSuccess;
  }
  auto kernel = idct_kernel<kSharedM>;
  if (!opted_in[device]) {
    int most = 0;
    for (int s = 1; s <= kMaxStride; ++s) {
      const int b = rt::idct_shared_bytes(
          kSharedM, kSharedMatrices, rt::tile_units(rt::groups_for(s)));
      most = b > most ? b : most;
    }
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return err;
    opted_in[device] = true;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, groups * kThreadsPerGroup,
        rt::idct_shared_bytes(kSharedM, q, rt::tile_units(groups)));
  }
  if (err != cudaSuccess) return err;
  *slots = cached = sms * (per_sm > 0 ? per_sm : 1);
  return cudaSuccess;
}

template <bool kSharedM>
cudaError_t launch(const int32_t* coeffs, const float* mt, int nq,
                   const int32_t* unit_mrow, float* out, long long n_units,
                   int stride, int groups, cudaStream_t stream) {
  const int threads = groups * kThreadsPerGroup;
  const int tile = rt::tile_units(groups);
  const int bytes = rt::idct_shared_bytes(kSharedM, nq, tile);
  int slots = 0;
  const cudaError_t err =
      resident_blocks<kSharedM>(stride, groups, nq, &slots);
  if (err != cudaSuccess) return err;
  const long long n_tiles = rt::tiles_for(n_units, tile);
  const int blocks = (int)(n_tiles < slots ? n_tiles : slots);
  idct_kernel<kSharedM><<<blocks, threads, bytes, stream>>>(
      coeffs, mt, nq, unit_mrow, out, n_units, stride, tile);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Units per tile at a stride and groups knob (0: the default), for the
// tests of a partial last tile; -1 for a knob the stride refuses.
int rt_idct_tile_units(int stride, int groups) {
  const int g = rt::launch_groups(groups, stride);
  return g < 0 ? -1 : rt::tile_units(g);
}

// `stride`: the units a thread's 6 units lie apart, 1..6; the units per
// MCU of the batch's layout make them share their matrix. Any stride
// gives the same samples. `groups`: the launch's thread groups a block
// (geometry.cuh launch_groups; 0 the default).
int rt_idct_units(const void* coeffs, const void* mt, int nq,
                  const void* unit_mrow, void* out, long long n_units,
                  int stride, int groups, void* stream) {
  const int g = rt::launch_groups(groups, stride);
  if (g < 0 || nq < 1) return cudaErrorInvalidValue;
  if (n_units <= 0) return cudaSuccess;
  auto c = static_cast<const int32_t*>(coeffs);
  auto m = static_cast<const float*>(mt);
  auto r = static_cast<const int32_t*>(unit_mrow);
  auto o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return nq <= kSharedMatrices
             ? launch<true>(c, m, nq, r, o, n_units, stride, g, s)
             : launch<false>(c, m, nq, r, o, n_units, stride, g, s);
}

}  // extern "C"
