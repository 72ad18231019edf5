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
// Output: (U, 64) f32, row-major pixel samples of each unit.
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "idct.cuh"

namespace {

constexpr int kUnits = 6;            // units of a thread's group
constexpr int kThreadsPerGroup = 8;  // 8 samples each
constexpr int kMaxStride = 6;        // units per MCU (bitstream.MAX_UPM)
constexpr int kMaxGroups = 48;       // per tile
constexpr int kMaxThreads = kMaxGroups * kThreadsPerGroup;  // 384
constexpr int kXStride = 65;         // padded row of x
constexpr int kSharedMatrices = 4;   // JPEG's quantization tables

// Groups per tile: the most, up to kMaxGroups, that is a multiple of the
// stride (whole blocks of kUnits * stride units) and fills whole warps.
int groups_for(int stride) {
  int groups = kMaxGroups - kMaxGroups % stride;
  while ((groups * kThreadsPerGroup) % 32 != 0) groups -= stride;
  return groups;
}

// Shared memory: the matrices (when staged), then a tile's coefficients
// as copied (int32) and their matrix ids, then the coefficients as f32 in
// padded rows and the ids.
int shared_bytes(bool shared_m, int nq, int tile) {
  return (shared_m ? nq * 64 * 64 * (int)sizeof(float) : 0) +
         tile * 64 * (int)sizeof(int32_t) + tile * (int)sizeof(int32_t) +
         tile * kXStride * (int)sizeof(float) + tile * (int)sizeof(int);
}

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

// Start copying tile `t`'s coefficients and matrix ids into raw, raw_rows.
__device__ __forceinline__ void fetch_tile(const int32_t* coeffs,
                                           const int32_t* unit_mrow,
                                           long long n_units, int tile,
                                           long long t, int32_t* raw,
                                           int32_t* raw_rows) {
  const long long u0 = t * tile;
  const int nu = (int)min((long long)tile, n_units - u0);
  for (int i = threadIdx.x; i < nu * 16; i += blockDim.x) {
    copy_async16(raw + i * 4, coeffs + u0 * 64 + i * 4);
  }
  for (int i = threadIdx.x; i < nu; i += blockDim.x) {
    copy_async4(raw_rows + i, unit_mrow + u0 + i);
  }
  asm volatile("cp.async.commit_group;\n");
}

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
  const long long n_tiles = (n_units + tile - 1) / tile;
  if (blockIdx.x < n_tiles) {
    fetch_tile(coeffs, unit_mrow, n_units, tile, blockIdx.x, raw, raw_rows);
  }
  const float* m = mt;
  if (kSharedM) {
    const float4* src = reinterpret_cast<const float4*>(mt);
    float4* dst = reinterpret_cast<float4*>(ms);
    for (int i = threadIdx.x; i < nq * 1024; i += blockDim.x) dst[i] = src[i];
    m = ms;  // the first tile's barrier orders these stores
  }
  const int g = threadIdx.x / kThreadsPerGroup;
  const int k0 = (threadIdx.x % kThreadsPerGroup) * 4;
  const int a = (g / stride) * kUnits * stride + g % stride;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long u0 = t * tile;
    const int nu = (int)min((long long)tile, n_units - u0);
    asm volatile("cp.async.wait_all;\n");
    __syncthreads();  // tile t has landed; the last tile's xs is free
    for (int i = threadIdx.x; i < nu * 16; i += blockDim.x) {
      const int4 v = reinterpret_cast<const int4*>(raw)[i];
      float* x = xs + (i >> 4) * kXStride + (i & 15) * 4;
      x[0] = (float)v.x;
      x[1] = (float)v.y;
      x[2] = (float)v.z;
      x[3] = (float)v.w;
    }
    for (int i = threadIdx.x; i < nu; i += blockDim.x) rows[i] = raw_rows[i];
    __syncthreads();  // xs ready, raw free
    if (t + gridDim.x < n_tiles) {  // the next tile lands while this computes
      fetch_tile(coeffs, unit_mrow, n_units, tile, t + gridDim.x, raw,
                 raw_rows);
    }
    if (a < nu) {
      // units past the tile's end compute on unit a and are not stored
      const float* xu[kUnits];
      const float* mqk[kUnits];
      bool same_q = true;
      const int q0 = rows[a];
#pragma unroll
      for (int i = 0; i < kUnits; ++i) {
        const int u = a + i * stride < nu ? a + i * stride : a;
        xu[i] = xs + u * kXStride;
        mqk[i] = m + rows[u] * 4096 + k0;
        same_q = same_q && rows[u] == q0;
      }
      float s[kUnits][8];
      rt::idct_group<kUnits>(xu, mqk, same_q, s);
#pragma unroll
      for (int i = 0; i < kUnits; ++i) {
        if (a + i * stride < nu) {
          float* dst = out + (u0 + a + i * stride) * 64 + k0;
          *reinterpret_cast<float4*>(dst) =
              make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
          *reinterpret_cast<float4*>(dst + 32) =
              make_float4(s[i][4], s[i][5], s[i][6], s[i][7]);
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
cudaError_t resident_blocks(int stride, int nq, int* slots) {
  static std::mutex mu;
  static bool opted_in[kMaxDevices];
  static int cache[kMaxDevices][kMaxStride + 1][kSharedMatrices + 1];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  const int q = kSharedM ? nq : 0;  // the global form's bytes ignore NQ
  std::lock_guard<std::mutex> lock(mu);
  int& cached = cache[device][stride][q];
  if (cached > 0) {
    *slots = cached;
    return cudaSuccess;
  }
  auto kernel = idct_kernel<kSharedM>;
  if (!opted_in[device]) {
    int most = 0;
    for (int s = 1; s <= kMaxStride; ++s) {
      const int b = shared_bytes(kSharedM, kSharedMatrices,
                                 groups_for(s) * kUnits);
      most = b > most ? b : most;
    }
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return err;
    opted_in[device] = true;
  }
  const int groups = groups_for(stride);
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, groups * kThreadsPerGroup,
        shared_bytes(kSharedM, q, groups * kUnits));
  }
  if (err != cudaSuccess) return err;
  *slots = cached = sms * (per_sm > 0 ? per_sm : 1);
  return cudaSuccess;
}

template <bool kSharedM>
cudaError_t launch(const int32_t* coeffs, const float* mt, int nq,
                   const int32_t* unit_mrow, float* out, long long n_units,
                   int stride, cudaStream_t stream) {
  const int groups = groups_for(stride);
  const int threads = groups * kThreadsPerGroup;
  const int tile = groups * kUnits;
  const int bytes = shared_bytes(kSharedM, nq, tile);
  int slots = 0;
  const cudaError_t err = resident_blocks<kSharedM>(stride, nq, &slots);
  if (err != cudaSuccess) return err;
  const long long n_tiles = (n_units + tile - 1) / tile;
  const int blocks = (int)(n_tiles < slots ? n_tiles : slots);
  idct_kernel<kSharedM><<<blocks, threads, bytes, stream>>>(
      coeffs, mt, nq, unit_mrow, out, n_units, stride, tile);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Units per tile at a stride, for the tests of a partial last tile.
int rt_idct_tile_units(int stride) {
  if (stride < 1 || stride > kMaxStride) return -1;
  return groups_for(stride) * kUnits;
}

// `stride`: the units a thread's 6 units lie apart, 1..6; the units per
// MCU of the batch's layout make them share their matrix. Any stride
// gives the same samples.
int rt_idct_units(const void* coeffs, const void* mt, int nq,
                  const void* unit_mrow, void* out, long long n_units,
                  int stride, void* stream) {
  if (n_units <= 0) return cudaSuccess;
  if (stride < 1 || stride > kMaxStride || nq < 1) {
    return cudaErrorInvalidValue;
  }
  auto c = static_cast<const int32_t*>(coeffs);
  auto m = static_cast<const float*>(mt);
  auto r = static_cast<const int32_t*>(unit_mrow);
  auto o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return nq <= kSharedMatrices
             ? launch<true>(c, m, nq, r, o, n_units, stride, s)
             : launch<false>(c, m, nq, r, o, n_units, stride, s);
}

}  // extern "C"
