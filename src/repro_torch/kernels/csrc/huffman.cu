// Huffman subsequence decoding on Hopper: the exit, stream and store kernels.
//
// Replaces three Pallas kernels of the JAX package:
//   rt_decode_exits   <- decode_exits_pallas         (kernels/huffman/huffman.py)
//   rt_decode_streams <- decode_coeffs_pallas        (kernels/huffman/huffman.py)
//   rt_decode_store   <- decode_coeffs_store_pallas  (kernels/fused/store.py)
//
// Layout: one thread per chunk lane, the paper's own layout. Each thread
// runs up to s_max symbol steps (huffman.cuh) from its entry state and
// stops once p >= limit, which is exact because p only grows; the loop
// bound stays s_max as in the Pallas kernels.
//
// What bounds it on this card: not bytes. A chunk of 1024 bits is read as
// 34 words, but each symbol step is a chain of dependent integer
// operations (window, LUT load, shifts, state update) with one L2-latency
// LUT load on it, so the kernels are bound by latency and divergence: the
// lanes of a warp finish after different numbers of symbols. The design
// does three things about it:
//   * no word pre-gather (the Pallas wrapper copies each chunk's words
//     into a (C, W) tile): words are read in place, clamped to the last
//     word as JAX clamps its gathers;
//   * the LUTs are read through __ldg from global memory. One LUT is
//     256 KiB, more than one SM's shared memory, so they stay L2-resident
//     (a batch has 2-4 of them);
//   * the stream kernel writes its (pos, val) rows step-major, (s_max, C),
//     so that the 32 lanes of a warp store to consecutive addresses.
// The store kernel needs no atomics: once the entries have converged the
// lanes' coefficient ranges are disjoint and positions within a lane
// strictly increase (the scatter-race proof, docs/KERNELS.md).
//
// Every entry point returns cudaGetLastError() after its launch.
#include <cuda_runtime.h>
#include <stdint.h>

#include "huffman.cuh"

namespace {

constexpr int kThreads = 128;

struct LaneInputs {
  const uint32_t* words;
  int n_words;
  const int32_t* luts;      // (L, 65536)
  const int32_t* lut_rows;  // (TS, kMaxUpm, 2) unit_lut_row
  const int32_t* word_base; // (C,) segment word base per lane
  const int32_t* ts;        // (C,) tableset per lane
  const int32_t* limit;     // (C,) segment-relative end bit
  const int32_t* upm;       // (C,) units per MCU
  const int32_t* in_p;      // (C,) entry state
  const int32_t* in_u;
  const int32_t* in_z;
  int n_lanes;
  int s_max;
  int min_code_bits;
};

__device__ __forceinline__ rt::StepOut step(const LaneInputs& a,
                                            const int32_t* rows, int wb,
                                            int limit, int upm,
                                            rt::LaneState& st) {
  return rt::symbol_step(a.words, a.n_words, a.luts, rows, wb, limit, upm,
                         a.min_code_bits, st);
}

__global__ void __launch_bounds__(kThreads)
exits_kernel(LaneInputs a, int32_t* __restrict__ out_p,
             int32_t* __restrict__ out_u, int32_t* __restrict__ out_z,
             int32_t* __restrict__ out_n) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.n_lanes) return;
  const int32_t* rows = a.lut_rows + (int64_t)a.ts[lane] * (2 * rt::kMaxUpm);
  const int wb = a.word_base[lane], limit = a.limit[lane], upm = a.upm[lane];
  rt::LaneState st{a.in_p[lane], a.in_u[lane], a.in_z[lane], 0};
  for (int i = 0; i < a.s_max && st.p < limit; ++i) {
    step(a, rows, wb, limit, upm, st);
  }
  out_p[lane] = st.p;
  out_u[lane] = st.u;
  out_z[lane] = st.z;
  out_n[lane] = st.n;
}

// pos[i, lane] = local zig-zag offset written by step i (-1: nothing),
// val[i, lane] = its coefficient (0 where pos is -1); both (s_max, C).
__global__ void __launch_bounds__(kThreads)
streams_kernel(LaneInputs a, int32_t* __restrict__ pos,
               int32_t* __restrict__ val) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.n_lanes) return;
  const int32_t* rows = a.lut_rows + (int64_t)a.ts[lane] * (2 * rt::kMaxUpm);
  const int wb = a.word_base[lane], limit = a.limit[lane], upm = a.upm[lane];
  rt::LaneState st{a.in_p[lane], a.in_u[lane], a.in_z[lane], 0};
  const int64_t c = a.n_lanes;
  int i = 0;
  for (; i < a.s_max && st.p < limit; ++i) {
    const int n = st.n;
    const rt::StepOut o = step(a, rows, wb, limit, upm, st);
    pos[i * c + lane] = o.invalid ? -1 : n + o.run_eff;
    val[i * c + lane] = o.invalid ? 0 : o.coef;
  }
  for (; i < a.s_max; ++i) {  // the lane has finished: nothing recorded
    pos[i * c + lane] = -1;
    val[i * c + lane] = 0;
  }
}

// Stores each recorded coefficient at write_base + n + run_eff into `coef`
// (zeroed by the caller), under the mask of the JAX store kernel:
// recorded step, pos >= 0, 0 <= target <= write_max; targets past the
// buffer are dropped as well.
__global__ void __launch_bounds__(kThreads)
store_kernel(LaneInputs a, const int32_t* __restrict__ write_base,
             const int32_t* __restrict__ write_max,
             int32_t* __restrict__ coef, int64_t n_coef) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.n_lanes) return;
  const int32_t* rows = a.lut_rows + (int64_t)a.ts[lane] * (2 * rt::kMaxUpm);
  const int wb = a.word_base[lane], limit = a.limit[lane], upm = a.upm[lane];
  const int base = write_base[lane], wmax = write_max[lane];
  rt::LaneState st{a.in_p[lane], a.in_u[lane], a.in_z[lane], 0};
  for (int i = 0; i < a.s_max && st.p < limit; ++i) {
    const int n = st.n;
    const rt::StepOut o = step(a, rows, wb, limit, upm, st);
    const int p = n + o.run_eff;
    const int tgt = base + p;
    if (!o.invalid && p >= 0 && tgt >= 0 && tgt <= wmax && tgt < n_coef) {
      coef[tgt] = o.coef;
    }
  }
}

LaneInputs lane_inputs(const void* words, int n_words, const void* luts,
                       const void* lut_rows, const void* word_base,
                       const void* ts, const void* limit, const void* upm,
                       const void* in_p, const void* in_u, const void* in_z,
                       int n_lanes, int s_max, int min_code_bits) {
  LaneInputs a;
  a.words = static_cast<const uint32_t*>(words);
  a.n_words = n_words;
  a.luts = static_cast<const int32_t*>(luts);
  a.lut_rows = static_cast<const int32_t*>(lut_rows);
  a.word_base = static_cast<const int32_t*>(word_base);
  a.ts = static_cast<const int32_t*>(ts);
  a.limit = static_cast<const int32_t*>(limit);
  a.upm = static_cast<const int32_t*>(upm);
  a.in_p = static_cast<const int32_t*>(in_p);
  a.in_u = static_cast<const int32_t*>(in_u);
  a.in_z = static_cast<const int32_t*>(in_z);
  a.n_lanes = n_lanes;
  a.s_max = s_max;
  a.min_code_bits = min_code_bits;
  return a;
}

int blocks_for(int n_lanes) { return (n_lanes + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

int rt_decode_exits(const void* words, int n_words, const void* luts,
                    const void* lut_rows, const void* word_base,
                    const void* ts, const void* limit, const void* upm,
                    const void* in_p, const void* in_u, const void* in_z,
                    void* out_p, void* out_u, void* out_z, void* out_n,
                    int n_lanes, int s_max, int min_code_bits, void* stream) {
  if (n_lanes <= 0) return cudaSuccess;
  LaneInputs a = lane_inputs(words, n_words, luts, lut_rows, word_base, ts,
                             limit, upm, in_p, in_u, in_z, n_lanes, s_max,
                             min_code_bits);
  exits_kernel<<<blocks_for(n_lanes), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<int32_t*>(out_p), static_cast<int32_t*>(out_u),
      static_cast<int32_t*>(out_z), static_cast<int32_t*>(out_n));
  return cudaGetLastError();
}

int rt_decode_streams(const void* words, int n_words, const void* luts,
                      const void* lut_rows, const void* word_base,
                      const void* ts, const void* limit, const void* upm,
                      const void* in_p, const void* in_u, const void* in_z,
                      void* pos, void* val, int n_lanes, int s_max,
                      int min_code_bits, void* stream) {
  if (n_lanes <= 0) return cudaSuccess;
  LaneInputs a = lane_inputs(words, n_words, luts, lut_rows, word_base, ts,
                             limit, upm, in_p, in_u, in_z, n_lanes, s_max,
                             min_code_bits);
  streams_kernel<<<blocks_for(n_lanes), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<int32_t*>(pos), static_cast<int32_t*>(val));
  return cudaGetLastError();
}

int rt_decode_store(const void* words, int n_words, const void* luts,
                    const void* lut_rows, const void* word_base,
                    const void* ts, const void* limit, const void* upm,
                    const void* in_p, const void* in_u, const void* in_z,
                    const void* write_base, const void* write_max, void* coef,
                    long long n_coef, int n_lanes, int s_max,
                    int min_code_bits, void* stream) {
  if (n_lanes <= 0) return cudaSuccess;
  LaneInputs a = lane_inputs(words, n_words, luts, lut_rows, word_base, ts,
                             limit, upm, in_p, in_u, in_z, n_lanes, s_max,
                             min_code_bits);
  store_kernel<<<blocks_for(n_lanes), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const int32_t*>(write_base),
      static_cast<const int32_t*>(write_max), static_cast<int32_t*>(coef),
      (int64_t)n_coef);
  return cudaGetLastError();
}

}  // extern "C"
