// Huffman subsequence decoding on Hopper: the exit, stream and store kernels.
//
// Replaces three Pallas kernels of the JAX package:
//   rt_decode_exits   <- decode_exits_pallas         (kernels/huffman/huffman.py)
//   rt_decode_streams <- decode_coeffs_pallas        (kernels/huffman/huffman.py)
//   rt_decode_store   <- decode_coeffs_store_pallas  (kernels/fused/store.py)
//
// Layout: one thread per chunk lane, the paper's own layout. Each thread
// runs up to s_max symbol steps (huffman.cuh) from its entry state and
// stops decoding once p >= limit, which is exact because p only grows; the
// loop bound stays s_max as in the Pallas kernels. Words are read in place
// (no pre-gather into a (C, W) tile as the Pallas wrapper does), clamped to
// the last word as JAX clamps its gathers.
//
// What bounds the decode on this card: not HBM bytes. Each symbol step is
// a chain of dependent integer operations (window, table entry, shifts,
// state update), so the kernels are bound by the memory accesses on that
// chain
// and by divergence: the lanes of a warp finish after different numbers of
// symbols. The lanes read unrelated words and table entries, so every
// access of a warp touches up to 32 sectors.
//
// The exit kernel (once per sync round) and the stream kernel (once per
// decode, the same symbols again) keep both off the global-memory path:
//   * the table entry comes from compact two-level uint16 tables
//     (ops.compact_luts, built once per plan: about 7 KB for the four
//     standard tables, against 1 MiB of int32 LUTs) and the tablesets'
//     row starts, which each block stages in shared memory when it
//     starts (stage_tables). Tables that do not fit the caller's
//     shared-memory budget are read from global memory by the same kernel
//     (kShared = false);
//   * the words come from a per-lane buffer in registers
//     (rt::BufferedWindow): each lane reads each word of its chunk once,
//     and the load of word w+2 is issued a word ahead of its use.
// What is left bounds the exit kernel by instruction issue: 66
// instructions a step in the compiled loop, 26 of them predicated (the
// word prefetch, the secondary lookup), with the warp running as long as
// its longest lane. Blocks of kExitThreads = 256 (8 an SM, full occupancy)
// measured best of 128, 256 and 512 (PERF.md, tools/kernel_times.py).
// The stream kernel writes (pos, val) rows step-major, (s_max, C), so that
// the 32 lanes of a warp store to consecutive addresses; every lane stores
// all s_max rows (rt::stream_lane), -1/0 once it has finished, so each
// warp's row is one 128-byte store per stream. Those 8 * s_max * C bytes
// (1.1 GB at the 269,063 lanes of 32 1080p frames) are its byte bound; the
// decode itself is the exit kernel's. What held it back was the order of
// the stores: warps drift apart by the symbols they decode, and 128-byte
// pieces of rows 1 MB apart reach memory interleaved. A block barrier
// after every row (kStreamBarrierRows = 1) keeps a block's warps on the
// same row, so each row is written in runs of 4 KB (kStreamThreads = 1024
// lanes): 1.65 -> 0.65 ms; both constants measured best of the variants in
// PERF.md (tools/kernel_times.py --stream-variants).
// The store kernel (fuse="full") still reads two words and one full-LUT
// entry per step through the cache (rt::WordWindow, rt::FullLut). It
// needs no atomics: once the entries have converged the lanes'
// coefficient ranges are disjoint and positions within a lane strictly
// increase (the scatter-race proof, docs/KERNELS.md).
//
// Every entry point returns cudaGetLastError() after its launch.
#include <cuda_runtime.h>
#include <stdint.h>

#include "huffman.cuh"

namespace {

constexpr int kThreads = 128;         // store kernel
constexpr int kExitThreads = 256;     // exit kernel
constexpr int kStreamThreads = 1024;  // stream kernel
constexpr int kStreamBarrierRows = 1;  // its rows between block barriers
constexpr int kSlots = 2 * rt::kMaxUpm;  // LUT slots per tableset

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

// The exit and stream kernels' tables: the compact tables and, per
// tableset slot, the start of its row in them.
struct CompactTables {
  const uint16_t* tab;  // (n_tab,), n_tab a multiple of 128
  const int32_t* offs;  // (TS, kMaxUpm, 2) unit_lut_off
  int n_tab;
  int n_offs;
};

int shared_bytes(const CompactTables& t) {
  return t.n_tab * (int)sizeof(uint16_t) + t.n_offs * (int)sizeof(int32_t);
}

__device__ __forceinline__ rt::StepOut step(const LaneInputs& a,
                                            const int32_t* rows, int wb,
                                            int limit, int upm,
                                            rt::LaneState& st) {
  return rt::symbol_step(a.words, a.n_words, a.luts, rows, wb, limit, upm,
                         a.min_code_bits, st);
}

// The compact tables as the kernel reads them: copied into the block's
// shared memory (kShared; the table as 16-byte words, n_tab being a
// multiple of 128 entries, then the row starts) or left in global memory.
// Every thread of the block must call it.
template <bool kShared>
__device__ __forceinline__ void stage_tables(const CompactTables& t,
                                             unsigned char* smem,
                                             const uint16_t*& tab,
                                             const int32_t*& offs) {
  tab = t.tab;
  offs = t.offs;
  if (kShared) {
    uint4* s_tab = reinterpret_cast<uint4*>(smem);
    const uint4* g_tab = reinterpret_cast<const uint4*>(t.tab);
    for (int i = threadIdx.x; i < t.n_tab / 8; i += blockDim.x) {
      s_tab[i] = g_tab[i];
    }
    int32_t* s_offs = reinterpret_cast<int32_t*>(smem + 2 * t.n_tab);
    for (int i = threadIdx.x; i < t.n_offs; i += blockDim.x) {
      s_offs[i] = t.offs[i];
    }
    __syncthreads();
    tab = reinterpret_cast<const uint16_t*>(smem);
    offs = s_offs;
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kExitThreads)
exits_kernel(LaneInputs a, CompactTables t, int32_t* __restrict__ out_p,
             int32_t* __restrict__ out_u, int32_t* __restrict__ out_z,
             int32_t* __restrict__ out_n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint16_t* tab;
  const int32_t* offs;
  stage_tables<kShared>(t, smem, tab, offs);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.n_lanes) return;
  const rt::CompactLut<!kShared> table{tab, offs + a.ts[lane] * kSlots};
  const int wb = a.word_base[lane], limit = a.limit[lane], upm = a.upm[lane];
  rt::LaneState st{a.in_p[lane], a.in_u[lane], a.in_z[lane], 0};
  rt::BufferedWindow window(a.words, a.n_words, wb, st.p);
  for (int i = 0; i < a.s_max && st.p < limit; ++i) {
    rt::symbol_step(window, table, limit, upm, a.min_code_bits, st);
  }
  out_p[lane] = st.p;
  out_u[lane] = st.u;
  out_z[lane] = st.z;
  out_n[lane] = st.n;
}

// pos[i, lane] = local zig-zag offset written by step i (-1: nothing),
// val[i, lane] = its coefficient (0 where pos is -1); both (s_max, C).
// The exit kernel's sources; the loop is rt::stream_lane, with a block
// barrier every kStreamBarrierRows rows, so that the block's warps store
// the same rows at about the same time. A thread past the last lane runs
// the loop for the barriers, with nothing to decode and nothing stored.
template <bool kShared>
__global__ void __launch_bounds__(kStreamThreads)
streams_kernel(LaneInputs a, CompactTables t, int32_t* __restrict__ pos,
               int32_t* __restrict__ val) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint16_t* tab;
  const int32_t* offs;
  stage_tables<kShared>(t, smem, tab, offs);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool real = lane < a.n_lanes;
  const int l = real ? lane : a.n_lanes - 1;
  const rt::CompactLut<!kShared> table{tab, offs + a.ts[l] * kSlots};
  rt::LaneState st{a.in_p[l], a.in_u[l], a.in_z[l], 0};
  rt::BufferedWindow window(a.words, a.n_words, a.word_base[l], st.p);
  rt::stream_lane(window, table, real ? a.limit[l] : 0, a.upm[l],
                  a.min_code_bits, a.s_max, st, pos + l, val + l,
                  (int64_t)a.n_lanes, real, [](int i) {
                    if ((i + 1) % kStreamBarrierRows == 0) __syncthreads();
                  });
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
  const int32_t* rows = a.lut_rows + (int64_t)a.ts[lane] * kSlots;
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

int blocks_for(int n_lanes, int threads) {
  return (n_lanes + threads - 1) / threads;
}

// Shared memory beyond 48 KB needs the kernel's opt-in first.
template <class Kernel>
cudaError_t allow_shared(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// One launch of a kernel over the compact tables: its shared-memory form
// when the tables take at most `smem_budget` bytes, else its global one.
template <int kBlock, class Shared, class Global, class... Args>
cudaError_t launch_compact(Shared shared, Global global,
                           const CompactTables& t, int n_lanes,
                           int smem_budget, cudaStream_t s, Args... args) {
  const int bytes = shared_bytes(t);
  const int blocks = blocks_for(n_lanes, kBlock);
  if (bytes <= smem_budget) {
    const cudaError_t err = allow_shared(shared, bytes);
    if (err != cudaSuccess) return err;
    shared<<<blocks, kBlock, bytes, s>>>(args...);
  } else {
    global<<<blocks, kBlock, 0, s>>>(args...);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The exit and stream kernels: the compact tables go to shared memory
// when they take at most `smem_budget` bytes, else they are read from
// global memory.
int rt_decode_exits(const void* words, int n_words, const void* ctab,
                    int n_tab, const void* lut_off, int n_offs,
                    const void* word_base, const void* ts, const void* limit,
                    const void* upm, const void* in_p, const void* in_u,
                    const void* in_z, void* out_p, void* out_u, void* out_z,
                    void* out_n, int n_lanes, int s_max, int min_code_bits,
                    int smem_budget, void* stream) {
  if (n_lanes <= 0) return cudaSuccess;
  if (n_tab % 128 != 0) return cudaErrorInvalidValue;
  LaneInputs a = lane_inputs(words, n_words, nullptr, nullptr, word_base, ts,
                             limit, upm, in_p, in_u, in_z, n_lanes, s_max,
                             min_code_bits);
  const CompactTables t{static_cast<const uint16_t*>(ctab),
                        static_cast<const int32_t*>(lut_off), n_tab, n_offs};
  return launch_compact<kExitThreads>(
      exits_kernel<true>, exits_kernel<false>, t, n_lanes, smem_budget,
      static_cast<cudaStream_t>(stream), a, t, static_cast<int32_t*>(out_p),
      static_cast<int32_t*>(out_u), static_cast<int32_t*>(out_z),
      static_cast<int32_t*>(out_n));
}

int rt_decode_streams(const void* words, int n_words, const void* ctab,
                      int n_tab, const void* lut_off, int n_offs,
                      const void* word_base, const void* ts,
                      const void* limit, const void* upm, const void* in_p,
                      const void* in_u, const void* in_z, void* pos,
                      void* val, int n_lanes, int s_max, int min_code_bits,
                      int smem_budget, void* stream) {
  if (n_lanes <= 0) return cudaSuccess;
  if (n_tab % 128 != 0) return cudaErrorInvalidValue;
  LaneInputs a = lane_inputs(words, n_words, nullptr, nullptr, word_base, ts,
                             limit, upm, in_p, in_u, in_z, n_lanes, s_max,
                             min_code_bits);
  const CompactTables t{static_cast<const uint16_t*>(ctab),
                        static_cast<const int32_t*>(lut_off), n_tab, n_offs};
  return launch_compact<kStreamThreads>(
      streams_kernel<true>, streams_kernel<false>, t, n_lanes, smem_budget,
      static_cast<cudaStream_t>(stream), a, t, static_cast<int32_t*>(pos),
      static_cast<int32_t*>(val));
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
  store_kernel<<<blocks_for(n_lanes, kThreads), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const int32_t*>(write_base),
      static_cast<const int32_t*>(write_max), static_cast<int32_t*>(coef),
      (int64_t)n_coef);
  return cudaGetLastError();
}

}  // extern "C"
