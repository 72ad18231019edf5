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
// its longest lane. Blocks of 256 threads (8 an SM, full occupancy)
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
// same row, so each row is written in runs of 4 KB (1024
// lanes): 1.65 -> 0.65 ms; both constants measured best of the variants in
// PERF.md (tools/kernel_times.py --stream-variants).
// The store kernel (fuse="full") decodes from the same sources and stores
// its coefficients itself (rt::store_lane). One 4-byte store per recorded
// step (44.8 M of them over the 401 MB coefficient buffer of 32 1080p
// frames, 8x the L2) would put each store instruction of a warp on 32
// lines and write sectors in pieces (2.0 ms on the H100, against 0.16
// for the same decode in the exit kernel). So each lane collects the unit
// it decodes in a slot of shared memory, and a unit it decoded whole goes
// out at once, the entries not recorded as 0; the units it enters or
// leaves midway go out entry by entry. Written by each lane itself (16
// stores of 16 bytes), the whole units kept the warp waiting while its
// lanes wrote theirs one lane at a time (0.80 ms); written by the warp
// together (WarpUnits below), each as one coalesced 256-byte store, 0.67
// (both with the caller's 0.13 ms zero fill; PERF.md). The warp's votes
// cost every step, though: with 32 long lanes (sequential sync) the
// kernel waits on each step's latency, and there the lanes' own writes
// are faster (482 against 569 ms), so the launch takes them below a warp
// of lanes an SM. Slots take 264 bytes a thread (rt::store_slot_bytes), before
// the tables in the block's shared memory: 3 blocks of 256 threads an SM, as fast as 128 threads and faster than 512; int16 slots (5
// blocks an SM) were no faster (tools/kernel_times.py --store-variants).
// It needs no atomics: once the entries have converged the lanes'
// coefficient ranges are disjoint and positions within a lane strictly
// increase (the scatter-race proof, docs/KERNELS.md).
//
// Every entry point returns cudaGetLastError() after its launch.
//
// Launch sizes: each kernel is a template on its block size, instantiated
// for each candidate of kernels/autotune.py (geometry.cuh:
// kExitThreadChoices, kStreamThreadChoices, kStoreThreadChoices) and
// picked by a switch on the entry point's `threads` argument; any other
// value returns cudaErrorInvalidValue. The store kernel's writer is an
// argument too (rt::StoreWriter: by lane count, as above, or forced). The
// defaults named above are the wrappers' (autotune.DEFAULT_LAUNCH).
//
// The checked build (-DRT_CHECK, check.cuh) guards every lane read and
// exit store, the staged tables against the block's shared memory, the
// stream rows, the store target and the warp's slot reads.
//
// rt_graph_nodes, host code only, reads a captured CUDA graph for the
// traced-program checker (analysis/trace_check.py): each node's type, which
// kernel nodes are exit-kernel launches and the pointers those read and
// write, and the memory each copy node reads and writes. It lives here
// because only the runtime that launched the exit kernel can name it in a
// graph node: each library links its own copy of the runtime.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <vector>

#include "geometry.cuh"
#include "huffman.cuh"

namespace {

constexpr int kStreamBarrierRows = 1;  // stream kernel rows between barriers
constexpr int kSlots = 2 * rt::kMaxUpm;  // LUT slots per tableset
using rt::kSlotStride;

struct LaneInputs {
  const uint32_t* words;
  int n_words;
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

// lane l's entry of a (C,) lane operand (checked against the lanes)
__device__ __forceinline__ int32_t lane_in(const int32_t* a, int l, int n) {
  return rt::ld(a, l, n, rt::kSiteLane);
}

// The kernels' tables: the compact tables and, per
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

// The compact tables as the kernel reads them: copied into the block's
// shared memory (kShared; the table as 16-byte words, n_tab being a
// multiple of 128 entries, then the row starts) or left in global memory.
// Every thread of the block must call it. `skip`: the shared bytes before
// the tables (the store kernel's slots), for the checked build's bound.
template <bool kShared>
__device__ __forceinline__ void stage_tables(const CompactTables& t,
                                             unsigned char* smem, int skip,
                                             const uint16_t*& tab,
                                             const int32_t*& offs) {
  tab = t.tab;
  offs = t.offs;
  if (kShared) {
#ifdef RT_CHECK
    // the staged tables must fit the block's shared memory
    const long long room =
        (long long)rt::dynamic_smem_bytes() - skip;
    const long long tab_room = room / 16;
    const long long offs_room = (room - 2LL * t.n_tab) / 4;
#else
    const long long tab_room = 0, offs_room = 0;
    (void)skip;
#endif
    uint4* s_tab = reinterpret_cast<uint4*>(smem);
    const uint4* g_tab = reinterpret_cast<const uint4*>(t.tab);
    for (int i = threadIdx.x; i < t.n_tab / 8; i += blockDim.x) {
      rt::st(s_tab, i, tab_room, rt::kSiteStageTables, g_tab[i]);
    }
    int32_t* s_offs = reinterpret_cast<int32_t*>(smem + 2 * t.n_tab);
    for (int i = threadIdx.x; i < t.n_offs; i += blockDim.x) {
      rt::st(s_offs, i, offs_room, rt::kSiteStageTables, t.offs[i]);
    }
    __syncthreads();
    tab = reinterpret_cast<const uint16_t*>(smem);
    offs = s_offs;
  }
}

// The lane's table: its tableset's row of the (staged) tables.
template <bool kShared>
__device__ __forceinline__ rt::CompactLut<!kShared> lane_table(
    const CompactTables& t, const uint16_t* tab, const int32_t* offs,
    int ts) {
  const int64_t row = (int64_t)ts * kSlots;
  return rt::CompactLut<!kShared>{tab, offs + row, t.n_tab, t.n_offs - row};
}

template <bool kShared, int kBlock>
__global__ void __launch_bounds__(kBlock)
exits_kernel(LaneInputs a, CompactTables t, int32_t* __restrict__ out_p,
             int32_t* __restrict__ out_u, int32_t* __restrict__ out_z,
             int32_t* __restrict__ out_n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint16_t* tab;
  const int32_t* offs;
  stage_tables<kShared>(t, smem, 0, tab, offs);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.n_lanes) return;
  const int n = a.n_lanes;
  const auto table = lane_table<kShared>(t, tab, offs, lane_in(a.ts, lane, n));
  const int wb = lane_in(a.word_base, lane, n);
  const int limit = lane_in(a.limit, lane, n), upm = lane_in(a.upm, lane, n);
  rt::LaneState st{lane_in(a.in_p, lane, n), lane_in(a.in_u, lane, n),
                   lane_in(a.in_z, lane, n), 0};
  rt::BufferedWindow window(a.words, a.n_words, wb, st.p);
  for (int i = 0; i < a.s_max && st.p < limit; ++i) {
    rt::symbol_step(window, table, limit, upm, a.min_code_bits, st);
  }
  rt::st(out_p, lane, n, rt::kSiteLane, st.p);
  rt::st(out_u, lane, n, rt::kSiteLane, st.u);
  rt::st(out_z, lane, n, rt::kSiteLane, st.z);
  rt::st(out_n, lane, n, rt::kSiteLane, st.n);
}

// pos[i, lane] = local zig-zag offset written by step i (-1: nothing),
// val[i, lane] = its coefficient (0 where pos is -1); both (s_max, C).
// The exit kernel's sources; the loop is rt::stream_lane, with a block
// barrier every kStreamBarrierRows rows, so that the block's warps store
// the same rows at about the same time. A thread past the last lane runs
// the loop for the barriers, with nothing to decode and nothing stored.
template <bool kShared, int kBlock>
__global__ void __launch_bounds__(kBlock)
streams_kernel(LaneInputs a, CompactTables t, int32_t* __restrict__ pos,
               int32_t* __restrict__ val) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint16_t* tab;
  const int32_t* offs;
  stage_tables<kShared>(t, smem, 0, tab, offs);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool real = lane < a.n_lanes;
  const int n = a.n_lanes;
  const int l = real ? lane : n - 1;
  const auto table = lane_table<kShared>(t, tab, offs, lane_in(a.ts, l, n));
  rt::LaneState st{lane_in(a.in_p, l, n), lane_in(a.in_u, l, n),
                   lane_in(a.in_z, l, n), 0};
  rt::BufferedWindow window(a.words, a.n_words, lane_in(a.word_base, l, n),
                            st.p);
  rt::stream_lane(window, table, real ? lane_in(a.limit, l, n) : 0,
                  lane_in(a.upm, l, n), a.min_code_bits, a.s_max, st,
                  pos + l, val + l, (int64_t)n, real,
                  [](int i) {
                    if ((i + 1) % kStreamBarrierRows == 0) __syncthreads();
                  },
                  (int64_t)a.s_max * n - l);
}

// store_lane's whole units written by the warp together (WarpUnits): at
// each step, the lanes with a whole unit to write are found by a ballot,
// and for each of them the 32 lanes read two entries each from its slot
// in shared memory ([thread][k]: one 256-byte row, read as 8-byte words
// free of bank conflicts) and store them, so that every unit goes out as
// one coalesced 256-byte store, and no lane waits for its neighbours to
// write theirs one by one.
struct WarpUnits {
  const int32_t* warp_slots;  // the slot of the warp's lane 0
  int64_t slot_extent;        // int32 from warp_slots to the slots' end

  __device__ __forceinline__ bool any(bool active) const {
    return __any_sync(0xffffffffu, active);
  }
  __device__ __forceinline__ void write(bool ready, int n0, uint64_t rec,
                                        const int32_t*,
                                        const rt::CoefStore& out) const {
    unsigned m = __ballot_sync(0xffffffffu, ready);
    const int lane = threadIdx.x & 31;
    const int t_own = out.base + n0;
    while (m != 0) {
      const int j = __ffs(m) - 1;
      m &= m - 1;
      const int t0 = __shfl_sync(0xffffffffu, t_own, j);
      const uint32_t lo = __shfl_sync(0xffffffffu, (uint32_t)rec, j);
      const uint32_t hi = __shfl_sync(0xffffffffu, (uint32_t)(rec >> 32), j);
      const uint32_t bits = ((lane < 16 ? lo : hi) >> (2 * (lane & 15))) & 3u;
      const int64_t k = (int64_t)j * kSlotStride + 2 * lane;
      const int2 v =
          rt::ok(k + 1, slot_extent, rt::kSiteSlot)
              ? *reinterpret_cast<const int2*>(warp_slots + k)
              : make_int2(0, 0);
      if (rt::ok((int64_t)t0 + 2 * lane + 1, out.n_coef, rt::kSiteCoef)) {
        *reinterpret_cast<int2*>(out.coef + t0 + 2 * lane) =
            make_int2(bits & 1u ? v.x : 0, bits & 2u ? v.y : 0);
      }
    }
  }
};

// Stores each recorded coefficient at write_base + n + run_eff into `coef`
// (zeroed by the caller), under the mask of the JAX store kernel:
// recorded step, pos >= 0, 0 <= target <= write_max; targets past the
// buffer are dropped as well. The exit kernel's sources; the loop is
// rt::store_lane, whose unit slots lie in the first
// rt::store_slot_bytes(kBlock) of the block's shared memory, the tables
// after them. kWarpUnits: the warp writes the whole units (WarpUnits),
// else each lane its own (rt::LaneUnits). A thread past the last lane runs
// the loop with nothing to decode, for its warp's votes.
template <bool kShared, bool kWarpUnits, int kBlock>
__global__ void __launch_bounds__(kBlock)
store_kernel(LaneInputs a, CompactTables t,
             const int32_t* __restrict__ write_base,
             const int32_t* __restrict__ write_max,
             int32_t* __restrict__ coef, int64_t n_coef) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kSlotBytes = rt::store_slot_bytes(kBlock);
  const uint16_t* tab;
  const int32_t* offs;
  stage_tables<kShared>(t, smem + kSlotBytes, kSlotBytes, tab, offs);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool real = lane < a.n_lanes;
  const int n = a.n_lanes;
  const int l = real ? lane : n - 1;
  const auto table = lane_table<kShared>(t, tab, offs, lane_in(a.ts, l, n));
  rt::LaneState st{lane_in(a.in_p, l, n), lane_in(a.in_u, l, n),
                   lane_in(a.in_z, l, n), 0};
  rt::BufferedWindow window(a.words, a.n_words, lane_in(a.word_base, l, n),
                            st.p);
  const rt::CoefStore out{coef, n_coef, lane_in(write_base, l, n),
                          lane_in(write_max, l, n)};
  int32_t* slots = reinterpret_cast<int32_t*>(smem);
  int32_t* slot = slots + threadIdx.x * kSlotStride;
  const int limit = real ? lane_in(a.limit, l, n) : 0;
  if constexpr (kWarpUnits) {
    const int first = threadIdx.x & ~31;
    const WarpUnits units{slots + first * kSlotStride,
                          (int64_t)(kBlock - first) * kSlotStride};
    rt::store_lane(window, table, limit, lane_in(a.upm, l, n),
                   a.min_code_bits, a.s_max, st, out, slot, units);
  } else {
    rt::store_lane(window, table, limit, lane_in(a.upm, l, n),
                   a.min_code_bits, a.s_max, st, out, slot, rt::LaneUnits{});
  }
}

LaneInputs lane_inputs(const void* words, int n_words, const void* word_base,
                       const void* ts, const void* limit, const void* upm,
                       const void* in_p, const void* in_u, const void* in_z,
                       int n_lanes, int s_max, int min_code_bits) {
  LaneInputs a;
  a.words = static_cast<const uint32_t*>(words);
  a.n_words = n_words;
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

// The SMs of the current device (asked once per device).
int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0) {
    cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount,
                           dev);
  }
  return counts[dev];
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
// `slot_bytes` of shared memory come first in either form (the store
// kernel's unit slots), the staged tables after them.
template <int kBlock, class Shared, class Global, class... Args>
cudaError_t launch_compact(Shared shared, Global global,
                           const CompactTables& t, int n_lanes,
                           int smem_budget, int slot_bytes, cudaStream_t s,
                           Args... args) {
  const int bytes = shared_bytes(t);
  const int blocks = (int)rt::blocks_for(n_lanes, kBlock);
  const bool staged = bytes <= smem_budget;
  const int smem = slot_bytes + (staged ? bytes : 0);
  const cudaError_t err = allow_shared(staged ? shared : global, smem);
  if (err != cudaSuccess) return err;
  if (staged) {
    shared<<<blocks, kBlock, smem, s>>>(args...);
  } else {
    global<<<blocks, kBlock, smem, s>>>(args...);
  }
  return cudaGetLastError();
}

// f(std::integral_constant<int, kBlock>) for the block size `threads` of
// the instantiated kChoices, or cudaErrorInvalidValue for any other
template <int... kChoices, class F>
cudaError_t with_block(int threads, F f) {
  cudaError_t err = cudaErrorInvalidValue;
  (void)((threads == kChoices &&
          (err = f(std::integral_constant<int, kChoices>{}), true)) ||
         ...);
  return err;
}

static_assert(rt::kExitThreadChoices[0] == 128 &&
              rt::kExitThreadChoices[1] == 256 &&
              rt::kExitThreadChoices[2] == 512, "exit kernel choices");
static_assert(rt::kStreamThreadChoices[0] == 256 &&
              rt::kStreamThreadChoices[1] == 512 &&
              rt::kStreamThreadChoices[2] == 1024, "stream kernel choices");
static_assert(rt::kStoreThreadChoices[0] == 128 &&
              rt::kStoreThreadChoices[1] == 256, "store kernel choices");

// -- The graph reader (rt_graph_nodes) ---------------------------------------

// int64 words per node in rt_graph_nodes' output
constexpr int kNodeWords = 18;
// exit-kernel pointer operands reported per node
constexpr int kExitNodePointers = 14;

bool is_exit_kernel(const void* func) {
  const void* mine[] = {
      reinterpret_cast<const void*>(exits_kernel<true, 128>),
      reinterpret_cast<const void*>(exits_kernel<false, 128>),
      reinterpret_cast<const void*>(exits_kernel<true, 256>),
      reinterpret_cast<const void*>(exits_kernel<false, 256>),
      reinterpret_cast<const void*>(exits_kernel<true, 512>),
      reinterpret_cast<const void*>(exits_kernel<false, 512>)};
  for (const void* f : mine) {
    if (f == func) return true;
  }
  return false;
}

// The memory a copy node reads or writes: a cudaMemoryType (0: host memory
// the runtime does not know, 1: pinned host, 2: device, 3: managed); an
// array is device memory.
long long memory_type(const void* ptr, cudaArray_t array) {
  if (array != nullptr) return cudaMemoryTypeDevice;
  cudaPointerAttributes attr;
  if (cudaPointerGetAttributes(&attr, ptr) != cudaSuccess) {
    cudaGetLastError();
    return cudaMemoryTypeUnregistered;
  }
  return attr.type;
}

}  // namespace

extern "C" {

// The nodes of a CUDA graph (a cudaGraph_t, as torch.cuda.CUDAGraph's
// raw_cuda_graph() gives it), kNodeWords int64 words each in `out`, for
// the first `cap` nodes; returns the node count (which may exceed `cap`)
// or minus a CUDA error. Word 0 is the node's cudaGraphNodeType. Kernel
// nodes: word 1 is 1 for the exit kernel, 0 for another kernel, minus the
// error where the runtime cannot read the node's parameters (a kernel it
// did not launch); an exit node has its lane count in word 3 and its
// pointer operands in words 4-17: words, word_base, ts, limit, upm, in_p,
// in_u, in_z, the compact tables, their row starts, out_p, out_u, out_z,
// out_n. Copy nodes: the memory types of the source (word 1) and the
// destination (word 2), and the cudaMemcpyKind (word 3).
int rt_graph_nodes(void* graph, long long* out, int cap) {
  const cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &n);
  if (err != cudaSuccess) return -(int)err;
  std::vector<cudaGraphNode_t> nodes(n);
  if (n > 0 && (err = cudaGraphGetNodes(g, nodes.data(), &n)) != cudaSuccess) {
    return -(int)err;
  }
  for (size_t i = 0; i < n && i < (size_t)cap; ++i) {
    long long* w = out + i * kNodeWords;
    for (int k = 0; k < kNodeWords; ++k) w[k] = 0;
    cudaGraphNodeType type;
    if ((err = cudaGraphNodeGetType(nodes[i], &type)) != cudaSuccess) {
      return -(int)err;
    }
    w[0] = type;
    if (type == cudaGraphNodeTypeKernel) {
      cudaKernelNodeParams p;
      if ((err = cudaGraphKernelNodeGetParams(nodes[i], &p)) != cudaSuccess) {
        cudaGetLastError();
        w[1] = -(long long)err;
        continue;
      }
      if (!is_exit_kernel(p.func)) continue;
      w[1] = 1;
      if (p.kernelParams == nullptr) return -(int)cudaErrorInvalidValue;
      const LaneInputs& a = *static_cast<const LaneInputs*>(p.kernelParams[0]);
      const CompactTables& t =
          *static_cast<const CompactTables*>(p.kernelParams[1]);
      const void* ptrs[kExitNodePointers] = {
          a.words, a.word_base, a.ts, a.limit, a.upm, a.in_p, a.in_u, a.in_z,
          t.tab, t.offs,
          *static_cast<void* const*>(p.kernelParams[2]),
          *static_cast<void* const*>(p.kernelParams[3]),
          *static_cast<void* const*>(p.kernelParams[4]),
          *static_cast<void* const*>(p.kernelParams[5])};
      w[3] = a.n_lanes;
      for (int k = 0; k < kExitNodePointers; ++k) {
        w[4 + k] = (long long)reinterpret_cast<uintptr_t>(ptrs[k]);
      }
    } else if (type == cudaGraphNodeTypeMemcpy) {
      cudaMemcpy3DParms p;
      if ((err = cudaGraphMemcpyNodeGetParams(nodes[i], &p)) != cudaSuccess) {
        return -(int)err;
      }
      w[1] = memory_type(p.srcPtr.ptr, p.srcArray);
      w[2] = memory_type(p.dstPtr.ptr, p.dstArray);
      w[3] = p.kind;
    }
  }
  return (int)n;
}


// Each kernel's compact tables go to shared memory when they take at most
// `smem_budget` bytes, else they are read from global memory. `threads`:
// the block size, one of the kernel's candidates.
int rt_decode_exits(const void* words, int n_words, const void* ctab,
                    int n_tab, const void* lut_off, int n_offs,
                    const void* word_base, const void* ts, const void* limit,
                    const void* upm, const void* in_p, const void* in_u,
                    const void* in_z, void* out_p, void* out_u, void* out_z,
                    void* out_n, int n_lanes, int s_max, int min_code_bits,
                    int smem_budget, int threads, void* stream) {
  if (n_tab % 128 != 0) return cudaErrorInvalidValue;
  LaneInputs a = lane_inputs(words, n_words, word_base, ts, limit, upm,
                             in_p, in_u, in_z, n_lanes, s_max,
                             min_code_bits);
  const CompactTables t{static_cast<const uint16_t*>(ctab),
                        static_cast<const int32_t*>(lut_off), n_tab, n_offs};
  return with_block<128, 256, 512>(threads, [&](auto block) {
    constexpr int kBlock = decltype(block)::value;
    if (n_lanes <= 0) return cudaSuccess;
    return launch_compact<kBlock>(
        exits_kernel<true, kBlock>, exits_kernel<false, kBlock>, t, n_lanes,
        smem_budget, 0, static_cast<cudaStream_t>(stream), a, t,
        static_cast<int32_t*>(out_p), static_cast<int32_t*>(out_u),
        static_cast<int32_t*>(out_z), static_cast<int32_t*>(out_n));
  });
}

int rt_decode_streams(const void* words, int n_words, const void* ctab,
                      int n_tab, const void* lut_off, int n_offs,
                      const void* word_base, const void* ts,
                      const void* limit, const void* upm, const void* in_p,
                      const void* in_u, const void* in_z, void* pos,
                      void* val, int n_lanes, int s_max, int min_code_bits,
                      int smem_budget, int threads, void* stream) {
  if (n_tab % 128 != 0) return cudaErrorInvalidValue;
  LaneInputs a = lane_inputs(words, n_words, word_base, ts, limit, upm,
                             in_p, in_u, in_z, n_lanes, s_max,
                             min_code_bits);
  const CompactTables t{static_cast<const uint16_t*>(ctab),
                        static_cast<const int32_t*>(lut_off), n_tab, n_offs};
  return with_block<256, 512, 1024>(threads, [&](auto block) {
    constexpr int kBlock = decltype(block)::value;
    if (n_lanes <= 0) return cudaSuccess;
    return launch_compact<kBlock>(
        streams_kernel<true, kBlock>, streams_kernel<false, kBlock>, t,
        n_lanes, smem_budget, 0, static_cast<cudaStream_t>(stream), a, t,
        static_cast<int32_t*>(pos), static_cast<int32_t*>(val));
  });
}

// `writer`: rt::StoreWriter. The warp writes the whole units (auto) when
// the lanes fill at least a warp an SM; with fewer, a step's latency
// bounds the kernel and the warp's votes would lengthen every step. The
// warp writer is refused below a warp of lanes.
int rt_decode_store(const void* words, int n_words, const void* ctab,
                    int n_tab, const void* lut_off, int n_offs,
                    const void* word_base, const void* ts, const void* limit,
                    const void* upm, const void* in_p, const void* in_u,
                    const void* in_z, const void* write_base,
                    const void* write_max, void* coef, long long n_coef,
                    int n_lanes, int s_max, int min_code_bits,
                    int smem_budget, int threads, int writer, void* stream) {
  if (n_tab % 128 != 0) return cudaErrorInvalidValue;
  const int warp = rt::store_warp_units(writer, n_lanes, sm_count());
  if (warp < 0) return cudaErrorInvalidValue;
  LaneInputs a = lane_inputs(words, n_words, word_base, ts, limit, upm,
                             in_p, in_u, in_z, n_lanes, s_max,
                             min_code_bits);
  const CompactTables t{static_cast<const uint16_t*>(ctab),
                        static_cast<const int32_t*>(lut_off), n_tab, n_offs};
  auto store = [&](auto block) {
    constexpr int kBlock = decltype(block)::value;
    if (n_lanes <= 0) return cudaSuccess;
    auto launch = [&](auto shared, auto global) {
      return launch_compact<kBlock>(
          shared, global, t, n_lanes, smem_budget,
          rt::store_slot_bytes(kBlock), static_cast<cudaStream_t>(stream),
          a, t, static_cast<const int32_t*>(write_base),
          static_cast<const int32_t*>(write_max),
          static_cast<int32_t*>(coef), (int64_t)n_coef);
    };
    return warp ? launch(store_kernel<true, true, kBlock>,
                         store_kernel<false, true, kBlock>)
                : launch(store_kernel<true, false, kBlock>,
                         store_kernel<false, false, kBlock>);
  };
  return with_block<128, 256>(threads, store);
}

}  // extern "C"
