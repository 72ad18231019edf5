// One Huffman symbol step of one chunk lane: the shared body of the exit,
// stream and store kernels in huffman.cu, and the stream and store
// kernels' loops over a lane.
//
// Counterpart of `_symbol_step` in the JAX package's
// kernels/huffman/huffman.py and of `decode_symbol` in
// repro_torch/core/decode.py; every bit operation is theirs, in the same
// order, so the exit states and coefficients agree bit for bit:
//   * a 32-bit MSB-aligned window at bit p, word indices clamped to the
//     last word (JAX clamps out-of-bounds gathers);
//   * shift amounts masked with `& 31` and the `off == 0` guard, because a
//     shift by 32 is undefined in C++;
//   * the garbage phase (a window that starts no codeword, LUT entry 0):
//     adv = min_code_bits, run_eff = 0, coef = 0. Any other choice changes
//     the speculative exits and with them the number of Jacobi rounds.
//
// Where the step's bits and its table entry come from is a template
// parameter of symbol_step; the bit operations after them are one body.
// All three kernels take the same sources:
//   * words: BufferedWindow keeps words w and w+1 in registers and w+2
//     prefetched, and loads one word when p >> 5 moves on. A step advances
//     at most 31 bits (clen + size <= 31, or min_code_bits <= 16), so
//     p >> 5 moves by at most one. It clamps the word index as JAX does;
//   * tables: CompactLut reads the two-level uint16 tables that
//     kernels/huffman/ops.compact_luts builds from the (L, 65536) int32
//     LUTs, which expand to the same entry for every window
//     (tests/test_torch_lut.py).
//
// stream_lane and store_lane are the stream and store kernels' whole
// loops over one lane, so that the host build runs them as the kernels
// do.
//
// The functions are __host__ __device__ so that a host-only build of this
// header (g++, see tests/test_torch_symbol_step.py) runs the same code on
// the CPU.
//
// In the checked build (-DRT_CHECK, check.cuh) every read of the words,
// the tables and the slot, and every store, is checked against its extent:
// the words window against the buffer (whose segments each end in the JAX
// kernel's two window words past chunk_words), the tables against n_tab
// and the tableset rows,
// the stream rows and the store target against their buffers.
#pragma once

#include <stdint.h>

#include "check.cuh"

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

namespace rt {

constexpr int kMaxUpm = 6;          // data units per MCU (bitstream.MAX_UPM)
constexpr int kLutSize = 1 << 16;   // 16-bit lookahead
constexpr int kLutSizeShift = 5;    // tables.LUT_SIZE_SHIFT
constexpr int kLutRunShift = 10;    // tables.LUT_RUN_SHIFT
constexpr int kLutEobBit = 1 << 14; // tables.LUT_EOB_BIT
// compact tables (ops.compact_luts): a primary of 2^9 entries indexed by
// the window's top 9 bits, and secondaries of 2^7 entries for its low 7
constexpr int kSecondaryBits = 7;

struct LaneState {
  int p, u, z, n;
};

struct StepOut {
  int coef;      // decoded coefficient (0 for EOB/ZRL/garbage)
  int run_eff;   // effective zero-run before the coefficient
  bool active;   // the lane decoded a symbol this step
  bool invalid;  // the window held no codeword (garbage phase)
};

// The window at bit offset `off` (0..31) of the word pair (hi, lo).
__host__ __device__ __forceinline__ uint32_t window32(uint32_t hi, uint32_t lo,
                                                      uint32_t off) {
  const uint32_t lo_shift = off == 0u ? 0u : (lo >> ((32u - off) & 31u));
  return (hi << off) | lo_shift;
}

// -- the window source: operator()(p) is the 32-bit window at segment bit p

// Word indices in 32 bits: the planner guarantees n_words * 32 + 63 fits
// int32 (core/contracts.check_shape_capacities), so word_base + (p >> 5) + 2
// does too; load_word32 clamps it to the last word. A lane reads at most two
// words past its last bit (the window's straddle and safety words: the JAX
// kernel's chunk_words + 2), and the plan appends those two words to every
// segment (jpeg/format.pack_bits_to_words), so no read of a clean run
// passes the buffer; the checked build flags one that does, before the
// clamp.
__host__ __device__ __forceinline__ uint32_t load_word32(
    const uint32_t* words, int n_words, int idx) {
  ok(idx, n_words, kSiteWords);
  idx = idx < 0 ? 0 : (idx >= n_words ? n_words - 1 : idx);
  return words[idx];
}

struct BufferedWindow {
  const uint32_t* words;
  int n_words;
  int next;          // the index of word w + 2
  int w;             // p >> 5 of the words held
  uint32_t hi, lo, nxt;  // words w, w + 1, w + 2 (clamped)

  __host__ __device__ __forceinline__ BufferedWindow(const uint32_t* words_,
                                                     int n_words_,
                                                     int word_base, int p)
      : words(words_), n_words(n_words_), next(word_base + (p >> 5) + 2),
        w(p >> 5) {
    hi = load_word32(words, n_words, next - 2);
    lo = load_word32(words, n_words, next - 1);
    nxt = load_word32(words, n_words, next);
  }

  // p never falls and grows by at most 31 bits a step, so p >> 5 is w or
  // w + 1
  __host__ __device__ __forceinline__ uint32_t operator()(int p) {
    if ((p >> 5) != w) {
      ++w;
      hi = lo;
      lo = nxt;
      nxt = load_word32(words, n_words, ++next);
    }
    return window32(hi, lo, (uint32_t)(p & 31));
  }
};

// -- the table: entry(slot, win16), slot = u * 2 + is_dc of the lane's row

// kLdg: the tables lie in global memory (read through __ldg), else in
// shared memory. A primary entry whose code length is 0 but which is not 0
// points to a secondary: entry >> 5 is its offset in units of 2^7 entries
// from the row's start (the one entry of code length 0 in a LUT is the
// invalid window, 0, which stays 0).
template <bool kLdg>
struct CompactLut {
  const uint16_t* tab;  // every row: primary, then its secondaries
  const int32_t* offs;  // the lane's tableset row of unit_lut_off: starts
  // the checked build's extents: tab's entries, and offs' from the lane's
  // row on (unchecked by default)
  int64_t n_tab = INT64_MAX;
  int64_t n_offs = INT64_MAX;

  __host__ __device__ __forceinline__ uint32_t load(int64_t i) const {
    if (!ok(i, n_tab, kSiteTable)) return 0u;
#ifdef __CUDA_ARCH__
    if (kLdg) return __ldg(tab + i);
#endif
    return tab[i];
  }

  __host__ __device__ __forceinline__ int entry(int slot, int win16) const {
    if (!ok(slot, n_offs, kSiteTableRow)) return 0;
#ifdef __CUDA_ARCH__
    const int64_t base = kLdg ? __ldg(offs + slot) : offs[slot];
#else
    const int64_t base = offs[slot];
#endif
    uint32_t e = load(base + (win16 >> kSecondaryBits));
    if ((e & 0x1Fu) == 0u && e != 0u) {
      e = load(base + ((int64_t)(e >> 5) << kSecondaryBits) +
               (win16 & ((1 << kSecondaryBits) - 1)));
    }
    return (int)e;
  }
};

// One step of a lane from `window` and `table`.
template <class Window, class Table>
__host__ __device__ __forceinline__ StepOut symbol_step(
    Window& window, const Table& table, int limit, int upm, int min_code_bits,
    LaneState& st) {
  StepOut o;
  o.active = st.p < limit;

  const uint32_t win32 = window(st.p);
  const int win16 = (int)(win32 >> 16);

  const int is_dc = st.z == 0 ? 1 : 0;
  const int entry = table.entry(st.u * 2 + is_dc, win16);

  const int clen = entry & 0x1F;
  const int size = (entry >> kLutSizeShift) & 0xF;
  const int run = (entry >> kLutRunShift) & 0xF;
  const bool eob = (entry & kLutEobBit) != 0;
  o.invalid = clen == 0;

  // magnitude bits: the `size` bits following the codeword
  const uint32_t shift = (32u - (uint32_t)clen - (uint32_t)size) & 31u;
  const uint32_t mask = (1u << (uint32_t)size) - 1u;
  const int vbits = (int)((win32 >> shift) & mask);
  const int half = 1 << (size - 1 > 0 ? size - 1 : 0);
  const int full = 1 << size;
  int coef = vbits < half ? vbits - full + 1 : vbits;
  o.coef = size == 0 ? 0 : coef;

  int run_eff = eob ? 63 - st.z : run;
  run_eff = o.invalid ? 0 : run_eff;
  o.run_eff = run_eff;
  const int zstep = run_eff + 1;
  const int adv = o.invalid ? min_code_bits : clen + size;

  const int new_z = st.z + zstep;
  const bool blk_done = new_z >= 64;
  const int z_next = blk_done ? 0 : new_z;
  const int u_next = blk_done ? (st.u + 1 >= upm ? 0 : st.u + 1) : st.u;
  if (o.active) {
    st.p += adv;
    st.u = u_next;
    st.z = z_next;
    st.n += zstep;
  }
  return o;
}

// The stream kernel's loop over one lane: s_max steps, step i recording
// pos[i * stride] = the local zig-zag offset it wrote (-1: nothing) and
// val[i * stride] = its coefficient (0 where pos is -1). Every step
// stores, also once the lane has finished, so that the lanes of a warp
// (stride = C, consecutive lanes) store whole rows together; nothing is
// stored without `store`. row_done(i) runs after row i on every lane: the
// kernel's block barrier, nothing on the host. `extent`: the entries of
// pos and val from the lane's first on (the checked build's bound).
template <class Window, class Table, class RowDone>
__host__ __device__ __forceinline__ void stream_lane(
    Window& window, const Table& table, int limit, int upm,
    int min_code_bits, int s_max, LaneState& st, int32_t* pos, int32_t* val,
    int64_t stride, bool store, RowDone row_done,
    int64_t extent = INT64_MAX) {
  for (int i = 0; i < s_max; ++i) {
    int p = -1, v = 0;
    const bool active = st.p < limit;
    if (active) {
      const int n = st.n;
      const StepOut o =
          symbol_step(window, table, limit, upm, min_code_bits, st);
      if (!o.invalid) {
        p = n + o.run_eff;
        v = o.coef;
      }
    }
    if (store) {
      rt::st(pos, i * stride, extent, kSiteStream, p);
      rt::st(val, i * stride, extent, kSiteStream, v);
    }
    row_done(i);
  }
}

// -- the store kernel's loop ---------------------------------------------
//
// store_lane decodes one lane as the plain write pass does and stores each
// recorded coefficient at write_base + n + run_eff under the JAX store
// kernel's mask (kernels/fused/store.py: a recorded step, pos >= 0,
// 0 <= target <= write_max; targets past the buffer are dropped too).
//
// The coefficients of the unit being decoded go to the lane's slot of 64
// entries (`slot`), and `rec` holds which of them were recorded. A unit
// ends when the step that completes it sets z back to 0. A unit is whole
// when the lane decoded it from z = 0, with no invalid step, ending at
// exactly 64 coefficients, with all 64 targets within the mask and
// 16-byte aligned: `units` writes it out whole, the entries not recorded
// as 0, before the lane's next step (LaneUnits below: the lane itself, as
// 16 stores of 16 bytes; the kernel's WarpUnits: the warp together).
// Every other unit (the first when the lane enters at z > 0, the last
// when it stops inside a unit, one with an invalid step or past the mask)
// goes out entry by entry under the mask.
//
// Every lane runs the loop until units.any() says that no lane of its
// group is still decoding (on the card: its warp, so that the warp can
// write units together), each step of a lane that has finished doing
// nothing.
//
// Why this is exact on converged entries: every target the plain pass
// writes gets the same value; every extra zero falls on a coefficient of
// a unit that this lane alone decoded, which the caller's fill had zeroed.
// Returns the number of units stored whole.

#ifdef __CUDACC__
using Int4 = int4;
#define RT_UNROLL _Pragma("unroll")
#else
struct alignas(16) Int4 {
  int x, y, z, w;
};
#define RT_UNROLL
#endif

__host__ __device__ __forceinline__ int lowest_bit(uint64_t v) {
#ifdef __CUDA_ARCH__
  return __ffsll((long long)v) - 1;
#else
  return __builtin_ctzll(v);
#endif
}

struct CoefStore {
  int32_t* coef;   // (n_coef,), zeroed by the caller
  int64_t n_coef;
  int base;        // the lane's write_base
  int wmax;        // and write_max

  // one recorded coefficient at local offset pos, under the mask
  __host__ __device__ __forceinline__ void entry(int pos, int v) const {
    const int tgt = base + pos;
    if (pos >= 0 && tgt >= 0 && tgt <= wmax && tgt < n_coef) {
      rt::st(coef, (int64_t)tgt, n_coef, kSiteCoef, v);
    }
  }

  // the recorded entries of a slot (bit k of rec: offset n0 + k)
  __host__ __device__ __forceinline__ void entries(const int32_t* slot,
                                                   uint64_t rec,
                                                   int n0) const {
    while (rec != 0) {
      const int k = lowest_bit(rec);
      rec &= rec - 1;
      entry(n0 + k, ld(slot, k, 64, kSiteSlot));
    }
  }

  // whether the unit at local offset n0 may go out whole: its 64 targets
  // within the mask, 16-byte aligned
  __host__ __device__ __forceinline__ bool fits(int n0) const {
    const int t0 = base + n0;
    return n0 >= 0 && t0 >= 0 && t0 + 63 <= wmax && t0 + 63 < n_coef &&
           (reinterpret_cast<uintptr_t>(coef + t0) & 15) == 0;
  }

  // the unit at local offset n0 (fits) as 16 stores of 16 bytes
  __host__ __device__ __forceinline__ void unit(const int32_t* slot,
                                                uint64_t rec,
                                                int n0) const {
    Int4* dst = reinterpret_cast<Int4*>(coef + base + n0);
    RT_UNROLL
    for (int q = 0; q < 16; ++q) {
      int v[4];
      RT_UNROLL
      for (int j = 0; j < 4; ++j) {
        const int k = 4 * q + j;
        v[j] = (rec >> k) & 1u ? slot[k] : 0;
      }
      if (ok((int64_t)base + n0 + 4 * q + 3, n_coef, kSiteCoef)) {
        dst[q] = Int4{v[0], v[1], v[2], v[3]};
      }
    }
  }
};

// store_lane's whole units written by the lane itself, at once (the host
// build; the store kernel's with few lanes)
struct LaneUnits {
  __host__ __device__ __forceinline__ bool any(bool active) const {
    return active;
  }
  __host__ __device__ __forceinline__ void write(bool ready, int n0,
                                                 uint64_t rec,
                                                 const int32_t* slot,
                                                 const CoefStore& out) const {
    if (ready) out.unit(slot, rec, n0);
  }
};

template <class Window, class Table, class Units>
__host__ __device__ __forceinline__ int store_lane(
    Window& window, const Table& table, int limit, int upm,
    int min_code_bits, int s_max, LaneState& st, const CoefStore& out,
    int32_t* slot, const Units& units) {
  int n_whole = 0;
  // the unit being decoded: whole so far, its first offset, its entries
  bool whole = st.z == 0;
  int n0 = st.n;
  uint64_t rec = 0;
  for (int i = 0; i < s_max; ++i) {
    const bool active = st.p < limit;
    if (!units.any(active)) break;
    bool ready = false;  // a whole unit to write out: its offset, entries
    int ready_n0 = 0;
    uint64_t ready_rec = 0;
    if (active) {
      const int n = st.n;
      const StepOut o =
          symbol_step(window, table, limit, upm, min_code_bits, st);
      const int pos = n + o.run_eff;
      const int k = pos - n0;
      if (whole && !o.invalid && k < 64) {
        rt::st(slot, k, 64, kSiteSlot, o.coef);
        rec |= (uint64_t)1 << k;
      } else {
        if (whole) {  // an invalid step or a run past the unit
          out.entries(slot, rec, n0);
          whole = false;
        }
        if (!o.invalid) out.entry(pos, o.coef);
      }
      if (st.z == 0) {  // this step ended the unit
        if (whole && st.n - n0 == 64 && out.fits(n0)) {
          ready = true;
          ready_n0 = n0;
          ready_rec = rec;
          ++n_whole;
        } else if (whole) {
          out.entries(slot, rec, n0);
        }
        whole = true;
        n0 = st.n;
        rec = 0;
      }
    }
    units.write(ready, ready_n0, ready_rec, slot, out);
  }
  if (whole) out.entries(slot, rec, n0);
  return n_whole;
}

}  // namespace rt
