// One Huffman symbol step of one chunk lane: the shared body of the exit,
// stream and store kernels in huffman.cu.
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
// parameter of symbol_step; the bit operations after them are one body:
//   * window sources: WordWindow loads the two words at p on every step
//     (stream and store kernels); BufferedWindow keeps words w and w+1 in
//     registers and w+2 prefetched, and loads one word when p >> 5 moves on
//     (exit kernel). A step advances at most 31 bits (clen + size <= 31, or
//     min_code_bits <= 16), so p >> 5 moves by at most one. Both clamp the
//     word index exactly as load_word does, so both give the same window;
//   * tables: FullLut reads the (L, 65536) int32 LUTs (stream and store
//     kernels); CompactLut reads the two-level uint16 tables that
//     kernels/huffman/ops.compact_luts builds from them, which expand to
//     the same entry for every window (tests/test_torch_lut.py).
//
// The functions are __host__ __device__ so that a host-only build of this
// header (g++, see tests/test_torch_symbol_step.py) runs the same code on
// the CPU.
#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

#ifdef __CUDA_ARCH__
#define RT_LDG(ptr) __ldg(ptr)
#else
#define RT_LDG(ptr) (*(ptr))
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

__host__ __device__ __forceinline__ uint32_t load_word(const uint32_t* words,
                                                       int n_words,
                                                       int64_t idx) {
  idx = idx < 0 ? 0 : (idx >= n_words ? n_words - 1 : idx);
  return words[idx];
}

// The window at bit offset `off` (0..31) of the word pair (hi, lo).
__host__ __device__ __forceinline__ uint32_t window32(uint32_t hi, uint32_t lo,
                                                      uint32_t off) {
  const uint32_t lo_shift = off == 0u ? 0u : (lo >> ((32u - off) & 31u));
  return (hi << off) | lo_shift;
}

// -- window sources: operator()(p) is the 32-bit window at segment bit p ----

struct WordWindow {
  const uint32_t* words;
  int n_words;
  int word_base;

  __host__ __device__ __forceinline__ uint32_t operator()(int p) const {
    const int64_t w = (int64_t)word_base + (p >> 5);
    return window32(load_word(words, n_words, w),
                    load_word(words, n_words, w + 1), (uint32_t)(p & 31));
  }
};

// Word indices in 32 bits: the planner guarantees n_words * 32 + 63 fits
// int32 (core/contracts.check_shape_capacities), so word_base + (p >> 5) + 2
// does too, and load_word32 clamps it as load_word does.
__host__ __device__ __forceinline__ uint32_t load_word32(
    const uint32_t* words, int n_words, int idx) {
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

// -- tables: entry(slot, win16), slot = u * 2 + is_dc of the lane's row ----

struct FullLut {
  const int32_t* luts;  // (L, 65536)
  const int32_t* rows;  // the lane's tableset row of unit_lut_row: LUT ids

  __host__ __device__ __forceinline__ int entry(int slot, int win16) const {
    const int row = RT_LDG(rows + slot);
    return RT_LDG(luts + (int64_t)row * kLutSize + win16);
  }
};

// kLdg: the tables lie in global memory (read through __ldg), else in
// shared memory. A primary entry whose code length is 0 but which is not 0
// points to a secondary: entry >> 5 is its offset in units of 2^7 entries
// from the row's start (the one entry of code length 0 in a LUT is the
// invalid window, 0, which stays 0).
template <bool kLdg>
struct CompactLut {
  const uint16_t* tab;  // every row: primary, then its secondaries
  const int32_t* offs;  // the lane's tableset row of unit_lut_off: starts

  __host__ __device__ __forceinline__ uint32_t load(int64_t i) const {
#ifdef __CUDA_ARCH__
    if (kLdg) return __ldg(tab + i);
#endif
    return tab[i];
  }

  __host__ __device__ __forceinline__ int entry(int slot, int win16) const {
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

// The step from global memory: two word loads and the full LUTs. `rows` is
// the lane's tableset row of unit_lut_row: 2*kMaxUpm LUT row ids, [u*2 + 0]
// for AC and [u*2 + 1] for DC.
__host__ __device__ __forceinline__ StepOut symbol_step(
    const uint32_t* words, int n_words, const int32_t* luts,
    const int32_t* rows, int word_base, int limit, int upm,
    int min_code_bits, LaneState& st) {
  WordWindow window{words, n_words, word_base};
  const FullLut table{luts, rows};
  return symbol_step(window, table, limit, upm, min_code_bits, st);
}

}  // namespace rt
