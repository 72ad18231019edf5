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

// One step. `rows` is the lane's tableset row of unit_lut_row: 2*kMaxUpm
// LUT row ids, [u*2 + 0] for AC and [u*2 + 1] for DC.
__host__ __device__ __forceinline__ StepOut symbol_step(
    const uint32_t* words, int n_words, const int32_t* luts,
    const int32_t* rows, int word_base, int limit, int upm,
    int min_code_bits, LaneState& st) {
  StepOut o;
  o.active = st.p < limit;

  const int64_t w = (int64_t)word_base + (st.p >> 5);
  const uint32_t off = (uint32_t)(st.p & 31);
  const uint32_t hi = load_word(words, n_words, w);
  const uint32_t lo = load_word(words, n_words, w + 1);
  const uint32_t lo_shift = off == 0u ? 0u : (lo >> ((32u - off) & 31u));
  const uint32_t win32 = (hi << off) | lo_shift;
  const int win16 = (int)(win32 >> 16);

  const int is_dc = st.z == 0 ? 1 : 0;
  const int row = RT_LDG(rows + st.u * 2 + is_dc);
  const int entry = RT_LDG(luts + (int64_t)row * kLutSize + win16);

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

}  // namespace rt
