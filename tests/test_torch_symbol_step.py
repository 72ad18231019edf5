"""The CUDA symbol step (csrc/huffman.cuh) run on the host.

The header's step is ``__host__ __device__``; a small C++ shim compiled
with g++ runs it for every lane of real plans, exactly as the kernels loop
over it, and the results must equal the plain torch decoder bit for bit.
It runs both instantiations of the templated step: the store kernel's (two
word loads a step, the full LUTs) and the exit and stream kernels' (a
per-lane word buffer, the compact tables of ``ops.compact_luts``), and the
stream kernel's own loop over a lane (``rt::stream_lane``), whose exits
are also held against the JAX package's ``decode_span``. This checks the
kernels' own bit operations without a card.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import decode as RD
from repro.core.state import DecodeState as RState
from repro_torch.core import decode as D
from repro_torch.core.bitstream import (build_batch_plan, build_plan_data,
                                        dev_from_numpy, plan_shape)
from repro_torch.core.state import DecodeState
from repro_torch.core.sync import chain_entries, jacobi_sync
from repro_torch.kernels.huffman import ops as HK

from _torch_corpus import CORPORA, corpus

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / \
    "kernels" / "csrc"

SHIM = r"""
#include "huffman.cuh"

// kCompact: the exit kernel's sources (rt::BufferedWindow, rt::CompactLut);
// otherwise the store kernel's (the global-memory overload)
template <bool kCompact>
void run(const uint32_t* words, int n_words, const int32_t* luts,
         const int32_t* lut_rows, const uint16_t* ctab,
         const int32_t* lut_off, const int32_t* word_base,
         const int32_t* ts, const int32_t* limit, const int32_t* upm,
         const int32_t* in_p, const int32_t* in_u, const int32_t* in_z,
         int32_t* exits, int32_t* pos, int32_t* val, int n_lanes, int s_max,
         int min_code_bits) {
  for (int lane = 0; lane < n_lanes; ++lane) {
    const int64_t slots = (int64_t)ts[lane] * (2 * rt::kMaxUpm);
    const int32_t* rows = lut_rows + slots;
    rt::LaneState st{in_p[lane], in_u[lane], in_z[lane], 0};
    rt::BufferedWindow window(words, n_words, word_base[lane], st.p);
    const rt::CompactLut<false> table{ctab, lut_off + slots};
    int i = 0;
    for (; i < s_max && st.p < limit[lane]; ++i) {
      const int n = st.n;
      rt::StepOut o =
          kCompact ? rt::symbol_step(window, table, limit[lane], upm[lane],
                                     min_code_bits, st)
                   : rt::symbol_step(words, n_words, luts, rows,
                                     word_base[lane], limit[lane], upm[lane],
                                     min_code_bits, st);
      pos[(int64_t)i * n_lanes + lane] = o.invalid ? -1 : n + o.run_eff;
      val[(int64_t)i * n_lanes + lane] = o.invalid ? 0 : o.coef;
    }
    for (; i < s_max; ++i) {
      pos[(int64_t)i * n_lanes + lane] = -1;
      val[(int64_t)i * n_lanes + lane] = 0;
    }
    exits[lane * 4 + 0] = st.p;
    exits[lane * 4 + 1] = st.u;
    exits[lane * 4 + 2] = st.z;
    exits[lane * 4 + 3] = st.n;
  }
}

#define ARGS                                                               \
  const uint32_t *words, int n_words, const int32_t *luts,                 \
      const int32_t *lut_rows, const uint16_t *ctab,                       \
      const int32_t *lut_off, const int32_t *word_base, const int32_t *ts, \
      const int32_t *limit, const int32_t *upm, const int32_t *in_p,       \
      const int32_t *in_u, const int32_t *in_z, int32_t *exits,            \
      int32_t *pos, int32_t *val, int n_lanes, int s_max, int min_code_bits
#define PASS                                                               \
  words, n_words, luts, lut_rows, ctab, lut_off, word_base, ts, limit, upm, \
      in_p, in_u, in_z, exits, pos, val, n_lanes, s_max, min_code_bits

extern "C" void host_run(ARGS) { run<false>(PASS); }
extern "C" void host_run_compact(ARGS) { run<true>(PASS); }

// The stream kernel's loop (rt::stream_lane) over every lane, with its
// sources, writing rows of stride n_lanes as the kernel does.
extern "C" void host_run_stream(ARGS) {
  for (int lane = 0; lane < n_lanes; ++lane) {
    const int64_t slots = (int64_t)ts[lane] * (2 * rt::kMaxUpm);
    rt::LaneState st{in_p[lane], in_u[lane], in_z[lane], 0};
    rt::BufferedWindow window(words, n_words, word_base[lane], st.p);
    const rt::CompactLut<false> table{ctab, lut_off + slots};
    rt::stream_lane(window, table, limit[lane], upm[lane], min_code_bits,
                    s_max, st, pos + lane, val + lane, (int64_t)n_lanes,
                    true, [](int) {});
    exits[lane * 4 + 0] = st.p;
    exits[lane * 4 + 1] = st.u;
    exits[lane * 4 + 2] = st.z;
    exits[lane * 4 + 3] = st.n;
  }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("symbol_step")
    (d / "shim.cpp").write_text(SHIM)
    so = d / "libshim.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC",
                    f"-I{CSRC}", str(d / "shim.cpp"), "-o", str(so)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    for fn in (lib.host_run, lib.host_run_compact, lib.host_run_stream):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + \
            [ctypes.c_void_p] * 14 + [ctypes.c_int] * 3
        fn.restype = None
    return lib


def host_decode(lib, dev, meta, entry, s_max, min_code_bits, compact,
                stream=False):
    """Exits (4, C) and streams (s_max, C) from the host build: the exit
    kernel's step (``compact``), the store kernel's, or the stream
    kernel's loop (``stream``)."""
    c = entry.p.shape[0]
    tables = HK.exit_tables(dev)
    args = [dev["words"], dev["luts"], dev["unit_lut_row"],
            tables["luts_compact"], tables["unit_lut_off"],
            meta["word_base"], meta["ts"], meta["limit"], meta["upm"],
            entry.p, entry.u, entry.z]
    args = [a.contiguous() for a in args]
    exits = torch.zeros((c, 4), dtype=torch.int32)
    pos = torch.zeros((s_max, c), dtype=torch.int32)
    val = torch.zeros((s_max, c), dtype=torch.int32)
    ptrs = [ctypes.c_void_p(a.data_ptr()) for a in args]
    fn = lib.host_run_stream if stream else \
        lib.host_run_compact if compact else lib.host_run
    fn(ptrs[0], int(args[0].shape[0]), *ptrs[1:],
       ctypes.c_void_p(exits.data_ptr()), ctypes.c_void_p(pos.data_ptr()),
       ctypes.c_void_p(val.data_ptr()), c, s_max, min_code_bits)
    return DecodeState(*exits.T), pos, val


def check_against_plain(host_lib, name, chunk_bits, compact):
    plan = build_batch_plan(corpus(name), chunk_bits=chunk_bits)
    shape = plan_shape(plan, bucket=True)
    data = build_plan_data(plan, shape)
    dev = dev_from_numpy(dict(data.arrays, words=data.words), "cpu")
    meta = D.chunk_meta(dev)
    kw = dict(s_max=shape.s_max, min_code_bits=shape.min_code_bits)

    def exits_fn(d, entry):
        return HK.decode_exits_plain(d, meta, entry, **kw)

    res = jacobi_sync(dev, max_rounds=shape.n_chunks + 2,
                      decode_exits=exits_fn, permuted=False)
    assert res.converged
    cold = DecodeState.cold(dev["chunk_start"])
    chained = chain_entries(dev, res.exits, permuted=False)
    for entry in (cold, chained):
        got, pos, val = host_decode(host_lib, dev, meta, entry, **kw,
                                    compact=compact)
        exp = exits_fn(dev, entry)
        for g, e in zip(got, exp):
            np.testing.assert_array_equal(g.numpy(), e.numpy())
        exp_pos, exp_val = HK.decode_streams_plain(dev, meta, entry, **kw)
        np.testing.assert_array_equal(pos.numpy(), exp_pos.numpy())
        np.testing.assert_array_equal(val.numpy(), exp_val.numpy())


@pytest.mark.parametrize("name", CORPORA)
@pytest.mark.parametrize("chunk_bits", [256, 1024])
def test_host_symbol_step_matches_plain(host_lib, name, chunk_bits):
    """The stream and store kernels' step: two word loads, full LUTs."""
    check_against_plain(host_lib, name, chunk_bits, compact=False)


@pytest.mark.parametrize("name", CORPORA)
@pytest.mark.parametrize("chunk_bits", [256, 1024])
def test_host_exit_kernel_step_matches_plain(host_lib, name, chunk_bits):
    """The exit kernel's step: the word buffer and the compact tables."""
    check_against_plain(host_lib, name, chunk_bits, compact=True)


def test_word_buffer_clamps_like_the_word_loads(host_lib):
    """Lanes that start near and past the last word, and lanes whose entry
    jumps by many words: the buffered window's reload and clamp against
    the plain decoder."""
    plan = build_batch_plan(corpus("420"), chunk_bits=256)
    shape = plan_shape(plan, bucket=False)
    data = build_plan_data(plan, shape)
    dev = dev_from_numpy(dict(data.arrays, words=data.words), "cpu")
    n_words = dev["words"].shape[0]
    c = 64
    rng = np.random.default_rng(0)
    # every lane in segment 0 (word base 0), entries spread over the
    # stream's last 96 bits and 64 bits past its end
    meta = {k: v[:1].repeat(c) for k, v in D.chunk_meta(dev).items()}
    meta["word_base"] = torch.zeros(c, dtype=torch.int32)
    meta["limit"] = torch.full((c,), 32 * n_words + 64, dtype=torch.int32)
    p = torch.from_numpy(rng.integers(32 * n_words - 96, 32 * n_words + 64,
                                      c).astype(np.int32))
    entry = DecodeState(p, torch.zeros_like(p), torch.zeros_like(p),
                        torch.zeros_like(p))
    kw = dict(s_max=64, min_code_bits=shape.min_code_bits)
    got, pos, val = host_decode(host_lib, dev, meta, entry, **kw,
                                compact=True)
    exp = HK.decode_exits_plain(dev, meta, entry, **kw)
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(g.numpy(), e.numpy())
    exp_pos, exp_val = HK.decode_streams_plain(dev, meta, entry, **kw)
    np.testing.assert_array_equal(pos.numpy(), exp_pos.numpy())
    np.testing.assert_array_equal(val.numpy(), exp_val.numpy())


@pytest.mark.parametrize("name", CORPORA)
@pytest.mark.parametrize("chunk_bits", [256, 1024])
def test_host_stream_kernel_loop_matches_plain(host_lib, name, chunk_bits):
    """The stream kernel's loop (rt::stream_lane: the word buffer, the
    compact tables, a store every step) on cold and converged entries:
    streams equal ``decode_streams_plain``, exits equal the plain decoder
    and the JAX package's ``decode_span``."""
    plan = build_batch_plan(corpus(name), chunk_bits=chunk_bits)
    shape = plan_shape(plan, bucket=True)
    data = build_plan_data(plan, shape)
    arrays = dict(data.arrays, words=data.words)
    dev = dev_from_numpy(arrays, "cpu")
    jdev = {k: jnp.asarray(v) for k, v in arrays.items()}
    meta, jmeta = D.chunk_meta(dev), RD.chunk_meta(jdev)
    kw = dict(s_max=shape.s_max, min_code_bits=shape.min_code_bits)
    res = jacobi_sync(dev, max_rounds=shape.n_chunks + 2, permuted=False,
                      decode_exits=lambda d, e: HK.decode_exits_plain(
                          d, meta, e, **kw))
    assert res.converged
    for entry in (DecodeState.cold(dev["chunk_start"]),
                  chain_entries(dev, res.exits, permuted=False)):
        got, pos, val = host_decode(host_lib, dev, meta, entry, **kw,
                                    compact=True, stream=True)
        exp_pos, exp_val = HK.decode_streams_plain(dev, meta, entry, **kw)
        np.testing.assert_array_equal(pos.numpy(), exp_pos.numpy())
        np.testing.assert_array_equal(val.numpy(), exp_val.numpy())
        for g, e in zip(got, HK.decode_exits_plain(dev, meta, entry, **kw)):
            np.testing.assert_array_equal(g.numpy(), e.numpy())
        jentry = RState(*(jnp.asarray(f.numpy()) for f in entry))
        jexits, _ = RD.decode_span(jdev, jentry, jmeta["word_base"],
                                   jmeta["limit"], jmeta["ts"],
                                   jmeta["upm"], **kw)
        for g, e in zip(got, jexits):
            np.testing.assert_array_equal(g.numpy(), np.asarray(e))
