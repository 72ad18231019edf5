"""The CUDA symbol step (csrc/huffman.cuh) run on the host.

The header's step is ``__host__ __device__``; a small C++ shim compiled
with g++ runs it for every lane of real plans, exactly as the kernels loop
over it, and the results must equal the plain torch decoder bit for bit.
It runs the exit kernel's step (a per-lane word buffer, the compact tables
of ``ops.compact_luts``), the stream kernel's loop over a lane
(``rt::stream_lane``) and the store kernel's (``rt::store_lane``, with its
unit slot as a plain array), whose exits and coefficients are also held
against the JAX package's ``decode_span``. This checks the kernels' own
bit operations without a card.
"""
import ctypes
import functools
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
from repro_torch.kernels.fused import store as FS
from repro_torch.kernels.huffman import ops as HK

from _torch_corpus import CORPORA, corpus

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / \
    "kernels" / "csrc"

SHIM = r"""
#include "huffman.cuh"

#define ARGS                                                               \
  const uint32_t *words, int n_words, const uint16_t *ctab,                \
      const int32_t *lut_off, const int32_t *word_base, const int32_t *ts, \
      const int32_t *limit, const int32_t *upm, const int32_t *in_p,       \
      const int32_t *in_u, const int32_t *in_z, int32_t *exits,            \
      int32_t *pos, int32_t *val, int n_lanes, int s_max, int min_code_bits

// The exit kernel's step (rt::BufferedWindow, rt::CompactLut) over every
// lane, each step's (pos, val) recorded in rows of stride n_lanes.
extern "C" void host_run_compact(ARGS) {
  for (int lane = 0; lane < n_lanes; ++lane) {
    const int64_t slots = (int64_t)ts[lane] * (2 * rt::kMaxUpm);
    rt::LaneState st{in_p[lane], in_u[lane], in_z[lane], 0};
    rt::BufferedWindow window(words, n_words, word_base[lane], st.p);
    const rt::CompactLut<false> table{ctab, lut_off + slots};
    int i = 0;
    for (; i < s_max && st.p < limit[lane]; ++i) {
      const int n = st.n;
      rt::StepOut o = rt::symbol_step(window, table, limit[lane], upm[lane],
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

// The store kernel's loop (rt::store_lane) over every lane into coef
// (zeroed by the caller), with a unit slot of 64 entries, the lane
// writing its whole units itself. Returns the units stored whole.
extern "C" long long host_run_store(ARGS, const int32_t *write_base,
                                    const int32_t *write_max, int32_t *coef,
                                    long long n_coef) {
  long long n_whole = 0;
  int32_t slot[64];
  for (int lane = 0; lane < n_lanes; ++lane) {
    const int64_t slots = (int64_t)ts[lane] * (2 * rt::kMaxUpm);
    rt::LaneState st{in_p[lane], in_u[lane], in_z[lane], 0};
    rt::BufferedWindow window(words, n_words, word_base[lane], st.p);
    const rt::CompactLut<false> table{ctab, lut_off + slots};
    const rt::CoefStore out{coef, n_coef, write_base[lane], write_max[lane]};
    n_whole += rt::store_lane(window, table, limit[lane], upm[lane],
                              min_code_bits, s_max, st, out, slot,
                              rt::LaneUnits{});
    exits[lane * 4 + 0] = st.p;
    exits[lane * 4 + 1] = st.u;
    exits[lane * 4 + 2] = st.z;
    exits[lane * 4 + 3] = st.n;
  }
  return n_whole;
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
    args = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 12 + \
        [ctypes.c_int] * 3
    for fn in (lib.host_run_compact, lib.host_run_stream):
        fn.argtypes = args
        fn.restype = None
    lib.host_run_store.argtypes = args + [ctypes.c_void_p] * 3 + \
        [ctypes.c_longlong]
    lib.host_run_store.restype = ctypes.c_longlong
    return lib


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _host_args(dev, meta, entry):
    """The shim's operands before its outputs: (the contiguous tensors,
    which must outlive the call, and the C arguments)."""
    tables = HK.exit_tables(dev)
    args = [dev["words"], tables["luts_compact"], tables["unit_lut_off"],
            meta["word_base"], meta["ts"], meta["limit"], meta["upm"],
            entry.p, entry.u, entry.z]
    args = [a.contiguous() for a in args]
    return args, [_ptr(args[0]), int(args[0].shape[0])] + \
        [_ptr(a) for a in args[1:]]


def host_decode(lib, dev, meta, entry, s_max, min_code_bits, stream=False):
    """Exits (4, C) and streams (s_max, C) from the host build: the exit
    kernel's step, or the stream kernel's loop (``stream``)."""
    c = entry.p.shape[0]
    exits = torch.zeros((c, 4), dtype=torch.int32)
    pos = torch.zeros((s_max, c), dtype=torch.int32)
    val = torch.zeros((s_max, c), dtype=torch.int32)
    fn = lib.host_run_stream if stream else lib.host_run_compact
    _, args = _host_args(dev, meta, entry)
    fn(*args, _ptr(exits), _ptr(pos), _ptr(val), c, s_max, min_code_bits)
    return DecodeState(*exits.T), pos, val


def host_store(lib, dev, meta, entry, write_base, write_max, n_coef,
               s_max, min_code_bits):
    """Exits (4, C), the (n_coef,) coefficients and the units stored whole
    by the host build of the store kernel's loop."""
    c = entry.p.shape[0]
    exits = torch.zeros((c, 4), dtype=torch.int32)
    coef = torch.zeros(n_coef, dtype=torch.int32)
    empty = torch.zeros(0, dtype=torch.int32)
    wb, wm = write_base.contiguous(), write_max.contiguous()
    _, args = _host_args(dev, meta, entry)
    n_whole = lib.host_run_store(
        *args, _ptr(exits), _ptr(empty), _ptr(empty), c, s_max,
        min_code_bits, _ptr(wb), _ptr(wm), _ptr(coef), n_coef)
    return DecodeState(*exits.T), coef, n_whole


def converged_plan(name, chunk_bits):
    """A corpus plan's tensors, lane metadata, step bounds and converged
    Jacobi result (shared by the tests: not to be changed in place)."""
    plan = build_batch_plan(corpus(name), chunk_bits=chunk_bits)
    shape = plan_shape(plan, bucket=True)
    data = build_plan_data(plan, shape)
    arrays = dict(data.arrays, words=data.words)
    dev = dev_from_numpy(arrays, "cpu")
    meta = D.chunk_meta(dev)
    kw = dict(s_max=shape.s_max, min_code_bits=shape.min_code_bits)
    res = jacobi_sync(dev, max_rounds=shape.n_chunks + 2, permuted=False,
                      decode_exits=lambda d, e: HK.decode_exits_plain(
                          d, meta, e, **kw))
    assert res.converged
    return arrays, dev, meta, kw, shape, res


def check_against_plain(host_lib, name, chunk_bits):
    _, dev, meta, kw, _, res = converged_plan(name, chunk_bits)
    cold = DecodeState.cold(dev["chunk_start"])
    chained = chain_entries(dev, res.exits, permuted=False)
    for entry in (cold, chained):
        got, pos, val = host_decode(host_lib, dev, meta, entry, **kw)
        exp = HK.decode_exits_plain(dev, meta, entry, **kw)
        for g, e in zip(got, exp):
            np.testing.assert_array_equal(g.numpy(), e.numpy())
        exp_pos, exp_val = HK.decode_streams_plain(dev, meta, entry, **kw)
        np.testing.assert_array_equal(pos.numpy(), exp_pos.numpy())
        np.testing.assert_array_equal(val.numpy(), exp_val.numpy())


def invalid_steps(dev, meta, entry, s_max, min_code_bits):
    """Per lane, the steps it takes whose window starts no codeword."""
    words64 = D.widen_words(dev["words"])
    st = DecodeState(entry.p, entry.u, entry.z, torch.zeros_like(entry.p))
    count = torch.zeros_like(entry.p)
    for _ in range(s_max):
        o = D.decode_symbol(words64, dev["luts"], dev["unit_lut_row"], st,
                            meta["word_base"], meta["limit"], meta["ts"],
                            meta["upm"], min_code_bits)
        count += (o.active & o.invalid).to(count.dtype)
        st = o.state
    return count


@pytest.mark.parametrize("case", ["planned", "cut", "past_segment"])
@pytest.mark.parametrize("name", CORPORA)
@pytest.mark.parametrize("chunk_bits", [256, 1024])
def test_host_symbol_step_matches_plain(host_lib, name, chunk_bits, case):
    """The store kernel's loop (rt::store_lane: the word buffer, the
    compact tables, a unit slot) over every lane on converged entries:
    the coefficients equal ``decode_coeffs_store_plain`` and the JAX
    package's ``decode_span(write=True)``, the exits the plain decoder's.
    Most lanes enter mid-unit. ``cut``: every other lane's write_max falls 40
    coefficients short of its end, inside a unit it decoded.
    ``past_segment``: the last lane of every segment decodes 1024 bits
    past its segment, into the next one's, and the lane that ends the
    batch's bits into all-ones words, taking invalid steps; what they
    decode there falls past their write_max."""
    arrays, dev, meta, kw, shape, res = converged_plan(name, chunk_bits)
    entry = chain_entries(dev, res.exits, permuted=False)
    base = D.chunk_write_bases(dev, res.exits.n, permuted=False)
    seg_end = torch.cat([dev["seg_coeff_base"][1:], dev["units_end"][None]])
    wmax = seg_end[dev["chunk_seg"].to(torch.int64)] - 1
    # segments start at unit boundaries: whole units are 16-byte aligned
    assert bool((dev["seg_coeff_base"] % 64 == 0).all())
    assert bool((entry.z > 0).any())  # lanes entered mid-unit
    meta = dict(meta)
    if case == "cut":
        lane = torch.arange(wmax.shape[0])
        short = base + res.exits.n - 41
        wmax = torch.where((lane % 2 == 1) & (short < wmax), short, wmax)
    elif case == "past_segment":
        seg = dev["chunk_seg"]
        last = torch.ones_like(seg, dtype=torch.bool)
        last[:-1] = seg[1:] != seg[:-1]
        # the lane that ends the batch's bits, and all-ones words after them
        # (windows that start no codeword)
        end = torch.where(meta["limit"] > 0, meta["word_base"].to(
            torch.int64) * 32 + meta["limit"], -1)
        last[int(end.argmax())] = True
        words = dev["words"].clone()
        words[int(end.max() + 31) // 32:] = -1
        dev = dict(dev, words=words)
        arrays = dict(arrays, words=words.numpy().view(np.uint32))
        meta["limit"] = torch.where(last & (meta["limit"] > 0),
                                    meta["limit"] + 1024, meta["limit"])
        assert int(invalid_steps(dev, meta, entry, **kw).sum()) > 0
    n_coef = shape.n_units * 64
    exp = FS.decode_coeffs_store_plain(dev, meta, entry, base, wmax, n_coef,
                                       **kw)
    exp_exits = HK.decode_exits_plain(dev, meta, entry, **kw)
    jdev = {k: jnp.asarray(v) for k, v in arrays.items()}
    jentry = RState(*(jnp.asarray(f.numpy()) for f in entry))
    jexits, jout = RD.decode_span(
        jdev, jentry, jnp.asarray(meta["word_base"].numpy()),
        jnp.asarray(meta["limit"].numpy()), jnp.asarray(meta["ts"].numpy()),
        jnp.asarray(meta["upm"].numpy()), write=True,
        out=jnp.zeros(n_coef, jnp.int32), write_base=jnp.asarray(
            base.numpy()), write_max=jnp.asarray(wmax.numpy()), **kw)
    np.testing.assert_array_equal(exp.numpy(), np.asarray(jout))
    got_exits, got, n_whole = host_store(host_lib, dev, meta, entry, base,
                                         wmax, n_coef, **kw)
    np.testing.assert_array_equal(got.numpy(), exp.numpy())
    for g, e, j in zip(got_exits, exp_exits, jexits):
        np.testing.assert_array_equal(g.numpy(), e.numpy())
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    # at 1024 bits a lane spans several units, and most go out whole
    units = int(dev["units_end"]) // 64
    assert n_whole > (units * 3 // 4 if chunk_bits == 1024 else 0)


@pytest.mark.parametrize("name", CORPORA)
@pytest.mark.parametrize("chunk_bits", [256, 1024])
def test_host_exit_kernel_step_matches_plain(host_lib, name, chunk_bits):
    """The exit kernel's step: the word buffer and the compact tables."""
    check_against_plain(host_lib, name, chunk_bits)


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
    got, pos, val = host_decode(host_lib, dev, meta, entry, **kw)
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
    arrays, dev, meta, kw, _, res = converged_plan(name, chunk_bits)
    jdev = {k: jnp.asarray(v) for k, v in arrays.items()}
    jmeta = RD.chunk_meta(jdev)
    for entry in (DecodeState.cold(dev["chunk_start"]),
                  chain_entries(dev, res.exits, permuted=False)):
        got, pos, val = host_decode(host_lib, dev, meta, entry, **kw,
                                    stream=True)
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
