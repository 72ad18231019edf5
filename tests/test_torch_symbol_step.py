"""The CUDA symbol step (csrc/huffman.cuh) run on the host.

The header's step is ``__host__ __device__``; a small C++ shim compiled
with g++ runs it for every lane of real plans, exactly as the exit and
stream kernels loop over it, and the results must equal the plain torch
decoder bit for bit. This checks the kernels' own bit operations without
a card.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

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

extern "C" void host_run(const uint32_t* words, int n_words,
                         const int32_t* luts, const int32_t* lut_rows,
                         const int32_t* word_base, const int32_t* ts,
                         const int32_t* limit, const int32_t* upm,
                         const int32_t* in_p, const int32_t* in_u,
                         const int32_t* in_z, int32_t* exits, int32_t* pos,
                         int32_t* val, int n_lanes, int s_max,
                         int min_code_bits) {
  for (int lane = 0; lane < n_lanes; ++lane) {
    const int32_t* rows = lut_rows + (int64_t)ts[lane] * (2 * rt::kMaxUpm);
    rt::LaneState st{in_p[lane], in_u[lane], in_z[lane], 0};
    int i = 0;
    for (; i < s_max && st.p < limit[lane]; ++i) {
      const int n = st.n;
      rt::StepOut o = rt::symbol_step(words, n_words, luts, rows,
                                      word_base[lane], limit[lane],
                                      upm[lane], min_code_bits, st);
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
    lib.host_run.argtypes = [ctypes.c_void_p, ctypes.c_int] + \
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3
    lib.host_run.restype = None
    return lib


def host_decode(lib, dev, meta, entry, s_max, min_code_bits):
    """Exits (4, C) and streams (s_max, C) from the host build."""
    c = entry.p.shape[0]
    args = [dev["words"], dev["luts"], dev["unit_lut_row"],
            meta["word_base"], meta["ts"], meta["limit"], meta["upm"],
            entry.p, entry.u, entry.z]
    args = [a.contiguous() for a in args]
    exits = torch.zeros((c, 4), dtype=torch.int32)
    pos = torch.zeros((s_max, c), dtype=torch.int32)
    val = torch.zeros((s_max, c), dtype=torch.int32)
    ptrs = [ctypes.c_void_p(a.data_ptr()) for a in args]
    lib.host_run(ptrs[0], int(args[0].shape[0]), *ptrs[1:],
                 ctypes.c_void_p(exits.data_ptr()),
                 ctypes.c_void_p(pos.data_ptr()),
                 ctypes.c_void_p(val.data_ptr()), c, s_max, min_code_bits)
    return DecodeState(*exits.T), pos, val


@pytest.mark.parametrize("name", CORPORA)
@pytest.mark.parametrize("chunk_bits", [256, 1024])
def test_host_symbol_step_matches_plain(host_lib, name, chunk_bits):
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
        got, pos, val = host_decode(host_lib, dev, meta, entry, **kw)
        exp = exits_fn(dev, entry)
        for g, e in zip(got, exp):
            np.testing.assert_array_equal(g.numpy(), e.numpy())
        exp_pos, exp_val = HK.decode_streams_plain(dev, meta, entry, **kw)
        np.testing.assert_array_equal(pos.numpy(), exp_pos.numpy())
        np.testing.assert_array_equal(val.numpy(), exp_val.numpy())
