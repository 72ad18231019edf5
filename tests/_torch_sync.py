"""Shared helpers of the tests that hold the port's sync schedules against
the JAX package's on shared plans (``test_torch_sync.py``,
``test_torch_sync_specmap.py``).

One plan (the JAX package's, bucketed) feeds both: its arrays go to JAX as
``jnp`` arrays and to the port through ``dev_from_numpy``, and each
schedule runs with the bounds ``core/api.py`` gives it
(:func:`check_schedule`).
"""
from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as RA
from repro.core import bitstream as RB
from repro.core import decode as RD
from repro.core import sync as RS
from repro.core.state import DecodeState as RState
from repro.dist.plan import balance_lanes
from repro.jpeg import codec_ref as cr
from repro.jpeg.format import parse_jpeg as r_parse, unstuff_scan as r_unstuff
from repro_torch.core import api
from repro_torch.core import decode as D
from repro_torch.core.bitstream import dev_from_numpy
# chip_smoke.py draws its frames with it: these are the frames the card runs
from repro_torch.jpeg.encoder import synth_frame
from repro_torch.kernels.huffman import ops as HK

from _torch_corpus import oracle_coeffs


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread for each test of the files that import this
    fixture. The schedules' plain exit decode is thousands of small
    torch ops, which intra-op threads do not speed up (specmap on the
    full-HD plan: 51 s alone with every thread, 63 s with one) and which
    contend with the other test workers for the cores (407 s in a
    six-worker run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

SYNC_CORPORA = ("420", "restart", "mixed", "optimized")


def plan_of(blobs, sync, chunk_bits, balance=None):
    """The JAX package's plan of ``blobs`` as ``from_bytes`` builds it."""
    if sync == "sequential":
        unstuffed = [r_unstuff(r_parse(b).scan_data) for b in blobs]
        chunk_bits = RA._sequential_chunk_bits(unstuffed)
    plan = RB.build_batch_plan(blobs, chunk_bits=chunk_bits)
    if balance:
        plan = balance_lanes(plan, balance, "lpt")
    return RB.split_plan(plan, bucket=True)


def _jax_sync(jdev, sh, sync):
    """``repro``'s schedule with the bounds of ``repro.core.api``."""
    kw = dict(s_max=sh.s_max, min_code_bits=sh.min_code_bits,
              permuted=sh.permuted)
    if sync == "jacobi":
        return RS.jacobi_sync(jdev, max_rounds=sh.n_chunks + 2, **kw)
    if sync == "specmap":
        return RS.specmap_sync(jdev, max_upm=RB.MAX_UPM,
                               max_verify=sh.n_chunks + RB.MAX_UPM + 2, **kw)
    if sync == "faithful":
        return RS.faithful_sync(jdev, seq_chunks=sh.seq_chunks,
                                max_outer=sh.n_sequences + 2, **kw)
    fn = RD.make_decode_exits(s_max=sh.s_max,
                              min_code_bits=sh.min_code_bits)
    return RS.SyncResult(fn(jdev, RState.cold(jdev["chunk_start"])), 1,
                         True)


def _torch_sync(tdev, sh, sync):
    meta = D.chunk_meta(tdev)
    kw = dict(s_max=sh.s_max, min_code_bits=sh.min_code_bits)

    def decode_exits(d, entry, idx=None):
        return HK.decode_exits_plain(d, meta, entry, idx, **kw)

    return api.run_sync(tdev, sh, sync, decode_exits)


def check_schedule(blobs, sync, chunk_bits, balance=None):
    sh, data = plan_of(blobs, sync, chunk_bits, balance)
    assert sh.permuted == bool(balance)
    arrays = dict(data.arrays, words=data.words)
    jdev = {k: jnp.asarray(v) for k, v in arrays.items()}
    tdev = dev_from_numpy(arrays, "cpu")
    exp = _jax_sync(jdev, sh, sync)
    got = _torch_sync(tdev, sh, sync)
    for f, a, g in zip("puzn", exp.exits, got.exits):
        np.testing.assert_array_equal(np.asarray(a), g.numpy(), err_msg=f)
    assert got.rounds == int(exp.rounds)
    assert got.converged is bool(exp.converged) is True
    coeffs, rounds, converged = api.decode_coefficients(
        tdev, sh, backend="torch", fuse="none", sync=sync)
    assert (rounds, converged) == (got.rounds, True)
    np.testing.assert_array_equal(coeffs[:data.total_units].numpy(),
                                  oracle_coeffs(blobs))
    return got



def schedule_cases(syncs):
    """(sync, corpus, chunk_bits) of each of ``syncs`` on every corpus:
    sequential sizes its own chunks (one per segment), so it runs once."""
    return [(s, n, b) for s in syncs for n in SYNC_CORPORA
            for b in ((0,) if s == "sequential" else (128, 256))]


FULL_HD_CHUNK_BITS = 1024


@lru_cache(maxsize=1)
def full_hd_plan():
    """One plan of the first two frames of ``chip_smoke.py``'s full-width
    batch (1920x1080, q95, 4:2:0) at chunk_bits 1024, as JAX arrays and
    as the port's (``test_torch_sync_fullhd*.py``)."""
    rng = np.random.default_rng(0)  # chip_smoke.py's default --seed
    blobs = [cr.encode_baseline(synth_frame(rng, 1920, 1080, t=0.13 * i),
                                quality=95, subsampling="4:2:0").jpeg_bytes
             for i in range(2)]
    sh, data = plan_of(blobs, "jacobi", FULL_HD_CHUNK_BITS)
    arrays = dict(data.arrays, words=data.words)
    jdev = {k: jnp.asarray(v) for k, v in arrays.items()}
    return sh, jdev, dev_from_numpy(arrays, "cpu")


def assert_same_exits(exp, got):
    for f, a, g in zip("puzn", exp.exits, got.exits):
        np.testing.assert_array_equal(np.asarray(a), g.numpy(), err_msg=f)


def check_full_hd_schedule(sync):
    """``sync`` on :func:`full_hd_plan`: ``repro``'s exits,
    ``sync_rounds`` and ``converged``, bit for bit."""
    sh, jdev, tdev = full_hd_plan()
    assert sh.n_chunks > 10_000 and not sh.permuted
    exp = _jax_sync(jdev, sh, sync)
    got = _torch_sync(tdev, sh, sync)
    assert_same_exits(exp, got)
    assert got.rounds == int(exp.rounds)
    assert got.converged is bool(exp.converged) is True
