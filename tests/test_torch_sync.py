"""The port's sync schedules against the JAX package's, on shared plans
(``tests/_torch_sync.py``; specmap's and sequential's cases are in
``test_torch_sync_specmap.py``).

One plan (the JAX package's, bucketed) feeds both: its arrays go to JAX as
``jnp`` arrays and to the port through ``dev_from_numpy``, and each
schedule runs with the bounds ``core/api.py`` gives it. Exits,
``sync_rounds`` and ``converged`` must be bit-identical to
``repro.core.sync`` (``backend="jnp"``), on identity plans and on
``balance_lanes`` permutations, and the coefficients must equal the
sequential oracle.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as RA
from repro.core import decode as RD
from repro.core import sync as RS
from repro.core.state import DecodeState as RState
from repro.kernels.huffman import ops as RHK
from repro.kernels.huffman.ref import decode_exits_ref
from repro.jpeg.format import parse_jpeg as r_parse, unstuff_scan as r_unstuff
from repro_torch.core import api
from repro_torch.core import bitstream as TB
from repro_torch.core import decode as D
from repro_torch.core.bitstream import dev_from_numpy
from repro_torch.core.state import DecodeState
from repro_torch.core.sync import (BLOCK_ROUNDS, compose_prefix,
                                   faithful_sync, host_check)
from repro_torch.jpeg.format import parse_jpeg, unstuff_scan
from repro_torch.kernels.huffman import ops as HK

from _torch_corpus import corpus
from _torch_sync import one_thread  # noqa: F401 (autouse)
from _torch_sync import SYNC_CORPORA, check_schedule, plan_of, schedule_cases


# specmap and sequential in test_torch_sync_specmap.py: the two halves
# take about as long
@pytest.mark.parametrize("sync,name,chunk_bits",
                         schedule_cases(("jacobi", "faithful")))
def test_schedule_matches_repro(sync, name, chunk_bits):
    check_schedule(corpus(name), sync, chunk_bits)


@pytest.mark.parametrize("name", ["420", "restart", "mixed"])
@pytest.mark.parametrize("sync", ["jacobi", "faithful"])
def test_schedule_on_a_permuted_plan_matches_repro(sync, name):
    """A ``balance_lanes(plan, 4, "lpt")`` plan, carried over with its
    lane permutation (``permuted=True``)."""
    check_schedule(corpus(name), sync, 128, balance=4)


def test_faithful_without_verify_matches_repro():
    sh, data = plan_of(corpus("420"), "faithful", 128)
    arrays = dict(data.arrays, words=data.words)
    jdev = {k: jnp.asarray(v) for k, v in arrays.items()}
    tdev = dev_from_numpy(arrays, "cpu")
    exp = RS.faithful_sync(jdev, s_max=sh.s_max,
                           min_code_bits=sh.min_code_bits,
                           seq_chunks=sh.seq_chunks,
                           max_outer=sh.n_sequences + 2, verify=False,
                           permuted=False)
    meta = D.chunk_meta(tdev)
    got = faithful_sync(
        tdev, seq_chunks=sh.seq_chunks, max_outer=sh.n_sequences + 2,
        verify=False, permuted=False,
        decode_exits=lambda d, e, idx=None: HK.decode_exits_plain(
            d, meta, e, idx, s_max=sh.s_max,
            min_code_bits=sh.min_code_bits))
    for a, g in zip(exp.exits, got.exits):
        np.testing.assert_array_equal(np.asarray(a), g.numpy())
    assert (got.rounds, got.converged) == (int(exp.rounds),
                                           bool(exp.converged))


@pytest.mark.parametrize("name", SYNC_CORPORA)
def test_exit_decode_at_a_lane_subset_matches_repro(name):
    """The ``idx`` form (faithful's ``decode_at``) against the JAX
    reference and the Pallas exit kernel (interpret mode) decoded at the
    same subset, from converged entries."""
    sh, data = plan_of(corpus(name), "jacobi", 128)
    arrays = dict(data.arrays, words=data.words)
    jdev = {k: jnp.asarray(v) for k, v in arrays.items()}
    tdev = dev_from_numpy(arrays, "cpu")
    kw = dict(s_max=sh.s_max, min_code_bits=sh.min_code_bits)
    res = RS.jacobi_sync(jdev, max_rounds=sh.n_chunks + 2, permuted=False,
                         **kw)
    entries = RS.chain_entries(jdev, res.exits, False)
    idx = np.random.default_rng(3).permutation(sh.n_chunks)[
        :max(2, sh.n_chunks // 2)].astype(np.int32)
    jidx = jnp.asarray(idx)
    jentry = RState(*(f[jidx] for f in entries))
    m = RD.chunk_meta(jdev, jidx)
    exp = decode_exits_ref(jdev, jentry, m["word_base"], m["limit"],
                           m["ts"], m["upm"], **kw)
    pallas = RHK.decode_exits(jdev, jentry, jidx, chunk_bits=sh.chunk_bits,
                              interpret=True, **kw)
    for a, b in zip(exp, pallas):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    tentry = DecodeState(*(torch.from_numpy(np.array(f)) for f in jentry))
    tidx = torch.from_numpy(idx)
    meta = D.chunk_meta(tdev)
    before = (HK.decode_exits.launches, HK.decode_exits.subset_launches)
    for got in (HK.decode_exits(tdev, meta, tentry, tidx, **kw),
                HK.decode_exits_plain(tdev, meta, tentry, tidx, **kw)):
        for a, g in zip(exp, got):
            np.testing.assert_array_equal(np.asarray(a), g.numpy())
    # on the CPU the wrapper takes the plain version and launches nothing
    assert (HK.decode_exits.launches,
            HK.decode_exits.subset_launches) == before
    # the gathered metadata is chunk_meta at the subset
    sub = HK.lane_subset(meta, tidx)
    for k, v in D.chunk_meta(tdev, tidx.long()).items():
        assert torch.equal(sub[k], v)


@pytest.mark.parametrize("n", [1, 2, 7, 64, 1000])
def test_compose_prefix_is_the_sequential_composition(n):
    rng = np.random.default_rng(n)
    maps = rng.integers(0, 6, (6, n))
    exp = np.empty_like(maps)
    acc = np.arange(6)
    for i in range(n):
        acc = maps[acc, i]  # (m_i o ... o m_0)(h)
        exp[:, i] = acc
    got = compose_prefix(torch.from_numpy(maps))
    np.testing.assert_array_equal(got.numpy(), exp)


@pytest.mark.parametrize("bucket", [True, False])
@pytest.mark.parametrize("name", ["420", "restart", "mixed", "gray"])
def test_sequential_chunk_bits_and_unstuffed_plan_match(name, bucket):
    blobs = corpus(name)
    images = [parse_jpeg(b) for b in blobs]
    unstuffed = [unstuff_scan(img.scan_data) for img in images]
    r_unstuffed = [r_unstuff(r_parse(b).scan_data) for b in blobs]
    bits = api.sequential_chunk_bits(unstuffed, bucket=bucket)
    assert bits == RA._sequential_chunk_bits(r_unstuffed, bucket=bucket)
    shared = TB.build_batch_plan(blobs, chunk_bits=bits, parsed=images,
                                 unstuffed=unstuffed).device_arrays()
    own = TB.build_batch_plan(blobs, chunk_bits=bits).device_arrays()
    assert shared.keys() == own.keys()
    for k in own:
        np.testing.assert_array_equal(shared[k], own[k], err_msg=k)


def test_sequential_is_one_chunk_per_segment():
    dec = api.ParallelDecoder.from_bytes(corpus("restart"), sync="sequential",
                                         device="cpu")
    assert dec.plan.n_chunks == dec.plan.n_segments
    out = dec.decode(emit="coeffs")
    assert (out.sync_rounds, out.converged) == (1, True)


def test_host_checks_are_counted():
    api.clear_decode_programs()
    host_check.count = 0
    out = api.decode_batch(corpus("420"), chunk_bits=128, sync="jacobi",
                           device="cpu", emit="coeffs")
    # a cold decode: one check per block of BLOCK_ROUNDS Jacobi rounds
    # after the cold pass
    assert host_check.count == -(-(out.sync_rounds - 1) // BLOCK_ROUNDS)
