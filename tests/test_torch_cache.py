"""The program cache and the sync loop in blocks, on the CPU.

A stream of same-bucket batches makes one program and one allocation per
key and decodes each batch's own bytes; decoders of one key never read
each other's data; padded == exact == oracle on every schedule; and
every schedule run in blocks of rounds (first block from the previous
decode's count) gives ``repro.core.sync``'s exits, ``rounds`` and
``converged``, also when its bound stops it short of the fixed point,
with at most 4 host checks on a warm jacobi decode.
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitstream as RB
from repro.core import sync as RS
from repro.kernels.fused.ops import fuse_traffic as repro_fuse_traffic
from repro.jpeg import codec_ref as cr
from repro_torch.core import api
from repro_torch.core import bitstream as TB
from repro_torch.core import decode as D
from repro_torch.core.bitstream import dev_from_numpy
from repro_torch.core.sync import (BLOCK_ROUNDS, RoundBlocks, faithful_sync,
                                   host_check, jacobi_sync, specmap_sync)
from repro_torch.kernels.fused.ops import fuse_traffic
from repro_torch.kernels.huffman import ops as HK

from _torch_corpus import corpus, oracle_coeffs, synth_image

SYNCS = ("jacobi", "faithful", "specmap", "sequential")


def same_bucket_stream(n=10, chunk_bits=128, quality=75):
    """``n`` distinct single-image blobs whose plans land in one bucket
    (the counterpart of ``tests/test_plan_buckets.py``'s)."""
    groups = {}
    for seed in range(6 * n):
        blob = cr.encode_baseline(synth_image(16, 16, seed=seed),
                                  quality=quality).jpeg_bytes
        shape = TB.plan_shape(TB.build_batch_plan([blob],
                                                  chunk_bits=chunk_bits))
        groups.setdefault(shape, []).append(blob)
        if len(groups[shape]) >= n:
            return groups[shape]
    raise AssertionError("could not assemble a same-bucket stream")


@pytest.fixture(scope="module")
def stream():
    return same_bucket_stream()


def test_one_program_and_allocation_per_key(stream):
    """10 same-bucket batches on jacobi (5 on faithful): one program per
    schedule, allocated once, uploading each batch and decoding its own
    bytes."""
    api.clear_decode_programs()
    for sync, n in (("jacobi", 10), ("faithful", 5)):
        for blob in stream[:n]:
            dec = api.ParallelDecoder.from_bytes([blob], chunk_bits=128,
                                                 sync=sync, device="cpu")
            out = dec.coefficients()
            assert out.converged
            np.testing.assert_array_equal(out.coeffs.numpy(),
                                          oracle_coeffs([blob]))
    stats = api.decode_program_stats()
    assert stats["programs"] == 2 and stats["allocations"] == 2
    for row in stats["buckets"]:
        n = 10 if row["sync"] == "jacobi" else 5
        assert (row["allocations"], row["decodes"], row["uploads"]) == \
            (1, n, n)
        assert row["device_bytes"] > 0
    assert stats["device_bytes"] == sum(p.nbytes()
                                        for p in api.decode_programs())
    api.clear_decode_programs()
    assert api.decode_program_stats()["programs"] == 0


def test_decoders_of_one_key_never_see_each_others_data(stream):
    """Interleaved decoders of one key each decode their own batch; a
    repeated decode uploads nothing; what a decode returned keeps its
    values after the next decode of the key."""
    api.clear_decode_programs()
    a, b = (api.ParallelDecoder.from_bytes([blob], chunk_bits=128,
                                           device="cpu")
            for blob in stream[:2])
    assert a.program is b.program
    exp = [oracle_coeffs([blob]) for blob in stream[:2]]
    out_a = a.decode()
    rgb_a = out_a.rgb.clone()
    for dec, e in ((b, exp[1]), (a, exp[0]), (b, exp[1])):
        np.testing.assert_array_equal(dec.coefficients().coeffs.numpy(), e)
    uploads = a.program.uploads
    np.testing.assert_array_equal(b.coefficients().coeffs.numpy(), exp[1])
    assert a.program.uploads == uploads  # the buffers held b's data
    np.testing.assert_array_equal(out_a.coeffs.numpy(), exp[0])
    assert torch.equal(out_a.rgb, rgb_a)
    # the program's buffers are not what the decode returned
    held = {t.data_ptr() for t in a.program.tensors()}
    assert out_a.coeffs.data_ptr() not in held
    assert out_a.rgb.data_ptr() not in held


def test_concurrent_decodes_share_one_program(stream):
    """Threads decoding distinct batches of one bucket at once: one
    program, one allocation, each thread's own coefficients."""
    api.clear_decode_programs()
    n = 6
    barrier = threading.Barrier(n)
    errs, outs = [], [None] * n

    def run(i):
        try:
            dec = api.ParallelDecoder.from_bytes([stream[i]], chunk_bits=128,
                                                 device="cpu")
            barrier.wait(timeout=60)
            for _ in range(2):
                outs[i] = dec.coefficients().coeffs.numpy()
        except Exception as e:  # surfaced through errs
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    for i in range(n):
        np.testing.assert_array_equal(outs[i], oracle_coeffs([stream[i]]))
    stats = api.decode_program_stats()
    assert (stats["programs"], stats["allocations"]) == (1, 1)


@pytest.mark.parametrize("sync", SYNCS)
def test_padded_equals_exact_equals_oracle(sync):
    """A restart batch, so segments, sequences and units all pad: the
    padded decode, the exact-fit one and the oracle agree, rounds
    included."""
    blobs = [cr.encode_baseline(synth_image(32, 48, seed=s, noise=15.0),
                                quality=92, restart_interval=2).jpeg_bytes
             for s in (3, 4)]
    kw = dict(chunk_bits=128, seq_chunks=4, sync=sync)
    pad = api.ParallelDecoder.from_bytes(blobs, bucket=True, device="cpu",
                                         **kw)
    exact = api.ParallelDecoder.from_bytes(blobs, bucket=False, device="cpu",
                                           **kw)
    assert pad.shape != exact.shape
    a, b = pad.coefficients(), exact.coefficients()
    assert a.converged and b.converged
    np.testing.assert_array_equal(a.coeffs.numpy(), b.coeffs.numpy())
    np.testing.assert_array_equal(a.coeffs.numpy(), oracle_coeffs(blobs))
    assert a.sync_rounds == b.sync_rounds


def _shared_plan(blobs, chunk_bits=128):
    shape, data = RB.split_plan(RB.build_batch_plan(blobs,
                                                    chunk_bits=chunk_bits))
    arrays = dict(data.arrays, words=data.words)
    return shape, {k: jnp.asarray(v) for k, v in arrays.items()}, \
        dev_from_numpy(arrays, "cpu")


def _plain_exits(tdev, sh):
    meta = D.chunk_meta(tdev)

    def decode_exits(d, entry, idx=None, out=None):
        return HK.decode_exits_plain(d, meta, entry, idx, out=out,
                                     s_max=sh.s_max,
                                     min_code_bits=sh.min_code_bits)
    return decode_exits


def _same(got, exp):
    for f, g, e in zip("puzn", got.exits, exp.exits):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e), err_msg=f)
    assert got.rounds == int(exp.rounds)
    assert got.converged is bool(exp.converged)


# (bounds as core/api.py gives them, or cut short; repro's and the port's
# schedule)
def _cases(sh):
    kw = dict(s_max=sh.s_max, min_code_bits=sh.min_code_bits,
              permuted=False)
    full = {
        "jacobi": (dict(max_rounds=sh.n_chunks + 2), RS.jacobi_sync,
                   jacobi_sync),
        "specmap": (dict(max_upm=RB.MAX_UPM,
                         max_verify=sh.n_chunks + RB.MAX_UPM + 2),
                    RS.specmap_sync, specmap_sync),
        "faithful": (dict(seq_chunks=sh.seq_chunks,
                          max_outer=sh.n_sequences + 2),
                     RS.faithful_sync, faithful_sync),
        # the bounds too small to converge
        "jacobi-cut": (dict(max_rounds=3), RS.jacobi_sync, jacobi_sync),
        "faithful-cut": (dict(seq_chunks=3, max_outer=1, verify=False),
                         RS.faithful_sync, faithful_sync),
    }
    return kw, full


@pytest.mark.parametrize("case", ["jacobi-cut", "faithful-cut"])
def test_blocks_cut_short_match_repro(case):
    """Bounds too small to converge: blocks of 1 round (a check a round,
    the form before blocks), then of ``BLOCK_ROUNDS`` with the first
    run's counts as hints, give ``repro``'s exits, rounds and
    ``converged=False``. (Every schedule to convergence is held against
    ``repro`` in ``tests/test_torch_sync.py``, and specmap stopped before
    any verification round in
    ``tests/test_torch_sync_fullhd_specmap.py``.)"""
    sh, jdev, tdev = _shared_plan(corpus("420"))
    kw, cases = _cases(sh)
    bounds, ref, port = cases[case]
    exp = ref(jdev, **bounds, **kw)
    assert not bool(exp.converged)
    fn = _plain_exits(tdev, sh)
    hints = {}
    for block in (1, BLOCK_ROUNDS):
        got = port(tdev, decode_exits=fn, permuted=False,
                   blocks=RoundBlocks(size=block, hints=hints), **bounds)
        _same(got, exp)


@pytest.mark.parametrize("case", ["jacobi", "specmap", "faithful"])
def test_blocks_equal_the_per_round_form(case):
    """Every schedule to convergence: blocks of ``BLOCK_ROUNDS``, cold and
    then with the cold run's counts as hints, give the per-round form's
    exits, rounds and converged; the hinted jacobi run makes one check."""
    sh, _, tdev = _shared_plan(corpus("420"))
    _, cases = _cases(sh)
    bounds, _, port = cases[case]
    fn = _plain_exits(tdev, sh)
    per_round = port(tdev, decode_exits=fn, permuted=False,
                     blocks=RoundBlocks(size=1), **bounds)
    assert per_round.converged
    hints = {}
    for _ in range(2):
        blocks = RoundBlocks(hints=hints)
        got = port(tdev, decode_exits=fn, permuted=False, blocks=blocks,
                   **bounds)
        for a, b in zip(got.exits, per_round.exits):
            assert torch.equal(a, b)
        assert (got.rounds, got.converged) == (per_round.rounds, True)
    if case == "jacobi":
        assert hints["jacobi"] == per_round.rounds - 1
        assert blocks.checks == 1


@pytest.mark.parametrize("sync", ["jacobi", "faithful", "specmap"])
def test_warm_decode_host_checks(sync):
    """A decoder's second decode starts each loop with the first's count:
    one host check a loop (jacobi and specmap 1, faithful one for each
    of its loops); the first decode makes one check per block of 4
    rounds."""
    blobs = corpus("420")
    api.clear_decode_programs()
    dec = api.ParallelDecoder.from_bytes(blobs, chunk_bits=128, sync=sync,
                                         device="cpu")
    host_check.count = 0
    cold = dec.coefficients()
    cold_checks = dec.launch_stats()["host_checks"]
    assert host_check.count == cold_checks
    warm = dec.coefficients()
    checks = dec.launch_stats()["host_checks"]
    assert checks <= cold_checks
    assert (warm.sync_rounds, warm.converged) == (cold.sync_rounds, True)
    if sync == "jacobi":
        assert checks == 1
        assert cold_checks == -(-(cold.sync_rounds - 1) // BLOCK_ROUNDS)
    if sync == "specmap":
        assert checks == 1
    if sync == "faithful":  # one a loop: intra, each outer round, verify
        assert checks == 2 + dec.program.hints["outer"]


def test_launch_stats_and_fuse_traffic():
    blobs = corpus("420")
    dec = api.ParallelDecoder.from_bytes(blobs, chunk_bits=256, device="cpu")
    dec.decode()
    st = dec.launch_stats()
    # the plain backend launches no kernel
    assert st["launches"] and not any(st["launches"].values())
    assert (st["fuse"], st["store_fused"], st["pixels_fused"]) == \
        ("none", False, False)
    rshape = RB.plan_shape(RB.build_batch_plan(blobs, chunk_bits=256))
    for store, pixels in ((False, False), (True, True), (False, True)):
        got = fuse_traffic(dec.shape, store_fused=store,
                           pixels_fused=pixels)
        assert got == repro_fuse_traffic(rshape, store_fused=store,
                                         pixels_fused=pixels)
