"""The port's multi-process decode against the JAX package's multi-host one.

Bucket consensus (``merge_plan_shapes``, the wire string), per-process
feeding, ``init_distributed``'s fail-fast checks, the empty-process plan,
and real 2- and 4-process decodes on the CPU over a ``TCPStore``, each
with a hard timeout: every process's coefficients equal its slice of a
single-process decode and of ``repro``'s.
"""
import dataclasses
import hashlib

import numpy as np
import pytest
import torch

try:  # real hypothesis when installed; offline deterministic shim otherwise
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # pragma: no cover
    from _hypothesis_compat import given, settings
    from _hypothesis_compat import strategies as st

from repro import core as RC
from repro.core import bitstream as RB
from repro.jpeg import codec_ref as cr
from repro.launch import multihost as RM
from repro_torch.core.api import ParallelDecoder, decode_batch
from repro_torch.core.bitstream import (build_batch_plan, build_plan_data,
                                        bucket_capacity, consensus_plan,
                                        empty_batch_plan, merge_plan_shapes,
                                        plan_shape)
from repro_torch.dist.plan import balance_lanes
from repro_torch.launch import multihost as M
from repro_torch.launch.multihost import (DistContext, HostFeed,
                                          init_distributed, shape_from_wire,
                                          shape_to_wire)

from _torch_corpus import oracle_coeffs, synth_image
from _torch_multiproc import collect, run_processes, spawn

CAPACITY_FIELDS = ("n_words", "n_luts", "n_tablesets", "n_matrices",
                   "n_segments", "n_chunks", "n_sequences", "n_units")
ENV_VARS = ("REPRO_COORDINATOR", "REPRO_NUM_PROCESSES", "REPRO_PROCESS_ID",
            "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def small_corpus(n=4, size=(32, 32), quality=80, seed0=0):
    return [cr.encode_baseline(synth_image(*size, seed=seed0 + s),
                               quality=quality).jpeg_bytes
            for s in range(n)]


def _shapes(pkg_build, pkg_shape, blobs, cuts):
    parts = [blobs[lo:hi] for lo, hi in zip(cuts, cuts[1:])]
    return [pkg_shape(pkg_build(p, chunk_bits=256)) for p in parts]


# ---------------------------------------------------------------------------
# Merge algebra and the wire string, against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cuts", [(0, 1, 4), (0, 2, 4), (0, 1, 2, 4)])
def test_merged_shape_and_wire_equal_repro(cuts):
    blobs = small_corpus(4)
    mine = _shapes(build_batch_plan, plan_shape, blobs, cuts)
    ref = _shapes(RB.build_batch_plan, RB.plan_shape, blobs, cuts)
    for a, b in zip(mine, ref):
        assert shape_to_wire(a) == RM.shape_to_wire(b)
    merged, ref_merged = merge_plan_shapes(mine), RB.merge_plan_shapes(ref)
    wire = shape_to_wire(merged)
    assert wire == RM.shape_to_wire(ref_merged)  # byte-identical
    assert shape_from_wire(wire) == merged
    assert shape_from_wire(RM.shape_to_wire(ref_merged)) == merged


def test_wire_string_of_balanced_and_empty_shapes_equals_repro():
    blobs = small_corpus(3)
    plan = balance_lanes(build_batch_plan(blobs, chunk_bits=128,
                                          seq_chunks=2), 3, "lpt")
    from repro.dist.plan import balance_lanes as r_balance
    ref = r_balance(RB.build_batch_plan(blobs, chunk_bits=128,
                                        seq_chunks=2), 3, "lpt")
    for a, b in ((plan_shape(plan), RB.plan_shape(ref)),
                 (plan_shape(empty_batch_plan(chunk_bits=256)),
                  RB.plan_shape(RB.empty_batch_plan(chunk_bits=256)))):
        assert shape_to_wire(a) == RM.shape_to_wire(b)
        assert shape_from_wire(shape_to_wire(a)) == a
    with pytest.raises(ValueError, match="wire version"):
        shape_from_wire('{"_v": 999}')


class TestMergePlanShapes:
    def _shapes(self):
        return _shapes(build_batch_plan, plan_shape, small_corpus(4),
                       (0, 1, 4))

    def test_elementwise_max_and_rung_fixpoint(self):
        a, b = self._shapes()
        m = merge_plan_shapes([a, b])
        for f in CAPACITY_FIELDS:
            assert getattr(m, f) == max(getattr(a, f), getattr(b, f))
            assert bucket_capacity(getattr(m, f)) == getattr(m, f)
        assert m.s_max == max(a.s_max, b.s_max)
        assert m.min_code_bits == min(a.min_code_bits, b.min_code_bits)

    def test_commutative_associative_idempotent(self):
        a, b = self._shapes()
        e = plan_shape(empty_batch_plan(chunk_bits=256))
        m = merge_plan_shapes([a, b, e])
        assert merge_plan_shapes([b, e, a]) == m
        assert merge_plan_shapes([merge_plan_shapes([a, b]), e]) == m
        assert merge_plan_shapes([m]) == m
        assert merge_plan_shapes([m, a]) == m

    def test_framing_mismatch_raises(self):
        a, _ = self._shapes()
        other = plan_shape(build_batch_plan(small_corpus(1), chunk_bits=512))
        with pytest.raises(ValueError, match="chunk_bits"):
            merge_plan_shapes([a, other])
        with pytest.raises(ValueError, match="at least one"):
            merge_plan_shapes([])

    def test_uniform_collapses_on_mixed_counts(self):
        a, b = self._shapes()  # 1 image vs 3 images, same geometry
        assert a.uniform and b.uniform
        m = merge_plan_shapes([a, b])
        assert not m.uniform and m.geometry is None
        halves = _shapes(build_batch_plan, plan_shape, small_corpus(4),
                         (0, 2, 4))
        m2 = merge_plan_shapes(halves)
        assert m2.uniform and m2.geometry == halves[0].geometry


_POOL = None


def _pool():
    """Pre-encoded images of varied size and quality (varied geometry,
    words, Huffman tables), shared across examples."""
    global _POOL
    if _POOL is None:
        specs = [((16, 16), 70), ((16, 16), 90), ((32, 32), 80),
                 ((32, 32), 95), ((24, 40), 75), ((8, 8), 85)]
        _POOL = [cr.encode_baseline(synth_image(*wh, seed=i), quality=q
                                    ).jpeg_bytes
                 for i, (wh, q) in enumerate(specs)]
    return _POOL


def _random_split(n_images, n_hosts, seed):
    rng = np.random.default_rng(seed)
    pool = _pool()
    corpus = [pool[int(rng.integers(len(pool)))] for _ in range(n_images)]
    cuts = sorted(int(rng.integers(0, n_images + 1))
                  for _ in range(n_hosts - 1))
    bounds = [0] + cuts + [n_images]
    return corpus, [corpus[lo:hi] for lo, hi in zip(bounds, bounds[1:])]


@settings(max_examples=12, deadline=None)
@given(n_images=st.integers(1, 6), n_hosts=st.integers(1, 4),
       seed=st.integers(0, 10_000))
def test_processwise_merge_covers_and_equals_repro(n_images, n_hosts, seed):
    """For any split of any corpus: the merge of the per-process shapes
    keeps every capacity on the ladder, equals the fieldwise max, never
    exceeds the single-process shape, reproduces its Huffman constants when
    no process is empty, covers every process's aligned plan — and its
    wire string is the JAX package's, byte for byte."""
    corpus, parts = _random_split(n_images, n_hosts, seed)
    plans = [build_batch_plan(p, chunk_bits=256) if p
             else empty_batch_plan(chunk_bits=256) for p in parts]
    shapes = [plan_shape(p) for p in plans]
    merged = merge_plan_shapes(shapes)
    single = plan_shape(build_batch_plan(corpus, chunk_bits=256))
    for f in CAPACITY_FIELDS:
        m = getattr(merged, f)
        assert m == max(getattr(s, f) for s in shapes)
        assert bucket_capacity(m) == m, f
        assert m <= getattr(single, f), f
    if all(parts):
        assert merged.s_max == single.s_max
        assert merged.min_code_bits == single.min_code_bits
    for p in plans:
        build_plan_data(consensus_plan(p, merged), merged)
    ref = RB.merge_plan_shapes([
        RB.plan_shape(RB.build_batch_plan(p, chunk_bits=256) if p
                      else RB.empty_batch_plan(chunk_bits=256))
        for p in parts])
    assert shape_to_wire(merged) == RM.shape_to_wire(ref)


@settings(max_examples=2, deadline=None)
@given(n_hosts=st.integers(2, 4), seed=st.integers(0, 10_000))
def test_split_decode_matches_single_process(n_hosts, seed):
    """Per-process decodes under the consensus, concatenated in process
    order, equal the single-process decode (and the oracle)."""
    rng = np.random.default_rng(seed)
    pool = _pool()
    corpus = [pool[int(rng.integers(len(pool)))] for _ in range(4)]
    bounds = HostFeed.bounds(len(corpus), n_hosts)
    parts = [corpus[lo:hi] for lo, hi in zip(bounds, bounds[1:])]
    plans = [build_batch_plan(p, chunk_bits=256) if p
             else empty_batch_plan(chunk_bits=256) for p in parts]
    merged = merge_plan_shapes([plan_shape(p) for p in plans])
    got = torch.cat([
        ParallelDecoder(consensus_plan(p, merged), shape=merged,
                        device="cpu").coefficients().coeffs
        for p in plans])
    single = decode_batch(corpus, chunk_bits=256, emit="coeffs",
                          device="cpu").coeffs
    assert torch.equal(got, single)
    assert np.array_equal(got.numpy(), oracle_coeffs(corpus))


# ---------------------------------------------------------------------------
# Zero-JPEG processes
# ---------------------------------------------------------------------------

def test_empty_plan_equals_repro():
    mine, ref = empty_batch_plan(chunk_bits=256), RB.empty_batch_plan(
        chunk_bits=256)
    for f in dataclasses.fields(ref):
        a, b = getattr(mine, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("sync",
                         ["jacobi", "faithful", "specmap", "sequential"])
def test_empty_plan_decodes_to_nothing(sync):
    out = ParallelDecoder(empty_batch_plan(chunk_bits=256), sync=sync,
                          device="cpu").coefficients()
    assert tuple(out.coeffs.shape) == (0, 64) and out.converged


def test_empty_process_in_consensus():
    blobs = small_corpus(2)
    real = build_batch_plan(blobs, chunk_bits=256)
    empty = empty_batch_plan(chunk_bits=256)
    merged = merge_plan_shapes([plan_shape(real), plan_shape(empty)])
    out = ParallelDecoder(consensus_plan(empty, merged), shape=merged,
                          device="cpu").coefficients()
    assert tuple(out.coeffs.shape) == (0, 64) and out.converged
    got = ParallelDecoder(consensus_plan(real, merged), shape=merged,
                          device="cpu").coefficients()
    assert np.array_equal(got.coeffs.numpy(), oracle_coeffs(blobs))


# ---------------------------------------------------------------------------
# Per-process feeding and placement
# ---------------------------------------------------------------------------

class TestHostFeed:
    def test_bounds_equal_repro(self):
        for n_items, n_proc in [(0, 3), (2, 4), (7, 3), (8, 2), (5, 1)]:
            b = HostFeed.bounds(n_items, n_proc)
            assert b == RM.HostFeed.bounds(n_items, n_proc)
            sizes = [hi - lo for lo, hi in zip(b, b[1:])]
            assert b[0] == 0 and b[-1] == n_items
            assert min(sizes) >= 0 and max(sizes) - min(sizes) <= 1
        with pytest.raises(ValueError, match="positive"):
            HostFeed.bounds(3, 0)

    def test_from_corpus_slices_and_short_corpus(self):
        corpus = [bytes([i]) for i in range(7)]
        got = []
        for pid in range(3):
            got.extend(HostFeed.from_corpus(
                corpus, DistContext(pid, 3, None, False)).local_blobs)
        assert got == corpus
        sizes = [len(HostFeed.from_corpus([b"a", b"b"],
                                          DistContext(p, 4, None, False)))
                 for p in range(4)]
        assert sizes == [1, 1, 0, 0]

    def test_batches(self):
        feed = HostFeed([bytes([i]) for i in range(5)], M.SINGLE_PROCESS)
        assert [len(g) for g in feed.batches(2)] == [2, 2, 1]
        with pytest.raises(ValueError):
            feed.batches(0)


def test_global_placement_from_unit_counts():
    coeffs = torch.zeros((5, 64), dtype=torch.int32)
    g = M.assemble_global_coeffs(coeffs, [3, 5, 0], DistContext(1, 3, None,
                                                                 False))
    assert (g.offset, g.n_units) == (3, 8) and g.coeffs is coeffs
    with pytest.raises(ValueError, match="reported"):
        M.assemble_global_coeffs(coeffs, [3, 4, 0],
                                 DistContext(1, 3, None, False))


def test_single_process_decode_and_stats():
    """One process, no store: decode_multihost is the plain decode, and
    the exchanges and stats gathering pass strings through."""
    blobs = small_corpus(2)
    out = M.decode_multihost(blobs, chunk_bits=256, device="cpu")
    assert out.num_processes == 1 and out.unit_counts == [
        int(out.local.coeffs.shape[0])]
    assert out.global_coeffs.offset == 0 and out.compiles == 1
    assert np.array_equal(out.local.coeffs.numpy(), oracle_coeffs(blobs))
    assert M.gather_decode_stats({"a": 1}) == [{"a": 1}]
    assert M.exchange("x", M.SINGLE_PROCESS) == ["x"]
    M.barrier(M.SINGLE_PROCESS, "b")
    assert M.process_info() == M.SINGLE_PROCESS


# ---------------------------------------------------------------------------
# init_distributed: validation must raise, never hang
# ---------------------------------------------------------------------------

class TestInitDistributedValidation:
    @pytest.fixture(autouse=True)
    def _clean_env(self, monkeypatch):
        for var in ENV_VARS:
            monkeypatch.delenv(var, raising=False)

    def test_nothing_configured_is_single_process(self):
        ctx = init_distributed()
        assert ctx.num_processes == 1 and not ctx.initialized

    def test_one_process_is_noop(self):
        ctx = init_distributed(num_processes=1)
        assert ctx.num_processes == 1 and not ctx.initialized

    @pytest.mark.parametrize("kw,match", [
        (dict(num_processes=2, process_id=0), "coordinator"),
        (dict(coordinator="127.0.0.1:9", num_processes=2), "process_id"),
        (dict(coordinator="127.0.0.1:9", num_processes=2, process_id=2),
         "out of range"),
        (dict(coordinator="127.0.0.1:9", num_processes=0, process_id=0),
         "positive"),
        (dict(coordinator="no-port-here", num_processes=2, process_id=1),
         "host:port"),
        (dict(coordinator="127.0.0.1:9", process_id=1), "num_processes"),
    ])
    def test_inconsistent_arguments_raise(self, kw, match):
        with pytest.raises(ValueError, match=match):
            init_distributed(**kw)

    def test_count_without_rest_raises_from_env(self, monkeypatch):
        monkeypatch.setenv("REPRO_NUM_PROCESSES", "2")
        with pytest.raises(ValueError, match="coordinator"):
            init_distributed()

    def test_torchrun_names_resolve(self, monkeypatch):
        """torchrun's variables stand in for REPRO_*, which come first."""
        monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
        monkeypatch.setenv("MASTER_PORT", "9")
        monkeypatch.setenv("WORLD_SIZE", "2")
        monkeypatch.setenv("RANK", "5")
        with pytest.raises(ValueError, match="out of range for 2"):
            init_distributed()
        monkeypatch.setenv("REPRO_NUM_PROCESSES", "8")
        monkeypatch.setenv("REPRO_PROCESS_ID", "9")
        with pytest.raises(ValueError, match="9 out of range for 8"):
            init_distributed()

    def test_garbage_env_count_raises(self, monkeypatch):
        monkeypatch.setenv("REPRO_NUM_PROCESSES", "two")
        with pytest.raises(ValueError, match="integer"):
            init_distributed()

    def test_unreachable_coordinator_raises_within_timeout(self):
        with pytest.raises(RuntimeError, match="unreachable"):
            init_distributed(coordinator="127.0.0.1:1", num_processes=2,
                             process_id=1, timeout_s=1)
        assert M.process_info() == M.SINGLE_PROCESS

    def test_exchange_without_store_raises(self):
        with pytest.raises(RuntimeError, match="init_distributed"):
            M.exchange("x", DistContext(0, 2, "127.0.0.1:9", True))


# ---------------------------------------------------------------------------
# Real processes over a TCPStore on localhost
# ---------------------------------------------------------------------------

_DECODE = """
import hashlib
import numpy as np
from repro.jpeg import codec_ref as cr
from repro_torch.core import api
from repro_torch.launch.multihost import (HostFeed, barrier,
                                          decode_multihost,
                                          gather_decode_stats)
from _torch_corpus import synth_image

corpus = [cr.encode_baseline(synth_image(32, 32, seed=s), quality=80,
                             restart_interval={restart}).jpeg_bytes
          for s in range({n_img})]
{damage}
feed = HostFeed.from_corpus(corpus, ctx)
rows = []
for step in range(2):  # the same tag each step: fresh keys every use
    out = decode_multihost(feed.local_blobs, ctx, chunk_bits=256,
                           sync={sync!r}, device="cpu", emit={emit!r},
                           validate={validate}, tag="step",
                           timeout_ms=20000)
co = np.ascontiguousarray(out.local.coeffs.numpy())
barrier(ctx, "decoded", timeout_ms=20000)
peers = gather_decode_stats({{"pid": ctx.process_id, "n": len(feed)}}, ctx,
                            timeout_ms=20000)
emit({{
    "peers": peers,
    "pid": ctx.process_id, "n_local": len(feed),
    "digest": hashlib.blake2b(co.tobytes()).hexdigest(),
    "units": out.unit_counts, "offset": out.global_coeffs.offset,
    "global_units": out.global_coeffs.n_units,
    "bucket": out.shape.label(), "compiles": out.compiles,
    "allocations": api.decode_program_stats()["allocations"],
    "converged": bool(out.local.converged),
    "rgb": None if out.local.rgb is None else list(out.local.rgb.shape),
    "status": None if out.status is None else [int(s) for s in out.status],
    "host_statuses": out.host_statuses,
}})
"""


def _digests(exp, units, bounds):
    out = []
    for lo, hi in zip(bounds, bounds[1:]):
        a, b = sum(units[:lo]), sum(units[:hi])
        out.append(hashlib.blake2b(
            np.ascontiguousarray(exp[a:b]).tobytes()).hexdigest())
    return out


@pytest.mark.parametrize("n_proc,n_img,sync,emit", [
    (2, 4, "jacobi", "rgb"), (4, 2, "sequential", "coeffs")])
def test_processes_decode_bit_identical_to_one(n_proc, n_img, sync, emit):
    """2 processes (4 images) and 4 (2 images: two empty processes, and
    the sequential schedule's chunk-size vote): every process's
    coefficients equal its slice of the single-process decode, of
    ``repro``'s (``backend="jnp"``) and of the oracle; one bucket, one
    allocation per process over two decodes."""
    results = run_processes(_DECODE.format(
        n_img=n_img, sync=sync, restart=0, damage="", validate=False,
        emit=emit),
        n_proc, timeout=90)
    corpus = small_corpus(n_img)
    single = decode_batch(corpus, chunk_bits=256, sync=sync, emit="coeffs",
                          device="cpu").coeffs.numpy()
    if sync == "jacobi":
        ref = np.asarray(RC.decode_batch(corpus, chunk_bits=256,
                                         emit="coeffs",
                                         backend="jnp").coeffs)
        assert np.array_equal(single, ref)
    assert np.array_equal(single, oracle_coeffs(corpus))
    units = [cr.parse_jpeg(b).n_units for b in corpus]
    bounds = HostFeed.bounds(n_img, n_proc)
    exp_units = [sum(units[lo:hi]) for lo, hi in zip(bounds, bounds[1:])]
    assert len({r["bucket"] for r in results}) == 1
    for pid, (r, digest) in enumerate(zip(results, _digests(single, units,
                                                            bounds))):
        assert r["pid"] == pid and r["converged"]
        assert r["digest"] == digest, f"process {pid} differs"
        assert r["units"] == exp_units
        assert r["offset"] == sum(exp_units[:pid])
        assert r["global_units"] == sum(units)
        assert r["compiles"] == 1 and r["allocations"] == 1
        assert r["rgb"] == ([n_img // n_proc, 32, 32, 3] if emit == "rgb"
                            else None)
    sizes = [hi - lo for lo, hi in zip(bounds, bounds[1:])]
    assert [r["n_local"] for r in results] == sizes
    # per-process stats come back per process, in process order
    for r in results:
        assert r["peers"] == [{"pid": p, "n": n} for p, n in enumerate(sizes)]


def test_one_process_fed_a_damaged_blob():
    """validate=True: the damaged blob is quarantined where it lives, no
    process is stranded, statuses agree across processes, and the clean
    images' coefficients equal the oracle's."""
    damage = ("bad = bytearray(corpus[3]); bad[5] = 0x00; "
              "corpus[3] = bytes(bad)")
    results = run_processes(_DECODE.format(
        n_img=4, sync="sequential", restart=2, damage=damage,
        validate=True, emit="coeffs"), 2, timeout=90)
    assert [r["status"] for r in results] == [[0, 0], [0, 2]]
    corpus = [cr.encode_baseline(synth_image(32, 32, seed=s), quality=80,
                                 restart_interval=2).jpeg_bytes
              for s in range(4)]
    exp = oracle_coeffs(corpus)
    n = cr.parse_jpeg(corpus[0]).n_units
    exp[3 * n:] = 0  # the rejected image decodes as an inert lane
    digests = _digests(exp, [n] * 4, [0, 2, 4])
    for r, digest in zip(results, digests):
        assert r["converged"] and r["compiles"] == 1
        assert r["host_statuses"] == [[0, 0], [0, 2]]
        assert r["digest"] == digest


def test_mismatched_process_count_fails_fast():
    """A process that believes in a third peer waits for it at the
    exchange; the bounded timeout turns that into a clear error while the
    correctly configured process finishes."""
    procs = spawn("""
import time
from repro_torch.launch.multihost import DistContext, exchange
if ctx.process_id == 0:
    vals = exchange("p0", ctx, tag="mismatch")
    emit({"pid": 0, "seen": len(vals)})
else:
    wrong = DistContext(1, 3, ctx.coordinator, True)
    try:
        exchange("p1", wrong, tag="mismatch", timeout_ms=2000)
    except RuntimeError as e:
        msg = str(e)
        assert "process 2" in msg and "num_processes" in msg, msg
        emit({"pid": 1, "failed_fast": True})
""", 2)
    results = collect(procs, timeout=60)
    for rc, out in results:
        assert rc == 0, out[-3000:]
    assert '"seen": 2' in results[0][1]
    assert '"failed_fast": true' in results[1][1]


def test_miscounted_launch_raises_within_the_timeout():
    """A process launched with another process count never completes the
    store's join: it raises within its timeout, with the topology in the
    message, and never hangs."""
    results = collect(spawn('emit({"joined": True})\n', 2, init_timeout=3,
                            claims=[2, 3]), timeout=60)
    rc, out = results[1]
    assert rc != 0 and "process 1/3" in out and "num_processes" in out
    assert '"joined"' not in out
