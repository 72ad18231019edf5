"""Lane balance (``repro_torch.dist.plan``) against the JAX package's.

The balanced plans, ``lane_loads`` and ``plan_lane_loads`` equal
``repro.dist.plan``'s for every policy and lane count, and a balanced
decode on every schedule is bit-identical to the identity plan's and to
``repro``'s ``backend="jnp"`` decode of the same balanced plan.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import ParallelDecoder as RParallelDecoder
from repro.core import bitstream as RB
from repro.dist import plan as RDP
from repro.jpeg import codec_ref as cr
from repro_torch.core import api
from repro_torch.core.api import ParallelDecoder
from repro_torch.core.bitstream import build_batch_plan
from repro_torch.dist import plan as DP

from _torch_corpus import synth_image

N_LANES = 8


def _skewed_batch():
    """One multi-restart image (many segments/sequences) + small tails."""
    big = cr.encode_baseline(synth_image(48, 64, seed=1, noise=20.0),
                             quality=92, restart_interval=2)
    smalls = [cr.encode_baseline(synth_image(16, 16, seed=5 + i), quality=60)
              for i in range(3)]
    return [r.jpeg_bytes for r in [big] + smalls]


def _uniform_batch():
    return [cr.encode_baseline(synth_image(48, 64, seed=s), quality=90,
                               restart_interval=r).jpeg_bytes
            for s, r in ((2, 2), (3, 0), (4, 3))]


def _fields_equal(a, b):
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        elif isinstance(y, list):
            assert len(x) == len(y) and all(
                np.array_equal(u, v) for u, v in zip(x, y)), f.name
        elif f.name == "geometry" and y is not None:
            assert dataclasses.asdict(x) == dataclasses.asdict(y)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("n_lanes", [1, 2, 3, 8])
@pytest.mark.parametrize("policy", ["none", "roundrobin", "lpt"])
def test_balanced_plan_and_loads_equal_repro(policy, n_lanes):
    blobs = _skewed_batch()
    plan = build_batch_plan(blobs, chunk_bits=128, seq_chunks=4)
    ref = RB.build_batch_plan(blobs, chunk_bits=128, seq_chunks=4)
    bal, rbal = (DP.balance_lanes(plan, n_lanes, policy),
                 RDP.balance_lanes(ref, n_lanes, policy))
    _fields_equal(bal, rbal)
    assert np.array_equal(DP.lane_loads(plan, n_lanes, policy),
                          RDP.lane_loads(ref, n_lanes, policy))
    if bal.n_chunks % n_lanes == 0:
        assert np.array_equal(DP.plan_lane_loads(bal, n_lanes),
                              RDP.plan_lane_loads(rbal, n_lanes))
    # the padded shapes carry the lane layout alike
    assert dataclasses.asdict(api.plan_shape(bal)) == dataclasses.asdict(
        RB.plan_shape(rbal))


class TestBalancedPlanInvariants:
    def _plans(self, policy="lpt"):
        plan = build_batch_plan(_skewed_batch(), chunk_bits=128,
                                seq_chunks=4)
        return plan, DP.balance_lanes(plan, N_LANES, policy)

    def test_permutation_is_a_bijection_with_inert_padding(self):
        plan, bal = self._plans()
        c_real, c_pad = plan.n_chunks, bal.n_chunks
        assert bal.n_real_chunks == c_real and c_pad % N_LANES == 0
        assert np.array_equal(bal.chunk_order[bal.lane_perm],
                              np.arange(c_pad))
        real = bal.lane_perm[bal.lane_perm < c_real]
        assert sorted(real.tolist()) == list(range(c_real))
        inert = bal.lane_perm >= c_real
        lanes = np.arange(c_pad)
        assert np.all(bal.chunk_limit[inert] == bal.chunk_start[inert])
        assert np.all(bal.chunk_first[inert])
        assert np.all(bal.chunk_seq[inert] == -1)
        assert np.all(bal.chunk_prev[inert] == lanes[inert])
        assert np.all(bal.chunk_next[inert] == lanes[inert])
        assert np.array_equal(bal.lane_perm[bal.seq_last_chunk],
                              plan.seq_last_chunk)

    def test_sequences_stay_whole_per_lane_block(self):
        _, bal = self._plans()
        block = bal.n_chunks // N_LANES
        block_of_seq = {}
        for lane in range(bal.n_chunks):
            q = int(bal.chunk_seq[lane])
            if q >= 0:
                assert block_of_seq.setdefault(q, lane // block) == \
                    lane // block, f"sequence {q} straddles lane blocks"

    def test_lpt_loads_balanced_within_one_sequence(self):
        plan, bal = self._plans("lpt")
        loads = DP.plan_lane_loads(bal, N_LANES)
        assert loads.sum() == plan.n_chunks
        assert loads.max() - loads.min() <= plan.seq_chunks
        none = DP.lane_loads(plan, N_LANES, "none")
        assert loads.max() - loads.min() <= none.max() - none.min()

    def test_policy_validation_and_identity(self):
        plan, bal = self._plans()
        with pytest.raises(ValueError, match="unknown lane balance"):
            DP.balance_lanes(plan, N_LANES, "greedy")
        with pytest.raises(ValueError, match="already lane-balanced"):
            DP.balance_lanes(bal, N_LANES, "lpt")
        with pytest.raises(ValueError, match="not divisible"):
            DP.plan_lane_loads(bal, bal.n_chunks + 1)
        assert DP.balance_lanes(plan, N_LANES, "none") is plan
        assert DP.balance_lanes(plan, 1, "lpt") is plan
        with pytest.raises(ValueError, match="unknown lane balance"):
            ParallelDecoder.from_bytes(_skewed_batch(), balance="greedy",
                                       device="cpu")

    def test_default_lanes_on_the_cpu_is_one_block(self):
        """Without ``lanes=``, a CPU decoder balances over 1 block: the
        identity plan."""
        dec = ParallelDecoder.from_bytes(_skewed_batch(), chunk_bits=128,
                                         balance="lpt", device="cpu")
        assert DP.default_lanes("cpu") == 1
        assert dec.plan.balance == "none" and dec.shape.n_lanes == 1


_REPRO = {}


def _repro_coeffs(blobs, sync, balance):
    """``repro``'s jnp decode of the balanced plan (one per case)."""
    key = (sync, balance)
    if key not in _REPRO:
        dec = RParallelDecoder.from_bytes(
            blobs, chunk_bits=128, seq_chunks=4, sync=sync, backend="jnp",
            balance=balance, lanes=N_LANES)
        out = dec.coefficients()
        assert bool(out.converged)
        _REPRO[key] = (np.asarray(out.coeffs), int(out.sync_rounds))
    return _REPRO[key]


@pytest.mark.parametrize("balance", ["roundrobin", "lpt"])
@pytest.mark.parametrize("sync",
                         ["jacobi", "faithful", "specmap", "sequential"])
def test_balanced_decode_bit_identical(sync, balance):
    blobs = _skewed_batch()
    kw = dict(chunk_bits=128, seq_chunks=4, sync=sync, device="cpu")
    dec = ParallelDecoder.from_bytes(blobs, balance=balance, lanes=N_LANES,
                                     **kw)
    assert dec.plan.balance == balance and dec.shape.permuted
    assert dec.shape.n_lanes == N_LANES
    out = dec.decode(emit="coeffs")
    ident = ParallelDecoder.from_bytes(blobs, **kw).decode(emit="coeffs")
    assert out.converged and torch.equal(out.coeffs, ident.coeffs)
    ref, rounds = _repro_coeffs(blobs, sync, balance)
    assert np.array_equal(out.coeffs.numpy(), ref)
    assert out.sync_rounds == rounds


@pytest.mark.parametrize("sync", ["jacobi", "faithful"])
def test_balanced_rgb_equals_identity(sync):
    """A uniform batch through the pixel stage: the balanced plan's
    program (a shape of its own) gives the identity plan's RGB."""
    blobs = _uniform_batch()
    kw = dict(chunk_bits=128, seq_chunks=4, sync=sync, device="cpu")
    api.clear_decode_programs()
    bal = api.decode_batch(blobs, balance="lpt", lanes=4, **kw)
    ident = api.decode_batch(blobs, **kw)
    assert torch.equal(bal.coeffs, ident.coeffs)
    assert torch.equal(bal.rgb, ident.rgb)
    assert api.decode_program_stats()["programs"] == 2


@pytest.mark.parametrize("policy", ["none", "lpt"])
def test_split_plan_pads_blocks_as_repro(policy):
    """``split_plan``'s shape and padded arrays (each lane block padded on
    its own) equal the JAX package's."""
    blobs = _skewed_batch()
    plan = DP.balance_lanes(build_batch_plan(blobs, chunk_bits=128,
                                             seq_chunks=4), 3, policy)
    ref = RDP.balance_lanes(RB.build_batch_plan(blobs, chunk_bits=128,
                                                seq_chunks=4), 3, policy)
    from repro_torch.core.bitstream import split_plan
    shape, data = split_plan(plan)
    rshape, rdata = RB.split_plan(ref)
    assert dataclasses.asdict(shape) == dataclasses.asdict(rshape)
    assert np.array_equal(data.words, rdata.words)
    assert set(data.arrays) == set(rdata.arrays)
    for k, v in rdata.arrays.items():
        assert np.array_equal(data.arrays[k], np.asarray(v)), k
