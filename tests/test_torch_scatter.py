"""The scatter after the stream kernel (``kernels/huffman/ops.scatter_streams``).

It places the (s_max, C) streams at ``write_base + pos``, drops steps that
recorded nothing (-1) and targets past a lane's ``write_max``, and sends
each dropped write to its lane's own sentinel slot past the end. Held
against a plain loop over crafted streams, in both index types it picks
(int32, and int64 where ``n_coef + C`` would not fit int32), and against
the JAX package's ``decode_span(write=True)`` on real plans.
"""
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

from _torch_corpus import CORPORA, corpus, oracle_coeffs


def scatter_loop(pos, val, base, wmax, n_coef):
    """The placement, one write at a time."""
    out = np.zeros(n_coef, np.int32)
    for i in range(pos.shape[0]):
        for j in range(pos.shape[1]):
            p = int(pos[i, j])
            if p >= 0 and base[j] + p <= wmax[j]:
                out[base[j] + p] = val[i, j]
    return out


def crafted(seed, n_lanes, s_max):
    """Streams as the stream kernel writes them: per lane, strictly
    increasing positions with -1 where a step recorded nothing (mid-row
    and after the lane's end), values 0 where pos is -1; lanes own
    disjoint ranges [base, wmax] whose room may be short of the lane's
    positions (dropped targets) or empty."""
    rng = np.random.default_rng(seed)
    pos = np.full((s_max, n_lanes), -1, np.int32)
    val = np.zeros((s_max, n_lanes), np.int32)
    room = rng.integers(0, 3 * s_max, n_lanes)
    room[rng.random(n_lanes) < 0.05] = 0
    base = np.concatenate([[0], np.cumsum(room)[:-1]]).astype(np.int32)
    wmax = (base + room - 1).astype(np.int32)
    for j in range(n_lanes):
        steps = int(rng.integers(0, s_max + 1))
        p = np.cumsum(rng.integers(1, 6, steps))
        keep = rng.random(steps) < 0.85  # -1 mid-row
        pos[:steps, j] = np.where(keep, p, -1)
        val[:steps, j] = np.where(keep, rng.integers(-300, 300, steps), 0)
    n_coef = int(room.sum()) + 7
    return pos, val, base, wmax, n_coef


@pytest.mark.parametrize("index", ["int32", "int64"])
@pytest.mark.parametrize("seed,n_lanes,s_max", [(0, 1, 9), (1, 33, 17),
                                                (2, 1000, 24)])
def test_scatter_matches_a_plain_loop(monkeypatch, seed, n_lanes, s_max,
                                      index):
    pos, val, base, wmax, n_coef = crafted(seed, n_lanes, s_max)
    assert (pos == -1).any() and ((pos >= 0) & (
        base[None] + pos > wmax[None])).any() or n_lanes == 1
    if index == "int64":  # as if n_coef + C did not fit int32
        monkeypatch.setattr(HK, "INT32_MAX", n_coef + n_lanes - 1)
    got = HK.scatter_streams(*map(torch.from_numpy, (pos, val, base, wmax)),
                             n_coef)
    assert got.dtype == torch.int32 and got.shape == (n_coef,)
    np.testing.assert_array_equal(got.numpy(),
                                  scatter_loop(pos, val, base, wmax, n_coef))


@pytest.mark.parametrize("name", CORPORA)
def test_scatter_gives_decode_span_coefficients(name):
    """The plain streams of the converged entries, placed by the scatter,
    equal ``repro.core.decode.decode_span(write=True)``, and the oracle's
    coefficients after DC undiff."""
    blobs = corpus(name)
    plan = build_batch_plan(blobs, chunk_bits=256)
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
    entry = chain_entries(dev, res.exits, permuted=False)
    bases = D.chunk_write_bases(dev, res.exits.n, permuted=False)
    seg_end = torch.cat([dev["seg_coeff_base"][1:], dev["units_end"][None]])
    wmax = seg_end[dev["chunk_seg"].long()] - 1
    n_coef = shape.n_units * 64
    pos, val = HK.decode_streams_plain(dev, meta, entry, **kw)
    got = HK.scatter_streams(pos, val, bases, wmax, n_coef)
    jentry = RState(*(jnp.asarray(f.numpy()) for f in entry))
    _, exp = RD.decode_span(jdev, jentry, jmeta["word_base"],
                            jmeta["limit"], jmeta["ts"], jmeta["upm"],
                            write=True, out=jnp.zeros(n_coef, jnp.int32),
                            write_base=jnp.asarray(bases.numpy()),
                            write_max=jnp.asarray(wmax.numpy()), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    coeffs = D.undiff_dc(dev, got.reshape(-1, 64))[:plan.total_units]
    np.testing.assert_array_equal(coeffs.numpy(), oracle_coeffs(blobs))
