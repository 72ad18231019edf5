"""The port's decode stages and kernel plain versions against the JAX package.

One plan (the JAX package's, bucketed) feeds both decoders: its arrays go
to JAX as ``jnp`` arrays and to the port through ``dev_from_numpy``. The
integer stages must agree bit for bit with ``repro.core.decode`` and with
the Pallas exit kernel in interpret mode; the pixel stage must be within 1
of the Pallas pixel kernel. The Pallas write kernels do not run with this
JAX version (``pl.store`` is gone), so the write pass is held against
``repro.core.decode.decode_span(write=True)``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitstream as RB
from repro.core import decode as RD
from repro.core import sync as RS
from repro.core.state import DecodeState as RState
from repro.kernels.fused.pixels import fused_pixels_pallas
from repro.kernels.huffman import ops as RHK
from repro_torch.core import decode as D
from repro_torch.core.bitstream import dev_from_numpy, segment_starts
from repro_torch.core.state import DecodeState
from repro_torch.core.sync import chain_entries, jacobi_sync
from repro_torch.kernels.fused import pixels as FP
from repro_torch.kernels.fused import store as FS
from repro_torch.kernels.huffman import ops as HK

from _torch_corpus import CORPORA, RGB_CORPORA, corpus, oracle_coeffs

CHUNK_BITS = 256


class Case:
    """One bucketed plan on both sides, with the JAX reference's sync."""

    def __init__(self, name):
        self.blobs = corpus(name)
        self.plan = RB.build_batch_plan(self.blobs, chunk_bits=CHUNK_BITS)
        self.shape, data = RB.split_plan(self.plan, bucket=True)
        arrays = dict(data.arrays, words=data.words)
        self.jdev = {k: jnp.asarray(v) for k, v in arrays.items()}
        self.tdev = dev_from_numpy(arrays, "cpu")
        self.kw = dict(s_max=self.shape.s_max,
                       min_code_bits=self.shape.min_code_bits)
        self.jmeta = RD.chunk_meta(self.jdev)
        self.tmeta = D.chunk_meta(self.tdev)
        res = RS.jacobi_sync(self.jdev, max_rounds=self.shape.n_chunks + 2,
                             permuted=False, **self.kw)
        assert bool(res.converged)
        self.jexits = res.exits
        self.rounds = int(res.rounds)

    def both(self, st):
        """A JAX state as (jnp state, torch state)."""
        return st, DecodeState(*(torch.from_numpy(np.array(f)) for f in st))

    def entries(self):
        """(label, jnp entry, torch entry) for cold and converged entries."""
        cold = RState.cold(self.jdev["chunk_start"])
        chained = RS.chain_entries(self.jdev, self.jexits, False)
        return [("cold",) + self.both(cold), ("chained",) + self.both(chained)]

    def write_inputs(self):
        """(write_base, write_max) from the converged exits, both sides."""
        bases = RD.chunk_write_bases(self.jdev, self.jexits.n, permuted=False)
        seg_end = jnp.concatenate([self.jdev["seg_coeff_base"][1:],
                                   self.jdev["units_end"][None]])
        wmax = seg_end[self.jdev["chunk_seg"]] - 1
        return (bases, wmax), (torch.from_numpy(np.array(bases)),
                               torch.from_numpy(np.array(wmax)))


_CASES = {}


def case(name):
    if name not in _CASES:
        _CASES[name] = Case(name)
    return _CASES[name]


def _eq(jarr, tarr):
    np.testing.assert_array_equal(np.asarray(jarr), tarr.numpy())


def test_fetch_window32_matches():
    words = np.array([0xDEADBEEF, 0x12345678, 0xFFFFFFFF, 0x80000001],
                     np.uint32)
    base = np.array([0, 0, 0, 1, 2, 3], np.int32)
    p = np.array([0, 4, 33, 63, 17, 40], np.int32)
    exp = RD.fetch_window32(jnp.asarray(words), jnp.asarray(base),
                            jnp.asarray(p))
    tw = dev_from_numpy({"w": words}, "cpu")["w"]
    got = D.fetch_window32(D.widen_words(tw), torch.from_numpy(base),
                           torch.from_numpy(p))
    np.testing.assert_array_equal(np.asarray(exp).astype(np.int64),
                                  got.numpy())


@pytest.mark.parametrize("name", ["420", "restart", "optimized", "mixed"])
def test_exit_decode_matches_pallas_and_decode_span(name):
    c = case(name)
    for label, jentry, tentry in c.entries():
        pallas = RHK.decode_exits(c.jdev, jentry, chunk_bits=CHUNK_BITS,
                                  interpret=True, **c.kw)
        span, _ = RD.decode_span(c.jdev, jentry, c.jmeta["word_base"],
                                 c.jmeta["limit"], c.jmeta["ts"],
                                 c.jmeta["upm"], **c.kw)
        before = HK.decode_exits.launches
        got = HK.decode_exits(c.tdev, c.tmeta, tentry, **c.kw)
        assert HK.decode_exits.launches == before  # CPU: the plain version
        for f, a, b, g in zip("puzn", pallas, span, got):
            _eq(a, g)
            _eq(b, g)


@pytest.mark.parametrize("name", CORPORA)
def test_jacobi_sync_matches(name):
    c = case(name)
    res = jacobi_sync(
        c.tdev, max_rounds=c.shape.n_chunks + 2, permuted=False,
        decode_exits=lambda d, e: HK.decode_exits_plain(d, c.tmeta, e, **c.kw))
    assert res.converged and res.rounds == c.rounds
    for a, g in zip(c.jexits, res.exits):
        _eq(a, g)


@pytest.mark.parametrize("name", CORPORA)
def test_write_pass_forms_match_decode_span(name):
    c = case(name)
    _, _, entry = c.entries()[1]
    jentry = RS.chain_entries(c.jdev, c.jexits, False)
    (jb, jm), (tb, tm) = c.write_inputs()
    n_coef = c.shape.n_units * 64
    _, exp = RD.decode_span(c.jdev, jentry, c.jmeta["word_base"],
                            c.jmeta["limit"], c.jmeta["ts"], c.jmeta["upm"],
                            write=True, out=jnp.zeros(n_coef, jnp.int32),
                            write_base=jb, write_max=jm, **c.kw)
    stream = HK.decode_coeffs(c.tdev, c.tmeta, entry, tb, tm, n_coef, **c.kw)
    store = FS.decode_coeffs_store(c.tdev, c.tmeta, entry, tb, tm, n_coef,
                                   **c.kw)
    _eq(exp, stream)
    _eq(exp, store)
    # and the coefficients are the oracle's
    coeffs = D.undiff_dc(c.tdev, store.reshape(-1, 64))[:c.plan.total_units]
    np.testing.assert_array_equal(coeffs.numpy(), oracle_coeffs(c.blobs))


@pytest.mark.parametrize("name", CORPORA)
def test_placement_undiff_and_chain_match(name):
    c = case(name)
    texits = c.both(c.jexits)[1]
    for permuted in (True, False):
        _eq(RD.chunk_write_bases(c.jdev, c.jexits.n, permuted=permuted),
            D.chunk_write_bases(c.tdev, texits.n, permuted=permuted))
        for a, g in zip(RS.chain_entries(c.jdev, c.jexits, permuted),
                        chain_entries(c.tdev, texits, permuted)):
            _eq(a, g)
    rng = np.random.default_rng(0)
    coeffs = rng.integers(-300, 300, (c.shape.n_units, 64)).astype(np.int32)
    _eq(RD.undiff_dc(c.jdev, jnp.asarray(coeffs)),
        D.undiff_dc(c.tdev, torch.from_numpy(coeffs)))


@pytest.mark.parametrize("n", [1, 2, 7, 64])
def test_segmented_exclusive_cumsum_matches(n):
    rng = np.random.default_rng(n)
    vals = rng.integers(0, 1000, n).astype(np.int32)
    flags = rng.random(n) < 0.3
    _eq(RD.segmented_exclusive_cumsum(jnp.asarray(vals), jnp.asarray(flags)),
        D.segmented_exclusive_cumsum(torch.from_numpy(vals),
                                     torch.from_numpy(segment_starts(flags))))


@pytest.mark.parametrize("name", RGB_CORPORA)
def test_pixel_plain_within_one_of_pallas(name):
    c = case(name)
    g = c.plan.geometry
    coeffs = oracle_coeffs(c.blobs)
    mrow = c.plan.unit_mrow
    geo = dict(comp_h=tuple(g.comp_h), comp_v=tuple(g.comp_v),
               h_max=g.h_max, v_max=g.v_max, upm=g.units_per_mcu)
    exp = np.asarray(fused_pixels_pallas(
        jnp.asarray(coeffs), jnp.asarray(c.plan.m_matrices),
        jnp.asarray(mrow), interpret=True, **geo))
    before = FP.fused_pixels.launches
    got = FP.fused_pixels(torch.from_numpy(coeffs), c.tdev["m_matrices_t"],
                          torch.from_numpy(mrow), **geo)
    assert FP.fused_pixels.launches == before  # CPU: the plain version
    got = got.permute(0, 3, 1, 2).numpy().astype(int)  # to (n, 3, mh, mw)
    d = np.abs(got - exp.astype(int))
    assert d.max() <= 1
    assert (d == 1).sum() <= 0.001 * d.size  # off by one only on ties


def test_idct_units_folded_within_one_of_reference():
    c = case("mixed")
    coeffs = oracle_coeffs(c.blobs)
    exp = np.asarray(RD.idct_units_folded(
        jnp.asarray(coeffs), jnp.asarray(c.plan.m_matrices),
        jnp.asarray(c.plan.unit_mrow)))
    got = D.idct_units_folded(torch.from_numpy(coeffs),
                              torch.from_numpy(c.plan.m_matrices),
                              torch.from_numpy(c.plan.unit_mrow)).numpy()
    d = np.abs(got - exp)
    assert d.max() <= 1 and (d == 1).sum() <= 0.001 * d.size
