"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips. On a machine
with one: ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import decode as D
from repro_torch.core.api import ParallelDecoder
from repro_torch.core.state import DecodeState
from repro_torch.core.sync import chain_entries, jacobi_sync
from repro_torch.kernels.color import ops as CK
from repro_torch.kernels.fused import pixels as FP
from repro_torch.kernels.fused import store as FS
from repro_torch.kernels.huffman import ops as HK
from repro_torch.kernels.idct import ops as IK

from _torch_corpus import corpus, oracle_coeffs

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("name", ["420", "restart", "optimized", "mixed"])
def test_huffman_kernels_match_plain(card, name):
    dec = ParallelDecoder.from_bytes(corpus(name), chunk_bits=256,
                                     device=card)
    dev, sh = dec.dev, dec.shape
    meta = D.chunk_meta(dev)
    kw = dict(s_max=sh.s_max, min_code_bits=sh.min_code_bits)
    res = jacobi_sync(dev, max_rounds=sh.n_chunks + 2, permuted=False,
                      decode_exits=lambda d, e: HK.decode_exits(d, meta, e,
                                                                **kw))
    assert res.converged
    entries = chain_entries(dev, res.exits, False)
    for entry in (DecodeState.cold(dev["chunk_start"]), entries):
        for g, e in zip(HK.decode_exits(dev, meta, entry, **kw),
                        HK.decode_exits_plain(dev, meta, entry, **kw)):
            assert torch.equal(g, e)
    for g, e in zip(HK.decode_streams(dev, meta, entries, **kw),
                    HK.decode_streams_plain(dev, meta, entries, **kw)):
        assert torch.equal(g, e)
    bases = D.chunk_write_bases(dev, res.exits.n, permuted=False)
    seg_end = torch.cat([dev["seg_coeff_base"][1:], dev["units_end"][None]])
    wmax = seg_end[dev["chunk_seg"].long()] - 1
    n = sh.n_units * 64
    assert torch.equal(
        FS.decode_coeffs_store(dev, meta, entries, bases, wmax, n, **kw),
        FS.decode_coeffs_store_plain(dev, meta, entries, bases, wmax, n,
                                     **kw))


@pytest.mark.parametrize("name", ["420", "444"])
def test_pixel_kernel_matches_plain(card, name):
    blobs = corpus(name)
    dec = ParallelDecoder.from_bytes(blobs, device=card)
    g = dec.plan.geometry
    coeffs = torch.from_numpy(oracle_coeffs(blobs)).to(card)
    m = dec.dev["m_matrices_t"]
    mrow = torch.from_numpy(dec.plan.unit_mrow).to(card)
    geo = dict(comp_h=tuple(g.comp_h), comp_v=tuple(g.comp_v),
               h_max=g.h_max, v_max=g.v_max, upm=g.units_per_mcu)
    assert torch.equal(FP.fused_pixels(coeffs, m, mrow, **geo),
                       FP.fused_pixels_plain(coeffs, m, mrow, **geo))


@pytest.mark.parametrize("fuse", ["post", "full"])
def test_decode_batch_on_the_card_matches_plain(card, fuse):
    blobs = corpus("420")
    got = repro_torch.decode_batch(blobs, chunk_bits=256, fuse=fuse)
    exp = repro_torch.decode_batch(blobs, chunk_bits=256, backend="torch",
                                   device=card)
    assert got.pixels_fused and got.store_fused == (fuse == "full")
    assert torch.equal(got.coeffs, exp.coeffs)
    assert (got.sync_rounds, got.converged) == (exp.sync_rounds, True)
    assert torch.equal(got.rgb, exp.rgb)
    np.testing.assert_array_equal(got.coeffs.cpu().numpy(),
                                  oracle_coeffs(blobs))


@pytest.mark.parametrize("name", ["420", "restart", "mixed"])
def test_exit_kernel_at_a_lane_subset_matches_plain(card, name):
    dec = ParallelDecoder.from_bytes(corpus(name), chunk_bits=256,
                                     device=card)
    dev, sh = dec.dev, dec.shape
    meta = D.chunk_meta(dev)
    kw = dict(s_max=sh.s_max, min_code_bits=sh.min_code_bits)
    gen = torch.Generator().manual_seed(3)
    idx = torch.randperm(sh.n_chunks, generator=gen)[:sh.n_chunks // 2]
    idx = idx.to(torch.int32).to(card)
    cold = DecodeState.cold(dev["chunk_start"])
    entry = DecodeState(*(f[idx.long()] for f in cold))
    before = (HK.decode_exits.launches, HK.decode_exits.subset_launches)
    got = HK.decode_exits(dev, meta, entry, idx, **kw)
    # the idx form counts only in its own counter
    assert (HK.decode_exits.launches,
            HK.decode_exits.subset_launches) == (before[0], before[1] + 1)
    for g, e in zip(got, HK.decode_exits_plain(dev, meta, entry, idx, **kw)):
        assert torch.equal(g, e)


@pytest.mark.parametrize("budget", ["shared", "global"])
@pytest.mark.parametrize("name", ["420", "optimized", "mixed"])
def test_exit_kernel_table_sources_match_plain(card, name, budget):
    """The exit kernel with its tables in shared memory and, with a
    shared-memory budget of 0, read from global memory by the same kernel;
    every lane and a lane subset."""
    dec = ParallelDecoder.from_bytes(corpus(name), chunk_bits=256,
                                     device=card)
    dev, sh = dec.dev, dec.shape
    meta = D.chunk_meta(dev)
    kw = dict(s_max=sh.s_max, min_code_bits=sh.min_code_bits)
    smem = HK.exit_table_bytes(dev) if budget == "shared" else 0
    gen = torch.Generator().manual_seed(5)
    idx = torch.randperm(sh.n_chunks, generator=gen)[:sh.n_chunks // 3]
    idx = idx.to(torch.int32).to(card)
    cold = DecodeState.cold(dev["chunk_start"])
    for sub in (None, idx):
        entry = cold if sub is None else \
            DecodeState(*(f[sub.long()] for f in cold))
        got = HK.run_exit_kernel(dev, meta, entry, sub, **kw,
                                 smem_budget=smem)
        exp = HK.decode_exits_plain(dev, meta, entry, sub, **kw)
        for g, e in zip(got, exp):
            assert torch.equal(g, e)


@pytest.mark.parametrize("layout", ["mcu", "random"])
@pytest.mark.parametrize("units_per_mcu", [1, 3, 6])
@pytest.mark.parametrize("n_matrices", [2, 6])
@pytest.mark.parametrize("tail", [1, 77])
def test_idct_kernel_partial_last_tile(card, tail, n_matrices, units_per_mcu,
                                       layout):
    """U = 2 tiles + a tail, not a multiple of the tile: the tail's units
    are right. Matrix ids in an MCU pattern (a thread's 6 units share one
    but at an image boundary) and at random (they mix); six matrices are
    more than the kernel stages in shared memory, so it reads them from
    global memory."""
    tile = IK.tile_units(units_per_mcu)
    u = 2 * tile + tail
    rng = np.random.default_rng(tail)
    coeffs = torch.from_numpy(rng.integers(-1024, 1024, (u + 64, 64))
                              .astype(np.int32)).to(card)[:u]
    m_t = torch.from_numpy(rng.normal(0, 0.2, (n_matrices, 64, 64))
                           .astype(np.float32)).to(card)
    if layout == "mcu":
        comp = np.minimum(np.arange(u) % units_per_mcu, 1)
        ids = comp + 2 * (np.arange(u) >= u // 2)  # image 2: other tables
    else:
        ids = rng.integers(0, n_matrices, u)
    mrow = torch.from_numpy((ids % n_matrices).astype(np.int32)).to(card)
    got = IK.idct_units(coeffs, m_t, mrow, units_per_mcu)
    assert got.shape == (u, 64)
    assert torch.equal(got, IK.idct_units_plain(coeffs, m_t, mrow))


@pytest.mark.parametrize("name", ["420", "444", "gray"])
def test_idct_kernel_matches_plain(card, name):
    blobs = corpus(name)
    dec = ParallelDecoder.from_bytes(blobs, device=card)
    coeffs = torch.from_numpy(oracle_coeffs(blobs)).to(card)
    mrow = dec.dev["unit_mrow"][:dec.plan.total_units]
    m_t = dec.dev["m_matrices_t"]
    upm = dec.plan.geometry.units_per_mcu
    for hint in sorted({1, upm}):
        assert torch.equal(IK.idct_units(coeffs, m_t, mrow, hint),
                           IK.idct_units_plain(coeffs, m_t, mrow))


@pytest.mark.parametrize("comp_h,comp_v", [((1, 1, 1), (1, 1, 1)),
                                           ((2, 1, 1), (1, 1, 1)),
                                           ((2, 1, 1), (2, 1, 1)),
                                           ((2, 1, 1), (2, 1, 2))])
def test_color_kernel_matches_plain(card, comp_h, comp_v):
    h_max, v_max = max(comp_h), max(comp_v)
    gen = torch.Generator().manual_seed(0)
    planes = [torch.rand((2, 16 * v, 32 * h), generator=gen).mul(255)
              .to(card) for h, v in zip(comp_h, comp_v)]
    geo = (comp_h, comp_v, h_max, v_max, 16 * v_max - 3, 32 * h_max - 5)
    got = CK.upsample_color(planes, *geo)
    exp = CK.upsample_color_plain(planes, *geo)
    assert got.shape == exp.shape
    d = (got.to(torch.int16) - exp.to(torch.int16)).abs()
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) < 0.01


@pytest.mark.parametrize("sync", ["jacobi", "faithful", "specmap",
                                  "sequential"])
@pytest.mark.parametrize("name", ["420", "restart", "mixed", "optimized"])
def test_every_schedule_on_the_kernels_matches_the_oracle(card, sync, name):
    blobs = corpus(name)
    got = repro_torch.decode_batch(blobs, chunk_bits=256, sync=sync,
                                   emit="coeffs")
    exp = repro_torch.decode_batch(blobs, chunk_bits=256, sync=sync,
                                   emit="coeffs", backend="torch",
                                   device=card)
    assert (got.sync_rounds, got.converged) == (exp.sync_rounds, True)
    np.testing.assert_array_equal(got.coeffs.cpu().numpy(),
                                  oracle_coeffs(blobs))


@pytest.mark.parametrize("fuse", ["none", "post", "full"])
@pytest.mark.parametrize("name", ["420", "444", "gray"])
def test_unfused_and_grayscale_pixels_on_the_card(card, name, fuse):
    blobs = corpus(name)
    got = repro_torch.decode_batch(blobs, chunk_bits=256, fuse=fuse)
    exp = repro_torch.decode_batch(blobs, chunk_bits=256, backend="torch",
                                   device=card)
    unfused = fuse == "none" or name == "gray"
    assert got.idct_kernel == unfused and got.pixels_fused != unfused
    assert got.color_kernel == (unfused and name != "gray")
    assert torch.equal(got.coeffs, exp.coeffs)
    assert torch.equal(got.rgb, exp.rgb)
