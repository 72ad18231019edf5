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
from repro_torch.kernels.fused import pixels as FP
from repro_torch.kernels.fused import store as FS
from repro_torch.kernels.huffman import ops as HK

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
