"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips. On a machine
with one: ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
import ctypes

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import decode as D
from repro_torch.core.api import ParallelDecoder
from repro_torch.core.state import DecodeState
from repro_torch.core.sync import chain_entries, jacobi_sync
from repro_torch.kernels import build as B
from repro_torch.kernels.color import ops as CK
from repro_torch.kernels.fused import pixels as FP
from repro_torch.kernels.fused import store as FS
from repro_torch.kernels.huffman import ops as HK
from repro_torch.kernels.idct import ops as IK

from repro.jpeg import codec_ref as cr

from _torch_corpus import _enc, corpus, oracle_coeffs, synth_image

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


@pytest.mark.parametrize("name", ["420", "422", "444"])
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
    assert torch.equal(got, exp)


@pytest.mark.parametrize("misalign", [0, 1])
@pytest.mark.parametrize("comp_h,comp_v", [((2, 1, 1), (2, 1, 1)),
                                           ((2, 1, 1), (1, 1, 1)),
                                           ((1, 1, 1), (2, 1, 1)),
                                           ((4, 1, 1), (1, 1, 1))])
def test_color_kernel_on_an_odd_crop(card, comp_h, comp_v, misalign):
    """Planes of a 1080p frame's MCU grid cropped to 1918x1078: the rows'
    3 x 1918 bytes are not 16-byte aligned and the last run of a row is
    cut; ``misalign`` starts every plane one float past a 16-byte
    boundary, so no run loads 16 bytes at once. torch.equal to the plain
    version, for the standard forms and a generic one (4:1:1)."""
    h_max, v_max = max(comp_h), max(comp_v)
    mcus_y, mcus_x = -(-1080 // (8 * v_max)), -(-1920 // (8 * h_max))
    gen = torch.Generator().manual_seed(1)
    planes = []
    for h, v in zip(comp_h, comp_v):
        n = 2 * mcus_y * 8 * v * mcus_x * 8 * h
        flat = torch.rand(n + 4, generator=gen).mul(300).sub(20).to(card)
        planes.append(flat[misalign:misalign + n].view(
            2, mcus_y * 8 * v, mcus_x * 8 * h))
    geo = (comp_h, comp_v, h_max, v_max, 1078, 1918)
    got = CK.upsample_color(planes, *geo)
    assert got.shape == (2, 1078, 1918, 3)
    assert torch.equal(got, CK.upsample_color_plain(planes, *geo))


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


@pytest.mark.parametrize("budget", ["shared", "global"])
@pytest.mark.parametrize("name", ["420", "optimized", "mixed", "restart"])
def test_stream_kernel_table_sources_match_plain(card, name, budget):
    """The stream kernel with its tables in shared memory and, with a
    shared-memory budget of 0, read from global memory; cold and converged
    entries."""
    dec = ParallelDecoder.from_bytes(corpus(name), chunk_bits=256,
                                     device=card)
    dev, sh = dec.dev, dec.shape
    meta = D.chunk_meta(dev)
    kw = dict(s_max=sh.s_max, min_code_bits=sh.min_code_bits)
    smem = HK.exit_table_bytes(dev) if budget == "shared" else 0
    res = jacobi_sync(dev, max_rounds=sh.n_chunks + 2, permuted=False,
                      decode_exits=lambda d, e: HK.decode_exits(d, meta, e,
                                                                **kw))
    for entry in (DecodeState.cold(dev["chunk_start"]),
                  chain_entries(dev, res.exits, False)):
        got = HK.run_stream_kernel(dev, meta, entry, **kw, smem_budget=smem)
        for g, e in zip(got, HK.decode_streams_plain(dev, meta, entry,
                                                     **kw)):
            assert torch.equal(g, e)


@pytest.mark.parametrize("chunk_bits", [256, 1024])
@pytest.mark.parametrize("budget", ["shared", "global"])
@pytest.mark.parametrize("name", ["420", "optimized", "mixed", "restart"])
def test_store_kernel_table_sources_match_plain(card, name, budget,
                                                chunk_bits):
    """The store kernel with its tables in shared memory and, with a
    shared-memory budget of 0, read from global memory, on converged
    entries at 256-bit chunks (most units split between lanes) and at
    1024: torch.equal to the plain write pass, whole units and the units
    split between lanes alike."""
    dec = ParallelDecoder.from_bytes(corpus(name), chunk_bits=chunk_bits,
                                     device=card)
    dev, sh = dec.dev, dec.shape
    meta = D.chunk_meta(dev)
    kw = dict(s_max=sh.s_max, min_code_bits=sh.min_code_bits)
    smem = HK.exit_table_bytes(dev) if budget == "shared" else 0
    res = jacobi_sync(dev, max_rounds=sh.n_chunks + 2, permuted=False,
                      decode_exits=lambda d, e: HK.decode_exits(d, meta, e,
                                                                **kw))
    entries = chain_entries(dev, res.exits, False)
    bases = D.chunk_write_bases(dev, res.exits.n, permuted=False)
    seg_end = torch.cat([dev["seg_coeff_base"][1:], dev["units_end"][None]])
    wmax = seg_end[dev["chunk_seg"].long()] - 1
    n = sh.n_units * 64
    before = FS.decode_coeffs_store.launches
    got = FS.run_store_kernel(dev, meta, entries, bases, wmax, n, **kw,
                              smem_budget=smem)
    assert FS.decode_coeffs_store.launches == before  # uncounted
    assert torch.equal(got, FS.decode_coeffs_store_plain(
        dev, meta, entries, bases, wmax, n, **kw))


@pytest.mark.parametrize("budget", ["shared", "global"])
@pytest.mark.parametrize("many", [False, True])
def test_store_kernel_lane_and_warp_writes_match_plain(card, many, budget):
    """The store kernel's whole units go out by each lane itself when the
    launch has fewer lanes than a warp an SM, by the warp together when it
    has more: a small batch and one of q95 320x240 frames at 256-bit
    chunks large enough for the warp's writes, each torch.equal to the
    plain write pass."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    blobs = corpus("420")
    if many:
        blobs = [_enc(synth_image(240, 320, seed=s), quality=95)
                 for s in range(16)]
    dec = ParallelDecoder.from_bytes(blobs, chunk_bits=256, device=card)
    dev, sh = dec.dev, dec.shape
    assert (sh.n_chunks >= 32 * sms) == many
    meta = D.chunk_meta(dev)
    kw = dict(s_max=sh.s_max, min_code_bits=sh.min_code_bits)
    res = jacobi_sync(dev, max_rounds=sh.n_chunks + 2, permuted=False,
                      decode_exits=lambda d, e: HK.decode_exits(d, meta, e,
                                                                **kw))
    entries = chain_entries(dev, res.exits, False)
    bases = D.chunk_write_bases(dev, res.exits.n, permuted=False)
    seg_end = torch.cat([dev["seg_coeff_base"][1:], dev["units_end"][None]])
    wmax = seg_end[dev["chunk_seg"].long()] - 1
    n = sh.n_units * 64
    smem = HK.exit_table_bytes(dev) if budget == "shared" else 0
    got = FS.run_store_kernel(dev, meta, entries, bases, wmax, n, **kw,
                              smem_budget=smem)
    assert torch.equal(got, FS.decode_coeffs_store_plain(
        dev, meta, entries, bases, wmax, n, **kw))


@pytest.mark.parametrize("name", ["420", "restart", "mixed"])
def test_scatter_on_the_card_matches_the_store_kernel(card, name):
    """Stream kernel + scatter on the card: the plain write pass's and the
    store kernel's coefficients, and the oracle's."""
    blobs = corpus(name)
    dec = ParallelDecoder.from_bytes(blobs, chunk_bits=256, device=card)
    dev, sh = dec.dev, dec.shape
    meta = D.chunk_meta(dev)
    kw = dict(s_max=sh.s_max, min_code_bits=sh.min_code_bits)
    res = jacobi_sync(dev, max_rounds=sh.n_chunks + 2, permuted=False,
                      decode_exits=lambda d, e: HK.decode_exits(d, meta, e,
                                                                **kw))
    entries = chain_entries(dev, res.exits, False)
    bases = D.chunk_write_bases(dev, res.exits.n, permuted=False)
    seg_end = torch.cat([dev["seg_coeff_base"][1:], dev["units_end"][None]])
    wmax = seg_end[dev["chunk_seg"].long()] - 1
    n = sh.n_units * 64
    got = HK.decode_coeffs(dev, meta, entries, bases, wmax, n, **kw)
    assert torch.equal(got, FS.decode_coeffs_store_plain(
        dev, meta, entries, bases, wmax, n, **kw))
    assert torch.equal(got, FS.decode_coeffs_store(
        dev, meta, entries, bases, wmax, n, **kw))
    coeffs = D.undiff_dc(dev, got.reshape(-1, 64))[:dec.plan.total_units]
    np.testing.assert_array_equal(coeffs.cpu().numpy(), oracle_coeffs(blobs))


@pytest.mark.parametrize("tail", [1, 7])
@pytest.mark.parametrize("n_matrices", [2, 5])
@pytest.mark.parametrize("comp_h,comp_v", [((2, 1, 1), (2, 1, 1)),
                                           ((2, 1, 1), (1, 1, 1)),
                                           ((1, 1, 1), (1, 1, 1)),
                                           ((1, 1, 1), (2, 1, 1)),
                                           ((4, 1, 1), (1, 1, 1)),
                                           ((3, 1, 1), (1, 1, 1)),
                                           ((1, 2, 1), (1, 2, 1))])
def test_pixel_kernel_layouts_and_partial_tiles(card, comp_h, comp_v,
                                                n_matrices, tail):
    """Each layout with a kernel of its own (4:2:0, 4:2:2, 4:4:4) and
    generic ones (4:4:0, 4:1:1, a factor of 3, chroma larger than luma),
    over 2 tiles + a tail of MCUs, with matrices staged in shared memory
    (2) and read from global memory (5): torch.equal to the plain
    version."""
    upm = sum(h * v for h, v in zip(comp_h, comp_v))
    n_mcus = 2 * FP.tile_mcus(upm) + tail
    u = n_mcus * upm
    rng = np.random.default_rng(tail + 10 * n_matrices)
    coeffs = torch.from_numpy(rng.integers(-512, 512, (u, 64))
                              .astype(np.int32)).to(card)
    m_t = torch.from_numpy(rng.normal(0, 0.05, (n_matrices, 64, 64))
                           .astype(np.float32)).to(card)
    mrow = torch.from_numpy(rng.integers(0, n_matrices, u)
                            .astype(np.int32)).to(card)
    geo = dict(comp_h=comp_h, comp_v=comp_v, h_max=max(comp_h),
               v_max=max(comp_v), upm=upm)
    got = FP.fused_pixels(coeffs, m_t, mrow, **geo)
    assert got.shape == (n_mcus, 8 * max(comp_v), 8 * max(comp_h), 3)
    assert torch.equal(got, FP.fused_pixels_plain(coeffs, m_t, mrow, **geo))


@pytest.mark.parametrize("comp_h,comp_v", [((0, 1, 1), (1, 1, 1)),
                                           ((2, 1, 1), (2, 0, 1)),
                                           ((2, 3, 1), (1, 1, 1)),
                                           ((2, 1, 1), (2, 2, 2)),
                                           ((-2, 1, 1), (1, 1, 1))])
def test_pixel_entry_point_refuses_bad_factors(card, comp_h, comp_v):
    """The C entry point refuses a zero or negative factor, one that does
    not divide the largest, or more than 6 units an MCU, with
    cudaErrorInvalidValue (1) and no launch, before any division."""
    ints3 = ctypes.c_int * 3
    buf = torch.zeros(64 * 64, dtype=torch.int32, device=card)
    err = B.entry("pixels", "rt_fused_pixels", FP._ARGS)(
        B.ptr(buf), B.ptr(buf), 1, B.ptr(buf), B.ptr(buf), 1,
        ints3(*comp_h), ints3(*comp_v), 0, B.stream_of(buf))
    assert err == 1


@pytest.mark.parametrize("fuse", ["post", "full"])
def test_cache_holds_no_stale_words_across_decoders(card, fuse):
    """Two decoders of one key on the card, decoded in turns: each gets its
    own batch's coefficients and pixels, and an earlier output keeps its
    values after the next decode of the key."""
    from repro_torch.core import api
    api.clear_decode_programs()
    blobs = [_enc(synth_image(48, 64, seed=s), quality=q)
             for s, q in ((11, 90), (12, 90))]
    a, b = (ParallelDecoder.from_bytes([x], chunk_bits=256, fuse=fuse,
                                       device=card) for x in blobs)
    if a.shape != b.shape:
        pytest.skip("the two frames landed in different buckets")
    assert a.program is b.program
    plain = [repro_torch.decode_batch([x], chunk_bits=256, backend="torch",
                                      device=card) for x in blobs]
    first = a.decode()
    keep = first.rgb.clone()
    for dec, exp in ((b, plain[1]), (a, plain[0]), (b, plain[1]),
                     (b, plain[1])):
        out = dec.decode()
        assert torch.equal(out.coeffs, exp.coeffs)
        assert torch.equal(out.rgb, exp.rgb)
    assert torch.equal(first.rgb, keep)
    assert a.program.allocations == 1 and a.program.uploads == 4


@pytest.mark.parametrize("sync", ["jacobi", "faithful", "specmap",
                                  "sequential"])
@pytest.mark.parametrize("name", ["420", "restart", "mixed"])
def test_block_sync_equals_the_per_round_form(card, sync, name):
    """On the exit kernel: blocks of rounds (cold, then warm with hints)
    give the exits, rounds and converged of one host check a round."""
    from repro_torch.core import api
    from repro_torch.core.sync import RoundBlocks
    dec = ParallelDecoder.from_bytes(corpus(name), chunk_bits=256,
                                     sync=sync, device=card)
    dev, sh = dec.dev, dec.shape
    meta = D.chunk_meta(dev)
    kw = dict(s_max=sh.s_max, min_code_bits=sh.min_code_bits)

    def fn(d, entry, idx=None, out=None):
        return HK.decode_exits(d, meta, entry, idx, out=out, **kw)

    per_round = api.run_sync(dev, sh, sync, fn, RoundBlocks(size=1))
    hints = {}
    for _ in range(2):
        got = api.run_sync(dev, sh, sync, fn, RoundBlocks(hints=hints),
                           bufs=dec.program.work.get("exits"))
        torch.cuda.synchronize()
        for g, e in zip(got.exits, per_round.exits):
            assert torch.equal(g, e)
        assert (got.rounds, got.converged) == (per_round.rounds, True)


def test_service_decodes_a_small_batch_on_the_card(card):
    from repro_torch.serve import DecodeService, ServiceConfig
    blobs = [_enc(synth_image(48, 64, seed=s), quality=85) for s in range(6)]
    bad = blobs[0][:40]
    with DecodeService(ServiceConfig(batch_size=4, chunk_bits=256,
                                     validate=True, max_form_ms=20.0,
                                     slo_ms=60_000.0)) as svc:
        res = [f.result(timeout=300) for f in svc.submit_many(blobs + [bad])]
        stats = svc.serve_stats()
    assert [r.status for r in res] == [0] * 6 + [2]
    for x, r in zip(blobs, res):
        d = np.abs(r.rgb.numpy().astype(int)
                   - cr.decode_baseline(x).astype(int))
        assert d.max() <= 1
    assert stats["programs"]["allocations"] >= 1


@pytest.mark.parametrize("sync", ["jacobi", "faithful", "specmap"])
@pytest.mark.parametrize("name", ["420", "restart", "mixed"])
def test_graphed_rounds_equal_the_eager_ones(card, sync, name):
    """From a program's second decode on, its Jacobi rounds replay as CUDA
    graphs of two rounds: coefficients, rounds and pixels stay the plain
    path's."""
    from repro_torch.core import api
    api.clear_decode_programs()
    blobs = corpus(name)
    plain = repro_torch.decode_batch(blobs, chunk_bits=256, sync=sync,
                                     backend="torch", device=card)
    dec = ParallelDecoder.from_bytes(blobs, chunk_bits=256, sync=sync,
                                     device=card)
    outs = [dec.decode() for _ in range(3)]
    # faithful verifies in one round here: an odd round runs eagerly
    assert (dec.launch_stats()["graph_replays"] > 0) == (sync != "faithful")
    for out in outs:
        assert (out.sync_rounds, out.converged) == (plain.sync_rounds, True)
        assert torch.equal(out.coeffs, plain.coeffs)
        assert torch.equal(out.rgb, plain.rgb)


def test_pipeline_tokens_on_the_card_match_the_cpu(card):
    """The pipeline's tokens on the card against its ``device="cpu"``
    tokens for the same batch: within one bf16 ulp (the products sum in
    different orders); the patch vectors themselves are bit-identical."""
    from repro_torch.data.jpeg_pipeline import JpegVisionPipeline
    blobs = [_enc(synth_image(48, 64, seed=s), quality=90) for s in range(3)]
    kw = dict(patch=8, embed_dim=256, chunk_bits=256)
    gpu = JpegVisionPipeline(device=card, sync_stats=True, **kw)
    cpu = JpegVisionPipeline(device="cpu", **kw)
    tok, stats = gpu.patches_for(blobs)
    ref, ref_stats = cpu.patches_for(blobs)
    assert tok.device.type == "cuda" and tok.dtype == torch.bfloat16
    np.testing.assert_allclose(tok.float().cpu().numpy(),
                               ref.float().numpy(), rtol=2 ** -7,
                               atol=2 ** -9)
    assert (stats.sync_rounds, stats.bucket) == (ref_stats.sync_rounds,
                                                 ref_stats.bucket)
    rgb = torch.from_numpy(np.stack([cr.decode_baseline(b) for b in blobs]))
    eye = np.eye(8 * 8 * 3, dtype=np.float32)
    vec = []
    for dev in (card, torch.device("cpu")):
        p = JpegVisionPipeline(device=dev, patch=8, embed_dim=eye.shape[1])
        p.load_embed(eye)
        vec.append(p.embed(rgb.to(dev)).cpu())
    assert torch.equal(*vec)
    assert gpu.decode_stats()["kernel_launches"] > 0


@pytest.mark.parametrize("fuse", ["post", "full"])
@pytest.mark.parametrize("sync", ["jacobi", "faithful", "specmap"])
def test_balanced_plan_on_the_kernels_equals_identity(card, sync, fuse):
    """A balanced (permuted) plan keys a program and CUDA graphs of its
    own: its decodes, graphed from the second on, equal the identity
    plan's."""
    from repro_torch.core import api
    api.clear_decode_programs()
    blobs = corpus("restart") + corpus("420")[:1]
    kw = dict(chunk_bits=128, seq_chunks=4, sync=sync, fuse=fuse,
              device=card)
    ident = repro_torch.decode_batch(blobs, emit="coeffs", **kw)
    for balance in ("roundrobin", "lpt"):
        dec = ParallelDecoder.from_bytes(blobs, balance=balance, lanes=4,
                                         **kw)
        assert dec.shape.permuted and dec.shape.n_lanes == 4
        outs = [dec.decode(emit="coeffs") for _ in range(3)]
        if sync != "faithful":
            assert dec.launch_stats()["graph_replays"] > 0
        for out in outs:
            assert (out.sync_rounds, out.converged) == (ident.sync_rounds,
                                                        True)
            assert torch.equal(out.coeffs, ident.coeffs)
    assert api.decode_program_stats()["programs"] == 3


def test_two_processes_on_one_card(card):
    """``decode_multihost`` in two processes sharing the card: each
    process's coefficients equal its slice of one process's decode."""
    import hashlib
    from _torch_multiproc import run_processes
    results = run_processes("""
import hashlib
import numpy as np
from repro.jpeg import codec_ref as cr
from repro_torch.launch.multihost import HostFeed, decode_multihost
from _torch_corpus import synth_image
corpus = [cr.encode_baseline(synth_image(48, 64, seed=s), quality=90
                             ).jpeg_bytes for s in range(4)]
out = decode_multihost(HostFeed.from_corpus(corpus, ctx).local_blobs, ctx,
                       chunk_bits=256, emit="rgb")
co = np.ascontiguousarray(out.local.coeffs.cpu().numpy())
emit({"digest": hashlib.blake2b(co.tobytes()).hexdigest(),
      "device": str(out.local.coeffs.device),
      "offset": out.global_coeffs.offset, "rgb": list(out.local.rgb.shape)})
""", 2, timeout=600, init_timeout=300)
    blobs = [_enc(synth_image(48, 64, seed=s), quality=90) for s in range(4)]
    one = repro_torch.decode_batch(blobs, chunk_bits=256, emit="coeffs",
                                   device=card).coeffs.cpu().numpy()
    half = one.shape[0] // 2
    for r, rows in zip(results, (one[:half], one[half:])):
        assert r["digest"] == hashlib.blake2b(
            np.ascontiguousarray(rows).tobytes()).hexdigest()
        assert r["device"] == "cuda:0" and r["rgb"] == [2, 48, 64, 3]
    assert [r["offset"] for r in results] == [0, half]


# -- the kernel verifier and the launch autotuner ----------------------------

@pytest.mark.parametrize("name", ["420", "restart", "mixed"])
def test_checked_build_equals_release_under_every_candidate(card, name):
    """Every kernel's checked build under each of its launch candidates on
    a small plan: an empty record, every IDCT / pixel / color output
    element written once, and the release build's output, equal to the
    plain version's; the 4:2:2 and 4:4:4 layouts' pixel kernels too."""
    from repro_torch.analysis import kernel_check as K

    dec = ParallelDecoder.from_bytes(corpus(name), chunk_bits=256,
                                     device=card)
    layouts = [ParallelDecoder.from_bytes(corpus(s), device=card)
               for s in ("422", "444")] if name == "420" else []
    g = dec.plan.geometry
    crops = [(g.height - 1, g.width - 3)] if g is not None and \
        len(g.comp_h) == 3 else []
    vs, n, refused = K.verify_batch(dec, name, layouts=layouts, crops=crops)
    assert not vs, "\n".join(v.format() for v in vs)
    assert n >= 20
    assert all("warp" in r for r in refused), refused


def test_self_test_catches_the_seeds_on_the_card(card):
    """S1 by kernel-bounds, S2 and S3 by kernel-tiling, the duplicate
    scatter by kernel-scatter-race; each seed equals its plain version."""
    from repro_torch.analysis import kernel_check as K
    from repro_torch.kernels import seeds as S

    failures, caught = K.run_self_test(device="cuda")
    assert failures == []
    assert [v.family for v in caught] == [
        "kernel-bounds", "kernel-tiling", "kernel-tiling",
        "kernel-scatter-race"]
    assert "kSiteSeedRows" in caught[0].detail
    x = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    assert torch.equal(S.seed_oob_rows(x.to(card)).cpu(),
                       S.seed_oob_rows_plain(x, strict=False))
    y = torch.arange(10, dtype=torch.float32)
    assert torch.equal(S.seed_ident(y.to(card)).cpu(),
                       S.seed_ident_plain(y)[0])
    coeffs, m_t, mrow, geo = S.seed_pixel_operands(card)
    got = S.seed_misaligned_tile(coeffs, m_t, mrow, **geo)
    exp, _ = S.seed_misaligned_tile_plain(coeffs, m_t, mrow, **geo)
    assert torch.equal(got, exp)


def test_autotune_search_on_a_small_bucket(card, tmp_path, monkeypatch):
    """REPRO_TORCH_AUTOTUNE=1 measures every candidate on the bucket; the
    winner decodes bit-identically to the defaults, the losers' programs
    are dropped, and a second resolution reads the table and measures
    nothing."""
    from repro_torch.core import api
    from repro_torch.kernels import autotune as AT

    table = tmp_path / "launch.json"
    monkeypatch.setenv(AT.TABLE_ENV, str(table))
    monkeypatch.setenv(AT.AUTOTUNE_ENV, "1")
    monkeypatch.delenv(AT.LAUNCH_ENV, raising=False)
    AT.clear_launch_cache()
    api.clear_decode_programs()
    blobs = corpus("420")
    dec = ParallelDecoder.from_bytes(blobs, device=card, fuse="full")
    assert dec.launch in AT.candidate_configs()
    assert table.exists()
    keys = {b["bucket"] for b in api.decode_program_stats()["buckets"]}
    assert api.decode_program_stats()["programs"] == len(keys) == 1
    monkeypatch.delenv(AT.AUTOTUNE_ENV)
    ref = ParallelDecoder.from_bytes(blobs, device=card, fuse="full",
                                     launch=AT.DEFAULT_LAUNCH)
    a, b = dec.decode(), ref.decode()
    assert torch.equal(a.coeffs, b.coeffs) and torch.equal(a.rgb, b.rgb)
    AT.clear_launch_cache()

    def measure(cfg):
        raise AssertionError("a warm bucket measured again")

    assert AT.resolve_launch(dec.shape, "cuda", "full",
                             measure=measure) == dec.launch
    AT.clear_launch_cache()
