"""The port's kernel verifier (``repro_torch.analysis.kernel_check``) on the
CPU: the kernels' launch geometry built with g++, the scatter-race legs
against the JAX package's, the checked build's guard (``csrc/check.cuh``)
in g++ builds of the symbol step, the store kernel's loop and the color
run over real plans, and the CPU forms of the self-test's seeded faults.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import bitstream as RB
from repro_torch.analysis import kernel_check as K
from repro_torch.analysis.contracts import (ContractViolation,
                                            check_block_cover)
from repro_torch.core import bitstream as TB
from repro_torch.core import decode as D
from repro_torch.core.api import ParallelDecoder
from repro_torch.core.sync import chain_entries, jacobi_sync
from repro_torch.kernels import autotune as AT
from repro_torch.kernels.huffman import ops as HK

from _torch_corpus import corpus

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / \
    "kernels" / "csrc"

# -- kernel-tiling on the host ---------------------------------------------------

def test_geometry_covers_every_rung_for_every_candidate():
    vs, cells = K.check_geometry()
    assert vs == [], "\n".join(v.format() for v in vs[:10])
    lanes = len(K.ladder(K.MAX_LANES))
    assert K.ladder(K.MAX_LANES)[-1] >= K.MAX_LANES
    assert K.ladder(K.MAX_UNITS)[-1] >= K.MAX_UNITS
    # every Huffman block size on every lane rung, at the least
    sizes = sum(len(AT.LAUNCH_CANDIDATES[k]) for k in
                ("exit_threads", "stream_threads", "store_threads"))
    assert cells >= sizes * lanes


def test_geometry_is_the_kernels_own():
    """The g++ build answers with the C++ arithmetic: the default groups
    of each stride, a refused knob, the group mapping and the store
    kernel's slots."""
    geo = K.geometry_lib()
    assert [geo.geo_groups(0, s) for s in range(1, 7)] == \
        [48, 48, 48, 48, 40, 48]
    assert geo.geo_groups(24, 5) == -1 and geo.geo_groups(24, 6) == 24
    assert geo.geo_groups(0, 7) == -1
    assert geo.geo_store_slot_bytes(256) == 66 * 4 * 256
    assert geo.geo_blocks(269_063, 256) == 1052
    assert geo.geo_warp_units(2, 31, 132) == -1
    assert geo.geo_warp_units(0, 32 * 132, 132) == 1
    assert geo.geo_warp_units(0, 32 * 132 - 1, 132) == 0
    # the block sizes the kernels are built for are the tuner's candidates
    for which, knob in enumerate(("exit_threads", "stream_threads",
                                  "store_threads")):
        out = (ctypes.c_int * 3)()
        n = geo.geo_thread_choices(which, out)
        assert tuple(out[:n]) == AT.LAUNCH_CANDIDATES[knob]


def test_geometry_flags_a_block_size_the_kernel_lacks():
    bad = AT.LaunchConfig(exit_threads=1024)  # not instantiated
    vs, _ = K.check_geometry([bad], max_lanes=64, max_units=64)
    assert [v.cell for v in vs] == ["exit_threads=1024"]


def test_geometry_flags_a_group_count_that_misses_units():
    """A config whose groups leave a partial stride tile is caught (the
    check runs the candidates it is given)."""
    bad = AT.LaunchConfig(pixel_groups=44)  # a multiple of 4, not of 6
    vs, _ = K.check_geometry([bad], max_lanes=64, max_units=64)
    # 44 is refused for strides that do not divide it; for strides that
    # do (1, 2, 4, 11...) it tiles whole warps and covers
    assert all(v.family == "kernel-tiling" for v in vs)
    geo = K.geometry_lib()
    assert geo.geo_groups(44, 6) == -1 and geo.geo_groups(44, 4) == 44


@pytest.mark.parametrize("extent,tile,blocks,ok", [
    (10, 4, 3, True), (10, 4, 2, False), (8, 4, 3, False), (8, 4, 2, True),
    (1, 256, 1, True), (0, 4, 0, True), (0, 4, 1, False), (257, 256, 1,
                                                           False)])
def test_block_cover(extent, tile, blocks, ok):
    if ok:
        check_block_cover(extent, tile, blocks, "t")
    else:
        with pytest.raises(ContractViolation):
            check_block_cover(extent, tile, blocks, "t")


def test_block_cover_unmasked_needs_divisibility():
    check_block_cover(12, 4, 3, "t", masked=False)
    with pytest.raises(ContractViolation):
        check_block_cover(10, 4, 3, "t", masked=False)


# -- kernel-scatter-race ----------------------------------------------------------

def _seg_cases(base, units):
    b = np.asarray(base, dtype=np.int64)
    bad_start = b + 64
    swapped = b.copy()
    if b.size > 2:
        swapped[[1, 2]] = swapped[[2, 1]] + np.array([64, -64])
    beyond = b.copy()
    beyond[-1] = units * 64 + 1
    return [("real", b), ("start", bad_start), ("order", swapped),
            ("beyond", beyond)]


@pytest.mark.parametrize("name", ["restart", "mixed", "420"])
def test_seg_coeff_disjoint_agrees_with_repro(name):
    blobs = corpus(name)
    ours = TB.build_batch_plan(blobs, chunk_bits=128)
    theirs = RB.build_batch_plan(blobs, chunk_bits=128)
    np.testing.assert_array_equal(ours.seg_coeff_base, theirs.seg_coeff_base)
    for label, base in _seg_cases(ours.seg_coeff_base, ours.total_units):
        results = []
        for check in (TB.check_seg_coeff_disjoint,
                      RB.check_seg_coeff_disjoint):
            try:
                check(base, ours.total_units)
                results.append(True)
            except ValueError:
                results.append(False)
        assert results[0] == results[1], label
        assert results[0] == (label == "real" or (
            label == "order" and base.size <= 2))
    assert K.check_plan_disjoint(ours, name) == []


def _write_inputs(name, chunk_bits=256):
    dec = ParallelDecoder.from_bytes(corpus(name), chunk_bits=chunk_bits,
                                     device="cpu")
    sh, dev = dec.shape, dec.dev
    meta = D.chunk_meta(dev)
    kw = dict(s_max=sh.s_max, min_code_bits=sh.min_code_bits)
    res = jacobi_sync(dev, max_rounds=sh.n_chunks + 2, permuted=sh.permuted,
                      decode_exits=lambda d, e: HK.decode_exits_plain(
                          d, meta, e, **kw))
    entries = chain_entries(dev, res.exits, sh.permuted)
    bases = D.chunk_write_bases(dev, res.exits.n, permuted=sh.permuted)
    seg_end = torch.cat([dev["seg_coeff_base"][1:], dev["units_end"][None]])
    wmax = seg_end[dev["chunk_seg"].long()] - 1
    return dec, dev, meta, kw, entries, bases, wmax, sh.n_units * 64


@pytest.mark.parametrize("name", ["restart", "mixed", "optimized"])
def test_scatter_check_clean_on_real_streams(name):
    dec, dev, meta, kw, entries, bases, wmax, n = _write_inputs(name)
    pos, val = HK.decode_streams_plain(dev, meta, entries, **kw)
    assert K.check_scatter_targets(pos, val, bases, wmax, n, name) == []
    # and the scatter places what the plain write pass stores
    got = HK.scatter_streams(pos, val, bases, wmax, n)
    from repro_torch.kernels.fused import store as FS
    assert torch.equal(got, FS.decode_coeffs_store_plain(
        dev, meta, entries, bases, wmax, n, **kw))


def test_scatter_check_flags_duplicates_and_falling_positions():
    dec, dev, meta, kw, entries, bases, wmax, n = _write_inputs("restart")
    pos, val = HK.decode_streams_plain(dev, meta, entries, **kw)
    # two lanes of one segment given one write base: their targets collide
    lanes = torch.nonzero((pos >= 0).any(0)).flatten()
    seg = dev["chunk_seg"][lanes]
    pair = next(int(lanes[i]) for i in range(1, len(lanes))
                if seg[i] == seg[i - 1])
    b2 = bases.clone()
    b2[pair] = bases[pair - 1]
    vs = K.check_scatter_targets(pos, val, b2, wmax, n, "dup")
    assert [v.family for v in vs] == ["kernel-scatter-race"]
    assert "duplicate" in vs[0].detail
    # a lane whose later step records a position below an earlier one
    lane = int(lanes[0])
    steps = torch.nonzero(pos[:, lane] >= 0).flatten()
    p2 = pos.clone()
    p2[steps[1], lane] = pos[steps[0], lane]
    vs = K.check_scatter_targets(p2, val, bases, wmax, n, "fall")
    assert any("not above" in v.detail for v in vs)
    assert K.check_scatter_targets(*K.dup_scatter_case(), "seed")


# -- the checked build's guard in g++ builds -------------------------------------

HUFFMAN_SHIM = r"""
#include "huffman.cuh"

#define ARGS                                                               \
  const uint32_t *words, int n_words, const uint16_t *ctab, int n_tab,     \
      const int32_t *lut_off, int n_offs, const int32_t *word_base,        \
      const int32_t *ts, const int32_t *limit, const int32_t *upm,         \
      const int32_t *in_p, const int32_t *in_u, const int32_t *in_z,       \
      int32_t *pos, int32_t *val, int n_lanes, int s_max, int min_code_bits

static rt::CompactLut<false> lane_table(const uint16_t* ctab, int n_tab,
                                        const int32_t* lut_off, int n_offs,
                                        int ts) {
  const int64_t row = (int64_t)ts * (2 * rt::kMaxUpm);
  return rt::CompactLut<false>{ctab, lut_off + row, n_tab, n_offs - row};
}

// the exit kernel's loop and the stream kernel's (rt::stream_lane), with
// the kernels' extents, over every lane
extern "C" void host_checked_streams(ARGS) {
  for (int lane = 0; lane < n_lanes; ++lane) {
    const auto table = lane_table(ctab, n_tab, lut_off, n_offs, ts[lane]);
    rt::LaneState st{in_p[lane], in_u[lane], in_z[lane], 0};
    rt::BufferedWindow window(words, n_words, word_base[lane], st.p);
    for (int i = 0; i < s_max && st.p < limit[lane]; ++i) {
      rt::symbol_step(window, table, limit[lane], upm[lane], min_code_bits,
                      st);
    }
    rt::LaneState st2{in_p[lane], in_u[lane], in_z[lane], 0};
    rt::BufferedWindow window2(words, n_words, word_base[lane], st2.p);
    rt::stream_lane(window2, table, limit[lane], upm[lane], min_code_bits,
                    s_max, st2, pos + lane, val + lane, (int64_t)n_lanes,
                    true, [](int) {}, (int64_t)s_max * n_lanes - lane);
  }
}

// the store kernel's loop over every lane into coef (zeroed by the caller)
extern "C" void host_checked_store(ARGS, const int32_t *write_base,
                                   const int32_t *write_max, int32_t *coef,
                                   long long n_coef) {
  int32_t slot[64];
  for (int lane = 0; lane < n_lanes; ++lane) {
    const auto table = lane_table(ctab, n_tab, lut_off, n_offs, ts[lane]);
    rt::LaneState st{in_p[lane], in_u[lane], in_z[lane], 0};
    rt::BufferedWindow window(words, n_words, word_base[lane], st.p);
    const rt::CoefStore out{coef, n_coef, write_base[lane], write_max[lane]};
    rt::store_lane(window, table, limit[lane], upm[lane], min_code_bits,
                   s_max, st, out, slot, rt::LaneUnits{});
  }
}
"""

COLOR_SHIM = r"""
#include "color.cuh"

// the color kernel's work over every (image, row, run), as color.cu
// launches it, with its checked bounds and coverage
extern "C" void host_checked_color(const float* p0, const float* p1,
                                   const float* p2, const int* h,
                                   const int* w, const int* fv,
                                   const int* fh, uint8_t* out,
                                   int n_images, int height, int width) {
  constexpr int kRun = 8, kWords = 3 * kRun / 4, kLanes = 32;
  rt::ColorPlanes pl;
  const float* p[3] = {p0, p1, p2};
  for (int c = 0; c < 3; ++c) {
    pl.p[c] = p[c];
    pl.h[c] = h[c];
    pl.w[c] = w[c];
    pl.fv[c] = fv[c];
    pl.fh[c] = fh[c];
  }
  pl.n = n_images;
  pl.vec_w = rt::vector_width(pl);
  const bool store_vec = rt::rows_aligned<kRun>(out, width);
  uint32_t stage[kLanes * kWords + 1];
  rt::with_form(pl, [&](auto form) {
    using F = decltype(form);
    for (int b = 0; b < n_images; ++b)
      for (int y = 0; y < height; ++y) {
        uint8_t* row = rt::row_out(out, b, y, height, width);
        const long long at = ((long long)b * height + y) * width * 3;
        for (int x_w = 0; x_w < width; x_w += kLanes * kRun) {
          for (int lane = 0; lane < kLanes; ++lane) {
            const int x0 = x_w + lane * kRun;
            if (x0 >= width) break;
            const int n = width - x0 < kRun ? width - x0 : kRun;
            uint32_t* words = stage + lane * kWords;
            rt::color_run<kRun, F::fh, F::fv>(pl, b, y, x0, n, words);
            if (store_vec &&
                rt::ok(3LL * x0 + 3 * kRun - 1, 3LL * width, rt::kSiteRgb)) {
              rt::store_run<kRun>(row + 3 * x0, words);
              rt::cover(at + 3 * x0, 3 * kRun);
            }
          }
          if (store_vec) continue;
          const int nbytes = rt::span_bytes<kRun, kLanes>(x_w, width);
          for (int lane = 0; lane < kLanes; ++lane) {
            rt::copy_span<kLanes>(row + 3 * x_w, stage, nbytes, lane,
                                  3LL * (width - x_w), at + 3LL * x_w);
          }
        }
      }
  });
}
"""


def _build(tmp_path_factory, name, source):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp(name)
    (d / "shim.cpp").write_text(source)
    so = d / "libshim.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-DRT_CHECK", "-ffp-contract=off",
                    "-fno-strict-aliasing", f"-I{CSRC}",
                    str(d / "shim.cpp"), "-o", str(so)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.rt_check_read.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    lib.rt_check_reset.argtypes = []
    lib.rt_check_coverage.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    return lib


@pytest.fixture(scope="module")
def huffman_lib(tmp_path_factory):
    lib = _build(tmp_path_factory, "checked_huffman", HUFFMAN_SHIM)
    args = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 9 + \
        [ctypes.c_int] * 3
    lib.host_checked_streams.argtypes = args
    lib.host_checked_store.argtypes = args + [ctypes.c_void_p] * 3 + \
        [ctypes.c_longlong]
    return lib


@pytest.fixture(scope="module")
def color_lib(tmp_path_factory):
    lib = _build(tmp_path_factory, "checked_color", COLOR_SHIM)
    ints = ctypes.POINTER(ctypes.c_int)
    lib.host_checked_color.argtypes = [ctypes.c_void_p] * 3 + [ints] * 4 + \
        [ctypes.c_void_p] + [ctypes.c_int] * 3
    return lib


def _record(lib):
    buf = (ctypes.c_longlong * 4)()
    lib.rt_check_read(buf)
    return dict(site=buf[0], count=buf[1], index=buf[2], extent=buf[3])


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _huffman_run(lib, dec, dev, meta, kw, entries, bases, wmax, n_coef,
                 n_words=None):
    tables = HK.exit_tables(dev)
    tab, off = tables["luts_compact"], tables["unit_lut_off"].contiguous()
    keep = [dev["words"].contiguous(), tab.contiguous(), off,
            *(meta[k].contiguous() for k in ("word_base", "ts", "limit",
                                             "upm")),
            *(f.contiguous() for f in entries[:3])]
    c, s_max = entries.p.shape[0], kw["s_max"]
    pos = torch.zeros((s_max, c), dtype=torch.int32)
    val = torch.zeros((s_max, c), dtype=torch.int32)
    coef = torch.zeros(n_coef, dtype=torch.int32)
    n_words = keep[0].numel() if n_words is None else n_words
    args = [_ptr(keep[0]), n_words, _ptr(keep[1]), keep[1].numel(),
            _ptr(keep[2]), keep[2].numel()] + [_ptr(t) for t in keep[3:]]
    lib.rt_check_reset()
    lib.host_checked_streams(*args, _ptr(pos), _ptr(val), c, s_max,
                             kw["min_code_bits"])
    wb, wm = bases.contiguous(), wmax.contiguous()
    lib.host_checked_store(*args, _ptr(pos), _ptr(val), c, s_max,
                           kw["min_code_bits"], _ptr(wb), _ptr(wm),
                           _ptr(coef), n_coef)
    return _record(lib), pos, val, coef


@pytest.mark.parametrize("name,chunk_bits", [
    ("restart", 256), ("mixed", 256), ("optimized", 128), ("420", 1024),
    ("gray", 256)])
def test_checked_huffman_loops_leave_the_record_empty(huffman_lib, name,
                                                      chunk_bits):
    """The exit step, the stream loop and the store loop under -DRT_CHECK
    over a real plan (bucketed: inert pad lanes included): no access out
    of range, and the same streams and coefficients as the plain pass."""
    inputs = _write_inputs(name, chunk_bits)
    dec, dev, meta, kw, entries, bases, wmax, n = inputs
    rec, pos, val, coef = _huffman_run(huffman_lib, *inputs)
    assert rec == dict(site=0, count=0, index=0, extent=0)
    p_exp, v_exp = HK.decode_streams_plain(dev, meta, entries, **kw)
    assert torch.equal(pos, p_exp) and torch.equal(val, v_exp)
    from repro_torch.kernels.fused import store as FS
    assert torch.equal(coef, FS.decode_coeffs_store_plain(
        dev, meta, entries, bases, wmax, n, **kw))


@pytest.mark.parametrize("name", ["restart", "420", "mixed"])
def test_checked_window_flags_words_cut_two_short(huffman_lib, name):
    """An exact-fit plan's words buffer cut two words short: the last
    lane's reads of its window words past the buffer are flagged at the
    window site (the plan ends each segment in those two words, so a
    whole buffer is read within its end)."""
    blobs = corpus(name)
    dec = ParallelDecoder.from_bytes(blobs, chunk_bits=256, device="cpu",
                                     bucket=False)
    sh, dev = dec.shape, dec.dev
    meta = D.chunk_meta(dev)
    kw = dict(s_max=sh.s_max, min_code_bits=sh.min_code_bits)
    res = jacobi_sync(dev, max_rounds=sh.n_chunks + 2, permuted=sh.permuted,
                      decode_exits=lambda d, e: HK.decode_exits_plain(
                          d, meta, e, **kw))
    entries = chain_entries(dev, res.exits, sh.permuted)
    bases = D.chunk_write_bases(dev, res.exits.n, permuted=sh.permuted)
    seg_end = torch.cat([dev["seg_coeff_base"][1:], dev["units_end"][None]])
    wmax = seg_end[dev["chunk_seg"].long()] - 1
    args = (dec, dev, meta, kw, entries, bases, wmax, sh.n_units * 64)
    whole, *_ = _huffman_run(huffman_lib, *args)
    assert whole["count"] == 0
    n_words = dev["words"].numel()
    cut, *_ = _huffman_run(huffman_lib, *args, n_words=n_words - 2)
    assert K.check_sites()[cut["site"]] == "kSiteWords"
    assert cut["count"] > 0 and cut["extent"] == n_words - 2
    vs = K.check_record(cut, name)
    assert vs and vs[0].family == "kernel-bounds"
    assert "kSiteWords" in vs[0].detail


def _planes(layout, crop=(0, 0)):
    """A color batch's planes by the plain decoder, and its geometry."""
    from repro_torch.jpeg import codec_ref as cr
    from repro_torch.jpeg.encoder import synth_frame

    rng = np.random.default_rng(3)
    blobs = [cr.encode_baseline(synth_frame(rng, 70, 38, t=0.4 * i),
                                quality=85, subsampling=layout).jpeg_bytes
             for i in range(2)]
    dec = ParallelDecoder.from_bytes(blobs, device="cpu")
    out = dec.decode(emit="planes")
    g = dec.plan.geometry
    return [p.contiguous() for p in out.planes], g


@pytest.mark.parametrize("layout,crop", [
    ("4:2:0", (0, 0)), ("4:2:0", (1, 3)), ("4:2:2", (0, 0)),
    ("4:4:4", (0, 2)), ("4:4:4", (3, 7))])
def test_checked_color_run_writes_every_byte_once(color_lib, layout, crop):
    from repro_torch.kernels.color import ops as CK

    planes, g = _planes(layout)
    height, width = g.height - crop[0], g.width - crop[1]
    n = planes[0].shape[0]
    fv = [g.v_max // v for v in g.comp_v]
    fh = [g.h_max // h for h in g.comp_h]
    out = torch.zeros((n, height, width, 3), dtype=torch.uint8)
    cov = torch.zeros(out.numel(), dtype=torch.int32)
    ints = lambda t: (ctypes.c_int * 3)(*t)  # noqa: E731
    color_lib.rt_check_reset()
    color_lib.rt_check_coverage(_ptr(cov), cov.numel())
    color_lib.host_checked_color(
        *(_ptr(p) for p in planes), ints([p.shape[1] for p in planes]),
        ints([p.shape[2] for p in planes]), ints(fv), ints(fh), _ptr(out),
        n, height, width)
    color_lib.rt_check_coverage(None, 0)
    assert _record(color_lib)["count"] == 0
    assert K.check_coverage(cov, layout) == []
    geo = (g.comp_h, g.comp_v, g.h_max, g.v_max, height, width)
    assert torch.equal(out, CK.upsample_color_plain(planes, *geo))


def test_checked_color_run_flags_a_plane_too_short(color_lib):
    planes, g = _planes("4:2:0")
    n = planes[0].shape[0]
    fv = [g.v_max // v for v in g.comp_v]
    fh = [g.h_max // h for h in g.comp_h]
    out = torch.zeros((n, g.height, g.width, 3), dtype=torch.uint8)
    ints = lambda t: (ctypes.c_int * 3)(*t)  # noqa: E731
    rows = [p.shape[1] for p in planes]
    rows[1] = (g.height - 1) // fv[1] - 1  # chroma claimed a row short
    color_lib.rt_check_reset()
    color_lib.host_checked_color(
        *(_ptr(p) for p in planes), ints(rows),
        ints([p.shape[2] for p in planes]), ints(fv), ints(fh), _ptr(out),
        1, g.height, g.width)
    rec = _record(color_lib)
    assert K.check_sites()[rec["site"]] == "kSitePlaneRow"


# -- the self-test's faults on the CPU --------------------------------------------

def test_self_test_catches_the_cpu_forms_of_the_seeds():
    failures, caught = K.run_self_test(device="cpu")
    assert failures == []
    assert [v.family for v in caught] == [
        "kernel-bounds", "kernel-tiling", "kernel-tiling",
        "kernel-scatter-race"]
    assert "IndexError" in caught[0].detail


def test_seeds_plain_versions():
    from repro_torch.kernels import seeds as S

    x = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    with pytest.raises(IndexError):
        S.seed_oob_rows(x)
    assert float(S.seed_oob_rows_plain(x, strict=False)) == float(x[1:].sum())
    out, writes = S.seed_ident_plain(torch.arange(10, dtype=torch.float32))
    assert writes.tolist() == [1] * 8 + [0] * 2
    assert out.tolist() == list(range(8)) + [0, 0]
    coeffs, m_t, mrow, geo = S.seed_pixel_operands("cpu")
    assert tuple(coeffs.shape) == (60, 64) and geo["upm"] == 6
    blk, writes = S.seed_misaligned_tile_plain(coeffs, m_t, mrow, **geo)
    from repro_torch.kernels.fused import pixels as FP
    full = FP.fused_pixels_plain(coeffs, m_t, mrow, **geo)
    assert torch.equal(blk[:8], full[:8]) and not blk[8:].any()
    assert int(writes.sum()) == full[:8].numel()


def test_sites_are_the_enum():
    sites = K.check_sites()
    assert sites[0] == "kSiteNone" and sites[1] == "kSiteWords"
    assert len(set(sites.values())) == len(sites) >= 20


def test_verifier_run_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        K.run()


def test_kernel_launches_cover_every_candidate():
    launches = K.kernel_launches()
    assert [c.exit_threads for c in launches["huffman_exits"]] == \
        [256, 128, 512]
    assert len(launches["huffman_store"]) == 4
    assert len(launches["color"]) == 1
    for kernel, cfgs in launches.items():
        assert cfgs[0] == AT.DEFAULT_LAUNCH
