#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA decoder (``src/repro_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs a
CUDA device and ``nvcc``, and exits non-zero without printing a result
otherwise. Phases, each of which exits non-zero on failure:

1. build: compile every kernel source with nvcc for sm_90a, all at once;
2. kernel parity: each kernel against its plain PyTorch version on the
   full-width batch's plan (exits, the exits of a random half of the lanes
   (the ``idx`` form), streams, coefficients and IDCT samples
   bit-identical, RGB within 1), with each one's time, its plain
   version's time and its bound. The exit kernel is held with its tables
   in shared memory and in global memory (budget 0), over every lane and
   at the ``idx`` lanes; the IDCT kernel also on partial last tiles, with
   units that mix matrices and with six matrices;
3. oracle: small images through ``decode_batch`` with every sync schedule
   and fuse mode, and a grayscale group; coefficients equal the
   sequential oracle, RGB within 1 of it;
4. full width, at the paper's ``newyork`` setting (1920x1080, 4:2:0,
   q95, chunk_bits=1024): 32 frames (8 distinct, each 4 times) through
   ``decode_batch`` along every path: jacobi with fuse="post", "full" and
   "none", faithful and specmap with "post", sequential with "full", and
   the frames' luma as a grayscale batch with "post" and "none". Every
   launch count is set to 0 just before each path and read just after;
   coefficients equal the plain path's on the card, RGB within 1, and
   each path launched exactly its kernels. Then each path's warm decode
   time, sync rounds and host checks, and a profile of its device time.

The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
F32_FLOP_PER_S = 67e12        # f32 outside the tensor cores (FMA = 2 FLOP)
# 32-bit lane instructions per second: one per f32 lane per clock, i.e. the
# f32 FMA peak counted as one operation
INT_OPS_PER_S = F32_FLOP_PER_S / 2
# integer operations per Huffman symbol step, counted from huffman.cuh's
# symbol_step (window, LUT lookup, magnitude, state update); a low count,
# so the bound stays a lower bound
OPS_PER_SYMBOL_STEP = 40


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def synth_frame(rng, width: int, height: int, t: float) -> np.ndarray:
    """A photograph-like RGB frame: smooth illumination, oriented textures
    and film grain; `t` slides the phases like consecutive video frames."""
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    xn, yn = xx / width, yy / height
    base = 120 + 60 * np.sin(2.2 * xn + 0.7 * t) * np.cos(1.7 * yn - 0.3 * t)
    tex = np.zeros_like(base)
    for k in range(4):
        fx = 2 ** (k + 2) * np.pi
        ang = 0.6 * k + 0.2 * t
        tex += (18.0 / (k + 1)) * np.sin(
            fx * (xn * np.cos(ang) + yn * np.sin(ang)) + 3.1 * t)
    luma = base + tex + rng.normal(0, 6.0, size=(height, width))
    cb = 16 * np.sin(3.1 * xn + t) + 10 * np.cos(2.3 * yn)
    cr = 14 * np.cos(2.7 * xn - 0.5 * t) + 9 * np.sin(3.7 * yn + t)
    rgb = np.stack([luma + 1.402 * cr, luma - 0.344 * cb - 0.714 * cr,
                    luma + 1.772 * cb], axis=-1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def luma(rgb: np.ndarray) -> np.ndarray:
    """BT.601 luma of an RGB frame, as uint8."""
    y = rgb.astype(np.float64) @ np.array([0.299, 0.587, 0.114])
    return np.clip(np.round(y), 0, 255).astype(np.uint8)


# device clocks the card spins before each timed call (about 1 ms), so that
# the host has queued the call by the time the start event fires and the
# wrapper's host time is not counted as the kernel's
SPIN_CYCLES = 2_000_000


def event_ms(fn) -> float:
    """Device time of one call of ``fn`` in ms, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def cuda_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` in ms, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    return statistics.median(event_ms(fn) for _ in range(reps))


def max_err(got, exp) -> int:
    """Largest absolute difference over pairs of tensors."""
    return max(int((g.to(torch.int64) - e.to(torch.int64)).abs().max())
               if g.numel() else 0 for g, e in zip(got, exp))


def device_us(event) -> float:
    """Self device time of a profiler row, in us (the name changed across
    torch versions)."""
    t = getattr(event, "self_device_time_total", None)
    return t if t is not None else event.self_cuda_time_total


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved: int, ops: float, ops_per_s: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--quality", type=int, default=95)
    ap.add_argument("--distinct", type=int, default=8)
    ap.add_argument("--repeat", type=int, default=4)
    ap.add_argument("--chunk-bits", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs on the card only")
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        fail(f"the repro_torch package is missing under {SRC}")
    sys.path.insert(0, str(SRC))

    from repro_torch import decode_batch
    from repro_torch.core import decode as D
    from repro_torch.core.api import ParallelDecoder
    from repro_torch.core import sync as SY
    from repro_torch.core.state import DecodeState
    from repro_torch.core.sync import chain_entries, jacobi_sync
    from repro_torch.jpeg import codec_ref as cr
    from repro_torch.kernels import build
    from repro_torch.kernels.color import ops as CK
    from repro_torch.kernels.fused import pixels as FP
    from repro_torch.kernels.fused import store as FS
    from repro_torch.kernels.huffman import ops as HK
    from repro_torch.kernels.idct import ops as IK

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = torch.device("cuda")

    # -- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    report = build.build_all()
    for name, (secs, log) in report.items():
        print(f"[build] {name}.cu: {secs:.1f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build]   {line.strip()}")
    for name in build.SOURCES:
        build.load(name)
    print(f"[build] all kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # -- the full-width batch -----------------------------------------------
    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed)
    frames = [synth_frame(rng, args.width, args.height, t=0.13 * i)
              for i in range(args.distinct)]
    distinct = [cr.encode_baseline(f, quality=args.quality,
                                   subsampling="4:2:0").jpeg_bytes
                for f in frames]
    blobs = [b for b in distinct for _ in range(args.repeat)]
    mb = sum(map(len, blobs)) / 1e6
    print(f"[data] {len(blobs)} frames {args.width}x{args.height} 4:2:0 "
          f"q{args.quality} ({args.distinct} distinct), {mb:.1f} MB "
          f"compressed, encoded in {time.perf_counter() - t0:.1f} s",
          flush=True)
    # the grayscale batch: the same frames' luma, same size and quality
    t0 = time.perf_counter()
    gray_distinct = [cr.encode_baseline(luma(f), quality=args.quality)
                     .jpeg_bytes for f in frames]
    gray_blobs = [b for b in gray_distinct for _ in range(args.repeat)]
    del frames
    print(f"[data] grayscale: {len(gray_blobs)} frames, "
          f"{sum(map(len, gray_blobs)) / 1e6:.1f} MB compressed, encoded "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    dec = ParallelDecoder.from_bytes(blobs, chunk_bits=args.chunk_bits,
                                     device=gpu)
    torch.cuda.synchronize()
    sh, dev = dec.shape, dec.dev
    print(f"[data] plan: {dec.plan.n_chunks} chunk lanes (capacity "
          f"{sh.n_chunks}), s_max {sh.s_max}, {dec.plan.total_units} units "
          f"(capacity {sh.n_units}); parsed, planned and copied in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # -- 2. kernel parity and timing on the full-width plan -------------------
    meta = D.chunk_meta(dev)
    kw = dict(s_max=sh.s_max, min_code_bits=sh.min_code_bits)
    cold = DecodeState.cold(dev["chunk_start"])
    kernels = []

    def record(name, source, replaces, err, ms, plain_ms, bytes_moved, ops,
               ops_per_s, library_ms=None):
        b_ms, b_by = bound(bytes_moved, ops, ops_per_s)
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=0,
                            max_abs_err=float(err), ms=ms, plain_ms=plain_ms,
                            bound_ms=b_ms, bound_by=b_by,
                            library_ms=library_ms))
        lib = "" if library_ms is None else f", library {library_ms:.4f} ms"
        print(f"[parity] {name}: max_abs_err {err}, {ms:.4f} ms (plain "
              f"{plain_ms:.2f} ms, bound {b_ms:.4f} ms by {b_by}{lib})",
              flush=True)

    def exits_plain(d, entry):
        return HK.decode_exits_plain(d, meta, entry, **kw)

    res = jacobi_sync(dev, max_rounds=sh.n_chunks + 2,
                      decode_exits=lambda d, e: HK.decode_exits(d, meta, e,
                                                                **kw),
                      permuted=sh.permuted)
    check(res.converged, "kernel Jacobi sync did not converge")
    entries = chain_entries(dev, res.exits, sh.permuted)
    # the exit kernel with its tables in shared memory (the wrapper's
    # budget) and, with a budget of 0, read from global memory
    table_bytes = HK.exit_table_bytes(dev)
    check(table_bytes <= HK.EXIT_SMEM_BUDGET, f"the exit kernel's tables "
          f"({table_bytes} bytes) do not fit its shared-memory budget")
    errs = {}
    for label, entry in (("cold", cold), ("chained", entries)):
        exp = exits_plain(dev, entry)
        for where, got in (
                ("shared", HK.decode_exits(dev, meta, entry, **kw)),
                ("global", HK.run_exit_kernel(dev, meta, entry, **kw,
                                              smem_budget=0))):
            torch.cuda.synchronize()
            errs[label, where] = max_err(got, exp)
            check(errs[label, where] == 0, f"exit kernel ({where} tables) "
                  f"differs from its plain version by "
                  f"{errs[label, where]} ({label} entries)")
    print(f"[parity] exit kernel: shared-memory and global tables "
          f"bit-identical to the plain version on cold and chained "
          f"entries; tables {table_bytes} bytes", flush=True)
    # the write pass inputs, from the converged exits
    bases = D.chunk_write_bases(dev, res.exits.n, permuted=sh.permuted)
    seg_end = torch.cat([dev["seg_coeff_base"][1:], dev["units_end"][None]])
    write_max = seg_end[dev["chunk_seg"].to(torch.int64)] - 1
    n_coef = sh.n_units * 64
    pos, val = HK.decode_streams(dev, meta, entries, **kw)
    pos_p, val_p = HK.decode_streams_plain(dev, meta, entries, **kw)
    torch.cuda.synchronize()
    stream_err = max_err((pos, val), (pos_p, val_p))
    check(stream_err == 0, f"stream kernel differs from its plain version "
          f"by {stream_err}")
    lane_steps = (pos >= 0).sum(0)  # symbol steps each lane's data needs
    steps = int(lane_steps.sum())
    del pos_p, val_p
    lane_in = [meta[k] for k in ("word_base", "ts", "limit", "upm")] + \
        list(entries[:3])
    tables = [dev["words"], dev["luts"], dev["unit_lut_row"]]
    # the exit kernel reads its compact tables in place of the LUTs
    exit_tables = [dev["words"], dev["luts_compact"], dev["unit_lut_off"]]
    ms = cuda_ms(lambda: HK.decode_exits(dev, meta, entries, **kw),
                 args.reps)
    plain_ms = cuda_ms(lambda: exits_plain(dev, entries), 1)
    record("huffman_exits", "src/repro_torch/kernels/csrc/huffman.cu",
           "src/repro/kernels/huffman/huffman.py:261", max(errs.values()),
           ms, plain_ms,
           nbytes(*exit_tables, *lane_in) + 4 * 4 * entries.p.numel(),
           steps * OPS_PER_SYMBOL_STEP, INT_OPS_PER_S)
    ms = cuda_ms(lambda: HK.decode_streams(dev, meta, entries, **kw),
                 args.reps)
    plain_ms = cuda_ms(
        lambda: HK.decode_streams_plain(dev, meta, entries, **kw), 1)
    record("huffman_streams", "src/repro_torch/kernels/csrc/huffman.cu",
           "src/repro/kernels/huffman/huffman.py:332", stream_err, ms,
           plain_ms,
           nbytes(*tables, *lane_in, pos, val),
           steps * OPS_PER_SYMBOL_STEP, INT_OPS_PER_S)
    coef_stream = HK.scatter_streams(pos, val, bases, write_max, n_coef)
    del pos, val
    coef = FS.decode_coeffs_store(dev, meta, entries, bases, write_max,
                                  n_coef, **kw)
    coef_p = FS.decode_coeffs_store_plain(dev, meta, entries, bases,
                                          write_max, n_coef, **kw)
    torch.cuda.synchronize()
    store_err = max_err((coef,), (coef_p,))
    check(store_err == 0, f"store kernel differs from its plain version by "
          f"{store_err}")
    check(torch.equal(coef_stream, coef_p), "stream kernel + scatter "
          "differs from the plain write pass")
    del coef_stream, coef_p
    ms = cuda_ms(lambda: FS.decode_coeffs_store(
        dev, meta, entries, bases, write_max, n_coef, **kw), args.reps)
    plain_ms = cuda_ms(lambda: FS.decode_coeffs_store_plain(
        dev, meta, entries, bases, write_max, n_coef, **kw), 1)
    record("huffman_store", "src/repro_torch/kernels/csrc/huffman.cu",
           "src/repro/kernels/fused/store.py:150", store_err, ms, plain_ms,
           nbytes(*tables, *lane_in, bases, write_max, coef),
           steps * OPS_PER_SYMBOL_STEP, INT_OPS_PER_S)

    # the exit kernel's idx form (faithful's decode_at): a seeded random
    # half of the lanes, each with its converged entry
    gen = torch.Generator().manual_seed(args.seed)
    idx = torch.randperm(sh.n_chunks, generator=gen)[:sh.n_chunks // 2]
    idx = idx.to(torch.int32).to(dev["chunk_start"].device)
    sub = DecodeState(*(f[idx.long()] for f in entries))
    exp = HK.decode_exits_plain(dev, meta, sub, idx, **kw)
    err = 0
    for where, got in (
            ("shared", HK.decode_exits(dev, meta, sub, idx, **kw)),
            ("global", HK.run_exit_kernel(dev, meta, sub, idx, **kw,
                                          smem_budget=0))):
        torch.cuda.synchronize()
        err = max(err, max_err(got, exp))
        check(err == 0, f"exit kernel ({where} tables) at a lane subset "
              f"differs from its plain version by {err}")
    ms = cuda_ms(lambda: HK.decode_exits(dev, meta, sub, idx, **kw),
                 args.reps)
    plain_ms = cuda_ms(lambda: HK.decode_exits_plain(dev, meta, sub, idx,
                                                     **kw), 1)
    sub_in = list(HK.lane_subset(meta, idx).values()) + list(sub[:3])
    record("huffman_exits_idx", "src/repro_torch/kernels/csrc/huffman.cu",
           "src/repro/kernels/huffman/huffman.py:261", err, ms, plain_ms,
           nbytes(*exit_tables, idx, *sub_in) + 4 * 4 * idx.numel(),
           int(lane_steps[idx.long()].sum()) * OPS_PER_SYMBOL_STEP,
           INT_OPS_PER_S)
    del got, exp, sub, sub_in, idx, lane_steps

    g = dec.plan.geometry
    units = D.undiff_dc(dev, coef.reshape(sh.n_units, 64))
    units = units[:dec.plan.total_units]
    mrow = dev["unit_mrow"][:dec.plan.total_units]
    del coef
    geo = dict(comp_h=tuple(g.comp_h), comp_v=tuple(g.comp_v),
               h_max=g.h_max, v_max=g.v_max, upm=g.units_per_mcu)
    blk = FP.fused_pixels(units, dev["m_matrices_t"], mrow, **geo)
    blk_p = FP.fused_pixels_plain(units, dev["m_matrices_t"], mrow, **geo)
    torch.cuda.synchronize()
    diff = (blk.to(torch.int16) - blk_p.to(torch.int16)).abs()
    err = int(diff.max())
    print(f"[parity] pixel kernel: {int((diff == 1).sum())} samples off by "
          f"one, max {err}")
    check(err <= 1, f"pixel kernel differs from its plain version by {err}")
    ms = cuda_ms(lambda: FP.fused_pixels(units, dev["m_matrices_t"], mrow,
                                         **geo), args.reps)
    plain_ms = cuda_ms(lambda: FP.fused_pixels_plain(
        units, dev["m_matrices_t"], mrow, **geo), 1)
    record("fused_pixels", "src/repro_torch/kernels/csrc/pixels.cu",
           "src/repro/kernels/fused/pixels.py:164", err, ms, plain_ms,
           nbytes(units, mrow, dev["m_matrices_t"], blk),
           2 * units.shape[0] * 64 * 64, F32_FLOP_PER_S)
    del blk, blk_p

    # the unfused chain: IDCT kernel, plane assembly, color kernel
    m_t = dev["m_matrices_t"]
    upm = g.units_per_mcu
    pix = IK.idct_units(units, m_t, mrow, upm)
    pix_p = IK.idct_units_plain(units, m_t, mrow)
    torch.cuda.synchronize()
    err = float((pix - pix_p).abs().max())
    check(torch.equal(pix, pix_p), f"IDCT kernel differs from its plain "
          f"version by {err}")
    # a partial last tile (the units' last 2 tiles + 5); a thread's units
    # taken 1 apart, so that most of them mix matrices; and the matrices
    # read from global memory (six, more than the kernel stages)
    n_tail = 2 * IK.tile_units(upm) + 5
    for n in (n_tail, 5):
        tail = (units[-n:], m_t, mrow[-n:])
        check(torch.equal(IK.idct_units(*tail, upm),
                          IK.idct_units_plain(*tail)),
              f"IDCT kernel differs from its plain version on {n} units")
    check(torch.equal(IK.idct_units(units, m_t, mrow, 1), pix_p),
          "IDCT kernel with mixed matrices differs from its plain version")
    m_t6 = m_t.repeat(6 // m_t.shape[0] + 1, 1, 1)[:6].contiguous()
    pix6 = IK.idct_units(units, m_t6, mrow, upm)
    check(torch.equal(pix6, IK.idct_units_plain(units, m_t6, mrow)),
          "IDCT kernel with six matrices differs from its plain version")
    del pix6
    ms1 = cuda_ms(lambda: IK.idct_units(units, m_t, mrow, 1), args.reps)
    ms6 = cuda_ms(lambda: IK.idct_units(units, m_t6, mrow, upm), args.reps)
    ms = cuda_ms(lambda: IK.idct_units(units, m_t, mrow, upm), args.reps)
    # the floor of a bit-identical product: each multiply-add is a
    # separate f32 multiply and add, one instruction per lane per clock
    floor_ms = 2 * units.shape[0] * 64 * 64 / INT_OPS_PER_S * 1e3
    print(f"[parity] IDCT kernel: equal on {units.shape[0]} units, on "
          f"{n_tail} and 5 units (partial last tiles), with units mixing "
          f"matrices ({ms1:.4f} ms) and with six matrices read from global "
          f"memory ({ms6:.4f} ms); bit-identical floor {floor_ms:.4f} ms",
          flush=True)
    plain_ms = cuda_ms(lambda: IK.idct_units_plain(units, m_t, mrow), 1)
    # the library yardstick: the product alone, one torch.matmul per
    # distinct matrix over all units (f32, TF32 off), no select or round
    x = units.to(torch.float32)
    nq = dec.plan.m_matrices.shape[0]
    lib_ms = cuda_ms(lambda: [torch.matmul(x, m_t[q]) for q in range(nq)],
                     args.reps)
    del x, pix_p
    record("idct", "src/repro_torch/kernels/csrc/idct.cu",
           "src/repro/kernels/idct/idct.py:75", err, ms, plain_ms,
           nbytes(units, mrow, m_t, pix), 2 * units.shape[0] * 64 * 64,
           F32_FLOP_PER_S, library_ms=lib_ms)
    comp_grid = [(g.mcus_y * v, g.mcus_x * h)
                 for h, v in zip(g.comp_h, g.comp_v)]
    planes = D.assemble_planes(pix, dec.plan.n_images, dec._comp_unit_idx,
                               dec._comp_block_idx, comp_grid)
    cgeo = (g.comp_h, g.comp_v, g.h_max, g.v_max, g.height, g.width)
    rgb = CK.upsample_color(planes, *cgeo)
    rgb_p = CK.upsample_color_plain(planes, *cgeo)
    torch.cuda.synchronize()
    diff = (rgb.to(torch.int16) - rgb_p.to(torch.int16)).abs()
    err = int(diff.max())
    print(f"[parity] color kernel: {int((diff == 1).sum())} samples off by "
          f"one, max {err}")
    check(err <= 1, f"color kernel differs from its plain version by {err}")
    ms = cuda_ms(lambda: CK.upsample_color(planes, *cgeo), args.reps)
    plain_ms = cuda_ms(lambda: CK.upsample_color_plain(planes, *cgeo), 1)
    # bytes: only the samples the cropped image reads (the planes are
    # padded to the MCU grid), each once, and the RGB written once;
    # per pixel: 2 subtractions, 4 multiplies, 4 adds/subtracts
    read = sum(rgb.shape[0] * -(-g.height // (g.v_max // v))
               * -(-g.width // (g.h_max // h)) * p.element_size()
               for p, h, v in zip(planes, g.comp_h, g.comp_v))
    record("color", "src/repro_torch/kernels/csrc/color.cu",
           "src/repro/kernels/color/color.py:74", err, ms, plain_ms,
           read + nbytes(rgb), 10 * rgb.numel() // 3, F32_FLOP_PER_S)
    del units, pix, planes, rgb, rgb_p, diff, dec, dev, meta, entries, res
    torch.cuda.empty_cache()

    # -- 3. small images against the sequential oracle ------------------------
    # every (sync, fuse) the decoder takes, on the kernels
    runs = [("jacobi", "post"), ("jacobi", "full"), ("jacobi", "none"),
            ("faithful", "post"), ("specmap", "post"),
            ("sequential", "post")]

    def check_flags(out, fuse, gray, what):
        unfused = fuse == "none" or gray
        check(out.store_fused == (fuse == "full")
              and out.pixels_fused != unfused and out.idct_kernel == unfused
              and out.color_kernel == (unfused and not gray),
              f"{what} did not run its kernels")

    small = np.random.default_rng(args.seed + 1)
    frames = [synth_frame(small, 64, 48, t=0.5 * i) for i in range(5)]
    groups = [
        [cr.encode_baseline(frames[0], quality=70).jpeg_bytes,
         cr.encode_baseline(frames[1], quality=90).jpeg_bytes,
         cr.encode_baseline(frames[2], quality=90,
                            restart_interval=2).jpeg_bytes,
         cr.encode_baseline(frames[3], quality=85,
                            optimize_huffman=True).jpeg_bytes],
        [cr.encode_baseline(frames[4], quality=85,
                            subsampling="4:4:4").jpeg_bytes],
        [cr.encode_baseline(luma(frames[0]), quality=80).jpeg_bytes,
         cr.encode_baseline(luma(frames[1]), quality=95,
                            restart_interval=3).jpeg_bytes],
    ]
    for blobs_s in groups:
        exp = np.concatenate([cr.undiff_dc(img, cr.decode_coefficients(img))
                              for img in map(cr.parse_jpeg, blobs_s)])
        base = np.stack([cr.decode_baseline(b) for b in blobs_s])
        gray = base.ndim == 3
        kind = "grayscale" if gray else "color"
        for sync, fuse in runs:
            what = f"{len(blobs_s)} {kind} images, sync={sync} fuse={fuse}"
            out = decode_batch(blobs_s, chunk_bits=256, sync=sync, fuse=fuse)
            check_flags(out, fuse, gray, what)
            check(out.converged, f"{what}: did not converge")
            check(np.array_equal(out.coeffs.cpu().numpy(), exp),
                  f"{what}: coefficients differ from the oracle")
            d = np.abs(out.rgb.cpu().numpy().astype(int) - base.astype(int))
            check(d.max() <= 1, f"{what}: RGB differs from the oracle by "
                  f"{d.max()}")
            print(f"[oracle] {what}: coefficients equal, RGB max diff "
                  f"{d.max()} ({int((d == 1).sum())} samples off by one), "
                  f"{out.sync_rounds} rounds", flush=True)

    # -- 4. every path at full width -----------------------------------------
    counters = {"huffman_exits": (HK.decode_exits, "launches"),
                "huffman_streams": (HK.decode_streams, "launches"),
                "huffman_store": (FS.decode_coeffs_store, "launches"),
                "huffman_exits_idx": (HK.decode_exits, "subset_launches"),
                "fused_pixels": (FP.fused_pixels, "launches"),
                "idct": (IK.idct_units, "launches"),
                "color": (CK.upsample_color, "launches")}
    check(set(counters) == {r["name"] for r in kernels}, "a kernel record "
          "has no launch counter")
    exits, streams, store = "huffman_exits", "huffman_streams", "huffman_store"
    # (label, grayscale batch, sync, fuse, the kernels the path launches)
    paths = [
        ("jacobi/post", False, "jacobi", "post",
         {exits, streams, "fused_pixels"}),
        ("jacobi/full", False, "jacobi", "full",
         {exits, store, "fused_pixels"}),
        ("jacobi/none", False, "jacobi", "none",
         {exits, streams, "idct", "color"}),
        ("faithful/post", False, "faithful", "post",
         {exits, "huffman_exits_idx", streams, "fused_pixels"}),
        ("specmap/post", False, "specmap", "post",
         {exits, streams, "fused_pixels"}),
        ("sequential/full", False, "sequential", "full",
         {exits, store, "fused_pixels"}),
        ("gray jacobi/post", True, "jacobi", "post", {exits, streams, "idct"}),
        ("gray jacobi/none", True, "jacobi", "none", {exits, streams, "idct"}),
    ]
    batches = {False: blobs, True: gray_blobs}
    # the plain path on the card, one per batch: what every path must equal
    plain = {gray: decode_batch(b, chunk_bits=args.chunk_bits,
                                backend="torch", device=gpu)
             for gray, b in batches.items()}
    check(all(p.converged for p in plain.values()),
          "the plain path did not converge")
    sync_stats = {}
    for label, gray, sync, fuse, expect in paths:
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        SY.host_check.count = 0
        out = decode_batch(batches[gray], chunk_bits=args.chunk_bits,
                           sync=sync, fuse=fuse)
        torch.cuda.synchronize()
        counts = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
        checks = SY.host_check.count
        for rec in kernels:
            rec["launches"] += counts[rec["name"]]
        launched = {k for k, n in counts.items() if n > 0}
        print(f"[main] {label}: launches " + ", ".join(
            f"{k} {n}" for k, n in counts.items() if n), flush=True)
        check(launched == expect, f"{label} launched {sorted(launched)}, "
              f"expected {sorted(expect)}")
        check_flags(out, fuse, gray, label)
        ref = plain[gray]
        check(out.converged, f"{label}: did not converge")
        check(sync != "jacobi" or out.sync_rounds == ref.sync_rounds,
              f"{label}: sync_rounds {out.sync_rounds} != plain "
              f"{ref.sync_rounds}")
        check(torch.equal(out.coeffs, ref.coeffs),
              f"{label}: coefficients differ from the plain path")
        shape = (len(blobs), args.height, args.width) + (() if gray else (3,))
        check(tuple(out.rgb.shape) == shape,
              f"{label}: rgb shape {tuple(out.rgb.shape)}")
        d = (out.rgb.to(torch.int16) - ref.rgb.to(torch.int16)).abs()
        check(int(d.max()) <= 1, f"{label}: RGB differs from the plain path "
              f"by {int(d.max())}")
        sync_stats[label] = (out.sync_rounds, checks)
        print(f"[main] {label}: coefficients equal the plain path; "
              f"{out.sync_rounds} sync rounds (plain jacobi "
              f"{ref.sync_rounds}), {checks} host checks; RGB max diff "
              f"{int(d.max())} ({int((d == 1).sum())} samples off by one)",
              flush=True)
        del out, d
    check(all(r["launches"] > 0 for r in kernels), "a kernel of the main "
          "path was never launched")
    del plain
    torch.cuda.empty_cache()

    planned_ms = {}
    for label, gray, sync, fuse, _ in paths:
        main_path = label in ("jacobi/post", "jacobi/full")
        batch = batches[gray]
        dec = ParallelDecoder.from_bytes(batch, chunk_bits=args.chunk_bits,
                                         sync=sync, fuse=fuse)
        device_ms = []
        runs_n = args.reps + 1 if main_path else max(2, args.reps // 2) + 1
        for _ in range(runs_n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dec.decode()
            torch.cuda.synchronize()
            device_ms.append((time.perf_counter() - t0) * 1e3)
        del dec
        med = planned_ms[label] = statistics.median(device_ms[1:])
        mbx = sum(map(len, batch)) / 1e6
        rounds, checks = sync_stats[label]
        line = (f"[main] {label}: warm decode of a planned batch "
                f"{med:.2f} ms median ({len(batch) / med * 1e3:.1f} images/s, "
                f"{mbx / med * 1e3:.1f} MB/s compressed), {rounds} sync "
                f"rounds, {checks} host checks")
        if main_path:
            e2e_ms = []
            for _ in range(max(2, args.reps // 2)):
                t0 = time.perf_counter()
                decode_batch(batch, chunk_bits=args.chunk_bits, fuse=fuse)
                torch.cuda.synchronize()
                e2e_ms.append((time.perf_counter() - t0) * 1e3)
            e2e = statistics.median(e2e_ms)
            line += (f"; decode_batch from bytes {e2e:.1f} ms "
                     f"({len(batch) / e2e * 1e3:.1f} images/s)")
        print(line, flush=True)

    # where the device time of one warm planned decode goes: the kernels'
    # own rows of the profile (the rows of the aten ops that launched them
    # repeat their time), against the unprofiled median wall time above
    for label, gray, sync, fuse, _ in paths:
        dec = ParallelDecoder.from_bytes(batches[gray],
                                         chunk_bits=args.chunk_bits,
                                         sync=sync, fuse=fuse)
        dec.decode()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            dec.decode()
            torch.cuda.synchronize()
        rows = [(e.key, device_us(e) / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and device_us(e) > 0]
        busy = sum(r[1] for r in rows)
        if busy:
            wall = planned_ms[label]
            print(f"[profile] {label} planned decode: device busy "
                  f"{busy:.2f} ms of {wall:.2f} ms wall, idle share "
                  f"{max(0.0, 1 - busy / wall):.3f}")
            for key, ms, n in sorted(rows, key=lambda r: -r[1])[:8]:
                print(f"[profile]   {ms:9.3f} ms {n:5d}x  {key[:100]}")
        else:
            print(f"[profile] {label}: the profiler saw no device time: "
                  f"not measured")
        del dec

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
