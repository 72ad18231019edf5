#!/usr/bin/env python3
"""Kernel times of one or more checkouts of this package, by one method.

Run as a file from the root of a checkout, on a machine with one card::

    python3 src/repro_torch/tools/kernel_times.py \\
        --tree parent=build/parent/src --tree change=src \\
        [--exit-threads 128,256,512] [--scatter-parts] \\
        [--stream-variants "kStreamThreads=256;kStreamBarrierRows=8"] \\
        [--store-variants "kStoreThreads=128;kStoreThreads=512"] \\
        [--color-variants "kColorRun=16;kRowsY=4"]

Each ``--tree LABEL=DIR`` loads ``DIR/repro_torch`` under a name of its
own (its kernels build into that checkout's ``build/``), plans the same
batch as ``chip_smoke.py`` (the ``newyork`` setting: 32 x 1920x1080 4:2:0
q95, chunk_bits 1024, from ``--seed``) and times every kernel on the same
inputs as ``chip_smoke.py``'s phase 2: the exit kernel on the converged
entries (all lanes, and the ``idx`` form at a seeded random half; where
the tree's exit or stream kernel has a global-table form, that too), the
stream and store kernels, the torch scatter after the stream kernel
(``scatter_streams``, on the tree's own streams), the fused pixel
kernel, the IDCT kernel (with the batch's layout hint where the tree's
wrapper takes one), its library yardstick (``torch.matmul``, TF32 off)
and the color kernel. Every time is
``chip_smoke.event_ms``'s (the card spins before each call, so the
wrapper's host time is not counted), and the trees take turns call by
call, so that a drift of the card's clock falls on all of them alike.
Each kernel must give the same output in every tree.

``--exit-threads`` also builds this checkout's ``csrc/huffman.cu`` once
per block size, with ``kExitThreads`` set to it, times each build's exit
kernel in the same turns (tables in shared memory) and prints the blocks
an SM holds at that size (the CUDA occupancy calculator).
``--stream-variants`` does the same for the stream kernel, one build per
';'-separated spec of other values of constants of ``huffman.cu`` (say
``kStreamThreads=512,kStreamBarrierRows=4``), and times a plain fill of
the streams' bytes beside them; ``--store-variants`` for the store kernel
(``kStoreThreads``),
``--color-variants`` for the color kernel (constants of ``csrc/color.cu``,
say ``kColorRun=16,kRowsY=4``). ``--scatter-parts`` profiles one call of
each tree's scatter, printing its device time by kernel: the elementwise
passes and the ``index_put``.

The line before the last is the card's name and power limit; the last is
one JSON object with every median time in ms.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import importlib.util
import inspect
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[3]

# a variant build of a kernel source: kind -> (source, block-size
# expression, kernel, its dynamic shared memory besides the tables, entry
# point); the variant appends the kernel's blocks per SM
VARIANTS = {
    "exit": ("huffman", "kExitThreads", "exits_kernel<true>", "0",
             "rt_decode_exits"),
    "stream": ("huffman", "kStreamThreads", "streams_kernel<true>", "0",
               "rt_decode_streams"),
    "store": ("huffman", "kStoreThreads", "store_kernel<true, true>",
              "kStoreSlotBytes", "rt_decode_store"),
    "color": ("color", "kRunsX * kRowsY", "color_kernel<2, 2>", "0",
              "rt_upsample_color"),
}
_OCCUPANCY = """
extern "C" int kt_blocks_per_sm(int smem_bytes) {{
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, {kernel}, {threads}, {extra} + smem_bytes);
  return err == cudaSuccess ? blocks : -(int)err;
}}
"""


def load_tree(label: str, src: Path):
    """``src/repro_torch`` imported as the package ``_kt_<label>``."""
    name = f"_kt_{label}"
    init = src / "repro_torch" / "__init__.py"
    if not init.is_file():
        raise SystemExit(f"no repro_torch package under {src}")
    spec = importlib.util.spec_from_file_location(
        name, init, submodule_search_locations=[str(init.parent)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[name] = pkg
    spec.loader.exec_module(pkg)
    return name


def tree_kernels(pkg: str, blobs, args, gpu):
    """{kernel: a call of it} on one tree's plan of ``blobs``, and the
    kernels' operands for the variant builds."""
    mod = lambda m: importlib.import_module(f"{pkg}.{m}")  # noqa: E731
    api, D, SY = mod("core.api"), mod("core.decode"), mod("core.sync")
    DecodeState = mod("core.state").DecodeState
    HK, FS = mod("kernels.huffman.ops"), mod("kernels.fused.store")
    FP, IK = mod("kernels.fused.pixels"), mod("kernels.idct.ops")
    CK = mod("kernels.color.ops")
    dec = api.ParallelDecoder.from_bytes(blobs, chunk_bits=args.chunk_bits,
                                         device=gpu)
    sh, dev, plan = dec.shape, dec.dev, dec.plan
    meta = D.chunk_meta(dev)
    kw = dict(s_max=sh.s_max, min_code_bits=sh.min_code_bits)
    res = SY.jacobi_sync(dev, max_rounds=sh.n_chunks + 2,
                         decode_exits=lambda d, e: HK.decode_exits(
                             d, meta, e, **kw), permuted=sh.permuted)
    if not res.converged:
        raise SystemExit(f"{pkg}: the Jacobi sync did not converge")
    entries = SY.chain_entries(dev, res.exits, sh.permuted)
    bases = D.chunk_write_bases(dev, res.exits.n, permuted=sh.permuted)
    seg_end = torch.cat([dev["seg_coeff_base"][1:], dev["units_end"][None]])
    write_max = seg_end[dev["chunk_seg"].to(torch.int64)] - 1
    n_coef = sh.n_units * 64
    gen = torch.Generator().manual_seed(args.seed)
    idx = torch.randperm(sh.n_chunks, generator=gen)[:sh.n_chunks // 2]
    idx = idx.to(torch.int32).to(gpu)
    sub = DecodeState(*(f[idx.long()] for f in entries))
    units = dec.coefficients().coeffs
    mrow = dev["unit_mrow"][:plan.total_units]
    m_t = dev["m_matrices_t"]
    g = plan.geometry
    geo = dict(comp_h=tuple(g.comp_h), comp_v=tuple(g.comp_v),
               h_max=g.h_max, v_max=g.v_max, upm=g.units_per_mcu)
    # the IDCT wrapper's layout hint, where the tree has one
    hint = ({"units_per_mcu": g.units_per_mcu}
            if "units_per_mcu" in inspect.signature(IK.idct_units).parameters
            else {})
    pix = IK.idct_units(units, m_t, mrow, **hint)
    pos, val = HK.decode_streams(dev, meta, entries, **kw)
    comp_grid = [(g.mcus_y * v, g.mcus_x * h)
                 for h, v in zip(g.comp_h, g.comp_v)]
    planes = D.assemble_planes(pix, plan.n_images, dec._comp_unit_idx,
                               dec._comp_block_idx, comp_grid)
    cgeo = (g.comp_h, g.comp_v, g.h_max, g.v_max, g.height, g.width)
    fns = {
        "huffman_exits": lambda: HK.decode_exits(dev, meta, entries, **kw),
        "huffman_exits_idx": lambda: HK.decode_exits(dev, meta, sub, idx,
                                                     **kw),
        "huffman_streams": lambda: HK.decode_streams(dev, meta, entries,
                                                     **kw),
        "scatter": lambda: HK.scatter_streams(pos, val, bases, write_max,
                                              n_coef),
        "huffman_store": lambda: FS.decode_coeffs_store(
            dev, meta, entries, bases, write_max, n_coef, **kw),
        "fused_pixels": lambda: FP.fused_pixels(units, m_t, mrow, **geo),
        "idct": lambda: IK.idct_units(units, m_t, mrow, **hint),
        "color": lambda: CK.upsample_color(planes, *cgeo),
    }
    if hasattr(HK, "run_exit_kernel"):  # its tables read from global memory
        fns["huffman_exits_global"] = lambda: HK.run_exit_kernel(
            dev, meta, entries, **kw, smem_budget=0)
    if hasattr(HK, "run_stream_kernel"):
        fns["huffman_streams_global"] = lambda: HK.run_stream_kernel(
            dev, meta, entries, **kw, smem_budget=0)
    if hasattr(FS, "run_store_kernel"):
        fns["huffman_store_global"] = lambda: FS.run_store_kernel(
            dev, meta, entries, bases, write_max, n_coef, **kw,
            smem_budget=0)
    x = units.to(torch.float32)
    library = lambda: [torch.matmul(x, m_t[q])  # noqa: E731
                       for q in range(plan.m_matrices.shape[0])]
    ops = dict(HK=HK, CK=CK, dev=dev, meta=meta, entries=entries, kw=kw,
               bases=bases, write_max=write_max, n_coef=n_coef,
               planes=planes, cgeo=cgeo)
    return fns, library, ops


def build_variants(kind, specs, build):
    """This checkout's source of the ``kind`` kernel (``VARIANTS``) built
    once per spec, a {constant: value} dict: {label: loaded library}. The
    builds run at once."""
    source, threads, kernel, extra, _ = VARIANTS[kind]
    src = (build.CSRC / f"{source}.cu").read_text()
    out_dir = build.BUILD_DIR / f"{kind}_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, spec in enumerate(specs):
        text = src
        for const, value in spec.items():
            pattern = rf"constexpr int {const} = \d+;"
            if len(re.findall(pattern, text)) != 1:
                raise SystemExit(f"{source}.cu has no single {const} "
                                 f"constant")
            text = re.sub(pattern, f"constexpr int {const} = {value};", text)
        cu = out_dir / f"{source}_v{n}.cu"
        cu.write_text(text + _OCCUPANCY.format(kernel=kernel, threads=threads,
                                               extra=extra))
        so = out_dir / f"lib{source}_v{n}.so"
        label = ",".join(f"{k}={v}" for k, v in spec.items())
        procs[label] = (subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for label, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {kind} {label}:\n{log}")
        libs[label] = ctypes.CDLL(str(so))
    return libs


def variant_call(kind, lib, ops):
    """A call of a variant library's kernel on the tree's operands (the
    Huffman kernels' tables in shared memory, on the converged entries);
    returns (call, blocks per SM), the latter a function to call after the
    first call (which opts the kernel into its shared memory)."""
    HK, CK, kw = ops["HK"], ops["CK"], ops["kw"]
    name = VARIANTS[kind][4]
    fn = getattr(lib, name)
    fn.argtypes = CK._ARGS if kind == "color" else HK._SIGNATURES[name]
    fn.restype = ctypes.c_int
    occ = lib.kt_blocks_per_sm
    occ.argtypes, occ.restype = [ctypes.c_int], ctypes.c_int
    if kind == "color":
        planes, cgeo = ops["planes"], ops["cgeo"]
        fv, fh = CK._check(planes, *cgeo)
        height, width = cgeo[4], cgeo[5]
        ints3 = ctypes.c_int * 3
        n = planes[0].shape[0]

        def call():
            out = torch.empty((n, height, width, 3), dtype=torch.uint8,
                              device=planes[0].device)
            HK.B.check(fn(
                (ctypes.c_void_p * 3)(*(p.data_ptr() for p in planes)),
                ints3(*(p.shape[1] for p in planes)),
                ints3(*(p.shape[2] for p in planes)), ints3(*fv),
                ints3(*fh), HK.B.ptr(out), n, height, width,
                HK.B.stream_of(out)), name)
            return out

        return call, lambda: occ(0)
    dev, meta, entries = ops["dev"], ops["meta"], ops["entries"]
    args = HK.exit_args(dev, meta, entries)
    c = entries.p.shape[0]
    smem = HK.exit_table_bytes(dev)
    stream = HK.B.stream_of(entries.p)

    def call():
        if kind == "exit":
            out = [torch.empty_like(entries.p) for _ in range(4)]
        elif kind == "stream":
            out = [torch.empty((kw["s_max"], c), dtype=torch.int32,
                               device=entries.p.device) for _ in range(2)]
        else:
            out = [torch.zeros(ops["n_coef"], dtype=torch.int32,
                               device=entries.p.device)]
            err = fn(*args, HK.B.ptr(ops["bases"]),
                     HK.B.ptr(ops["write_max"]), HK.B.ptr(out[0]),
                     ops["n_coef"], c, kw["s_max"], kw["min_code_bits"],
                     smem, stream)
            HK.B.check(err, name)
            return tuple(out)
        err = fn(*args, *(HK.B.ptr(t) for t in out), c, kw["s_max"],
                 kw["min_code_bits"], smem, stream)
        HK.B.check(err, name)
        return tuple(out)

    return call, lambda: occ(smem)


def scatter_parts(fn) -> list:
    """Device time of one call of ``fn`` by kernel: [(name, ms, count)]."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        if e.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            rows.append((e.key, us / 1e3, e.count))
    return sorted(rows, key=lambda r: -r[1])


def flat(out):
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in flat(o)]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[],
                    metavar="LABEL=DIR", help="a checkout's src directory "
                    "(default: this checkout's, as 'this')")
    ap.add_argument("--exit-threads", default="",
                    help="block sizes of this checkout's exit kernel to "
                    "time, comma-separated")
    ap.add_argument("--stream-variants", default="",
                    help="builds of this checkout's stream kernel with other "
                    "constants of huffman.cu, ';'-separated specs of "
                    "comma-separated CONST=VALUE")
    ap.add_argument("--store-variants", default="",
                    help="builds of this checkout's store kernel with other "
                    "constants of huffman.cu, as --stream-variants")
    ap.add_argument("--color-variants", default="",
                    help="builds of this checkout's color kernel with other "
                    "constants of color.cu, as --stream-variants")
    ap.add_argument("--scatter-parts", action="store_true",
                    help="profile each tree's scatter by kernel")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--quality", type=int, default=95)
    ap.add_argument("--distinct", type=int, default=8)
    ap.add_argument("--repeat", type=int, default=4)
    ap.add_argument("--chunk-bits", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=21)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the kernels run on the card only")
    trees = [t.split("=", 1) for t in args.tree] or [["this", "src"]]
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = torch.device("cuda")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as CS  # the batch and the timing method

    pkgs = {label: load_tree(label, (ROOT / d).resolve())
            for label, d in trees}
    first = next(iter(pkgs.values()))
    cr = importlib.import_module(f"{first}.jpeg.codec_ref")
    rng = np.random.default_rng(args.seed)
    frames = [CS.synth_frame(rng, args.width, args.height, t=0.13 * i)
              for i in range(args.distinct)]
    distinct = [cr.encode_baseline(f, quality=args.quality,
                                   subsampling="4:2:0").jpeg_bytes
                for f in frames]
    blobs = [b for b in distinct for _ in range(args.repeat)]
    del frames

    # (kernel, tree, call)
    calls, outs, tree_ops, library = [], {}, {}, None
    for label, pkg in pkgs.items():
        fns, lib_call, tree_ops[label] = tree_kernels(pkg, blobs, args, gpu)
        library = library or lib_call
        for name, fn in fns.items():
            calls.append((name, label, fn))
            got = flat(fn())
            ref = outs.setdefault(name.removesuffix("_global"), got)
            if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                raise SystemExit(f"{name}: tree {label} gives another "
                                 f"output than tree {next(iter(pkgs))}")
    calls.append(("idct_library", "torch", library))
    occupancy = {}
    def parse(variants):
        return [dict(kv.split("=") for kv in v.split(","))
                for v in variants.split(";") if v]

    specs = {"exit": [{"kExitThreads": int(t)}
                      for t in args.exit_threads.split(",") if t],
             "stream": parse(args.stream_variants),
             "store": parse(args.store_variants),
             "color": parse(args.color_variants)}
    for kind, kind_specs in specs.items():
        if not kind_specs:
            continue
        this = [lb for lb, d in trees
                if (ROOT / d).resolve() == (ROOT / "src").resolve()]
        if not this:
            raise SystemExit(f"variants of the {kind} kernel need this "
                             f"checkout's src among the trees")
        build = importlib.import_module(f"{pkgs[this[0]]}.kernels.build")
        kernel = {"exit": "huffman_exits", "stream": "huffman_streams",
                  "store": "huffman_store", "color": "color"}[kind]
        ref = outs[kernel]
        for label, lib in build_variants(kind, kind_specs, build).items():
            call, blocks = variant_call(kind, lib, tree_ops[this[0]])
            if not all(torch.equal(a, b) for a, b in zip(flat(call()), ref)):
                raise SystemExit(f"the {kind} kernel {label} gives another "
                                 f"output")
            occupancy[f"{kind} {label}"] = blocks()
            calls.append((kernel, f"{this[0]} {label}", call))
        if kind == "stream":  # the streams' bytes written in order
            shape = ref[0].shape
            calls.append(("streams_fill", "torch", lambda: [
                torch.full(shape, f, dtype=torch.int32, device=gpu)
                for f in (-1, 0)]))
    del outs
    if args.scatter_parts:
        for name, label, fn in calls:
            if name != "scatter":
                continue
            label = f"{label} {name}"
            rows = scatter_parts(fn)
            total = sum(r[1] for r in rows)
            print(f"[scatter] {label}: device {total:.4f} ms in "
                  f"{sum(r[2] for r in rows)} kernels", flush=True)
            for key, ms, n in rows:
                print(f"[scatter]   {ms:9.4f} ms {n:3d}x  {key[:90]}",
                      flush=True)

    for _, _, fn in calls:  # warm-up
        fn()
    torch.cuda.synchronize()
    times = [[] for _ in calls]
    for _ in range(args.reps):
        for (_, _, fn), ts in zip(calls, times):
            ts.append(CS.event_ms(fn))
    result = {}
    for (name, label, _), ts in zip(calls, times):
        med = result.setdefault(name, {})[label] = statistics.median(ts)
        print(f"[times] {name:20s} {label:20s} {med:.4f} ms "
              f"(min {min(ts):.4f}, max {max(ts):.4f})", flush=True)
    for key, blocks in occupancy.items():
        print(f"[times] {key}: {blocks} blocks an SM", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ms": result, "reps": args.reps,
                      "blocks_per_sm": occupancy}))


if __name__ == "__main__":
    main()
