#!/usr/bin/env python3
"""Kernel times of one or more checkouts of this package, by one method.

Run as a file from the root of a checkout, on a machine with one card::

    python3 src/repro_torch/tools/kernel_times.py \\
        --tree parent=build/parent/src --tree change=src \\
        [--launch "exit=128;stream=512,store=128;writer=lane"] \\
        [--stream-variants "kStreamBarrierRows=4;threads=128"] \\
        [--store-variants "threads=512"] [--exit-variants "threads=64"] \\
        [--color-variants "kColorRun=16;kRowsY=4"] [--scatter-parts]

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

``--launch`` also times the kernels of each tree that has
``kernels/autotune.py`` under other launch configs, one per ';'-separated
spec in the grammar of its ``REPRO_TORCH_LAUNCH`` override (say
``exit=128;stream=512,store=128``): each kernel whose knob the spec
changes, in the same turns, with the same output required.
``--exit-variants``, ``--stream-variants``, ``--store-variants`` and
``--color-variants`` time what no launch config reaches: this checkout's
``csrc/<source>.cu`` built once per ';'-separated spec, each a
comma-separated list of ``CONST=VALUE`` (a ``constexpr int`` of the
source or of the headers it includes, say ``kStreamBarrierRows=4`` or
``kColorRun=16,kRowsY=4``) and, for the exit, stream and store kernels,
``threads=N`` (blocks of N whatever the launch asks, also outside the
candidates). Each build's kernel runs through this checkout's wrapper in
the same turns, with the same output required, and its blocks an SM (the
CUDA occupancy calculator) are printed; beside the stream variants, a
plain fill of the streams' bytes.
``--scatter-parts`` profiles one call of each tree's scatter, printing
its device time by kernel: the elementwise passes and the ``index_put``.

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

# a variant build of a kernel: kind -> (source, entry point, kernel timed,
# the kernel's instantiation and its block size for the occupancy
# calculator, its dynamic shared memory besides the tables); {t} is the
# block size
VARIANTS = {
    "exit": ("huffman", "rt_decode_exits", "huffman_exits",
             "exits_kernel<true, {t}>", "{t}", "0"),
    "stream": ("huffman", "rt_decode_streams", "huffman_streams",
               "streams_kernel<true, {t}>", "{t}", "0"),
    "store": ("huffman", "rt_decode_store", "huffman_store",
              "store_kernel<true, true, {t}>", "{t}",
              "rt::store_slot_bytes({t})"),
    "color": ("color", "rt_upsample_color", "color", "color_kernel<2, 2>",
              "rt::kRunsX * rt::kRowsY", "0"),
}
_THREADS = {"exit": "exit_threads", "stream": "stream_threads",
            "store": "store_threads"}
_OCCUPANCY = """
extern "C" int kt_blocks_per_sm(int smem_bytes) {{
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, {kernel}, {threads}, {extra} + smem_bytes);
  return err == cudaSuccess ? blocks : -(int)err;
}}
"""


def variant_sources(kind: str, spec: dict, build, default_threads: int
                    ) -> dict:
    """{file name: text}: this checkout's ``csrc/<source>.cu`` and every
    header with the spec's constants set, the entry point's block-size
    dispatch pinned to ``threads`` where the spec gives it, and the
    occupancy helper appended."""
    source, entry, _, kernel, threads, extra = VARIANTS[kind]
    texts = {f.name: f.read_text() for f in build.CSRC.glob("*.cuh")}
    cu = f"{source}.cu"
    texts[cu] = (build.CSRC / cu).read_text()
    spec = dict(spec)
    t = spec.pop("threads", None)
    if t is not None:
        if kind not in _THREADS:
            raise SystemExit(f"the {kind} kernel has no threads knob")
        at = texts[cu].index(f"int {entry}(")
        m = re.compile(r"with_block<[\d, ]+>\(threads").search(texts[cu], at)
        if m is None:
            raise SystemExit(f"{cu}: no block-size dispatch in {entry}")
        texts[cu] = (texts[cu][:m.start()] + f"with_block<{t}>({t}"
                     + texts[cu][m.end():])
    for const, value in spec.items():
        pattern = rf"constexpr int {const} = [^;]+;"
        hits = [n for n, text in texts.items() if re.search(pattern, text)]
        if len(hits) != 1 or len(re.findall(pattern, texts[hits[0]])) != 1:
            raise SystemExit(f"no single {const} constant in {cu} and the "
                             f"headers ({hits})")
        texts[hits[0]] = re.sub(pattern, f"constexpr int {const} = {value};",
                                texts[hits[0]])
    t = t or default_threads
    texts[cu] += _OCCUPANCY.format(kernel=kernel.format(t=t),
                                   threads=threads.format(t=t),
                                   extra=extra.format(t=t))
    return texts


def build_variants(kind: str, specs: list, build, default_threads: int
                   ) -> dict:
    """This checkout's ``kind`` kernel built once per spec (a {constant:
    value} dict), all at once: {label: loaded library}."""
    source = VARIANTS[kind][0]
    procs = {}
    for n, spec in enumerate(specs):
        out_dir = build.BUILD_DIR / "variants" / f"{kind}_v{n}"
        out_dir.mkdir(parents=True, exist_ok=True)
        for name, text in variant_sources(kind, spec, build,
                                          default_threads).items():
            (out_dir / name).write_text(text)
        so = out_dir / f"lib{source}.so"
        label = ",".join(f"{k}={v}" for k, v in spec.items())
        procs[label] = (subprocess.Popen(
            [build.nvcc_path(), *build.flags(), f"-I{out_dir}", "-o",
             str(so), str(out_dir / f"{source}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for label, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {kind} {label}:\n{log}")
        libs[label] = ctypes.CDLL(str(so))
    return libs


def variant_call(kind: str, lib, build, call, smem: int):
    """``call`` (the tree's wrapper of the ``kind`` kernel) with its entry
    point taken from the variant library ``lib``; and the kernel's blocks
    an SM at ``smem`` bytes of tables (after a first call, which opts the
    kernel into its shared memory)."""
    source = VARIANTS[kind][0]
    entry = build.entry

    def variant_entry(lib_name, name, argtypes, checked=False):
        if lib_name != source or checked:
            return entry(lib_name, name, argtypes, checked)
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return fn

    def run():
        build.entry = variant_entry
        try:
            return call()
        finally:
            build.entry = entry

    occ = lib.kt_blocks_per_sm
    occ.argtypes, occ.restype = [ctypes.c_int], ctypes.c_int
    return run, lambda: occ(0 if kind == "color" else smem)


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
    """{kernel: a call of it} on one tree's plan of ``blobs``, the library
    yardstick, {spec: {kernel: a call of it under the spec's launch
    config}} for ``--launch`` (empty for a tree without autotune), and the
    bytes of the Huffman kernels' tables."""
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
    variants = {}
    specs = [v for v in args.launch.split(";") if v]
    try:
        AT = mod("kernels.autotune")
    except ImportError:
        specs = []
    for spec in specs:
        cfg = AT.parse_launch_override(spec)
        d = AT.DEFAULT_LAUNCH
        calls = {}
        if cfg.exit_threads != d.exit_threads:
            calls["huffman_exits"] = lambda c=cfg: HK.decode_exits(
                dev, meta, entries, **kw, launch=c)
        if cfg.stream_threads != d.stream_threads:
            calls["huffman_streams"] = lambda c=cfg: HK.decode_streams(
                dev, meta, entries, **kw, launch=c)
        if (cfg.store_threads, cfg.store_writer) != (d.store_threads,
                                                     d.store_writer):
            calls["huffman_store"] = lambda c=cfg: FS.decode_coeffs_store(
                dev, meta, entries, bases, write_max, n_coef, **kw,
                launch=c)
        if cfg.pixel_groups != d.pixel_groups:
            calls["fused_pixels"] = lambda c=cfg: FP.fused_pixels(
                units, m_t, mrow, **geo, launch=c)
        if cfg.idct_groups != d.idct_groups:
            calls["idct"] = lambda c=cfg: IK.idct_units(
                units, m_t, mrow, **hint, launch=c)
        variants[spec] = calls
    return fns, library, variants, HK.exit_table_bytes(dev)


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
    ap.add_argument("--launch", default="",
                    help="launch configs to time each tree's kernels under "
                    "too, ';'-separated specs in the REPRO_TORCH_LAUNCH "
                    "grammar (trees with kernels/autotune.py)")
    for kind in VARIANTS:
        ap.add_argument(f"--{kind}-variants", default="",
                        help=f"builds of this checkout's {kind} kernel, "
                        "';'-separated specs of comma-separated CONST=VALUE"
                        + (" or threads=N" if kind in _THREADS else ""))
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
    synth_frame = importlib.import_module(f"{first}.jpeg.encoder").synth_frame
    rng = np.random.default_rng(args.seed)
    frames = [synth_frame(rng, args.width, args.height, t=0.13 * i)
              for i in range(args.distinct)]
    distinct = [cr.encode_baseline(f, quality=args.quality,
                                   subsampling="4:2:0").jpeg_bytes
                for f in frames]
    blobs = [b for b in distinct for _ in range(args.repeat)]
    del frames

    # (kernel, tree, call)
    calls, outs, library, tree_fns = [], {}, None, {}
    for label, pkg in pkgs.items():
        fns, lib_call, variants, table_bytes = tree_kernels(pkg, blobs, args,
                                                            gpu)
        tree_fns[label] = fns
        library = library or lib_call
        runs = [(label, fns)] + [(f"{label} {spec}", v)
                                 for spec, v in variants.items()]
        for run_label, run_fns in runs:
            for name, fn in run_fns.items():
                calls.append((name, run_label, fn))
                got = flat(fn())
                ref = outs.setdefault(name.removesuffix("_global"), got)
                if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                    raise SystemExit(f"{name}: {run_label} gives another "
                                     f"output than tree {next(iter(pkgs))}")
    calls.append(("idct_library", "torch", library))
    occupancy = {}
    for kind in VARIANTS:
        specs = [dict(kv.split("=") for kv in v.split(","))
                 for v in getattr(args, f"{kind}_variants").split(";") if v]
        if not specs:
            continue
        this = [lb for lb, d in trees
                if (ROOT / d).resolve() == (ROOT / "src").resolve()]
        if not this:
            raise SystemExit(f"variants of the {kind} kernel need this "
                             f"checkout's src among the trees")
        build = importlib.import_module(f"{pkgs[this[0]]}.kernels.build")
        AT = importlib.import_module(f"{pkgs[this[0]]}.kernels.autotune")
        default = getattr(AT.DEFAULT_LAUNCH, _THREADS.get(kind, ""), 0)
        kernel = VARIANTS[kind][2]
        ref = outs[kernel]
        smem = table_bytes  # every tree plans the same batch
        for label, lib in build_variants(kind, specs, build, default).items():
            call, blocks = variant_call(kind, lib, build,
                                        tree_fns[this[0]][kernel], smem)
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
