#!/usr/bin/env python3
"""Kernel times of one or more checkouts of this package, by one method.

Run as a file from the root of a checkout, on a machine with one card::

    python3 src/repro_torch/tools/kernel_times.py \\
        --tree parent=build/parent/src --tree change=src \\
        --exit-threads 128,256,512

Each ``--tree LABEL=DIR`` loads ``DIR/repro_torch`` under a name of its
own (its kernels build into that checkout's ``build/``), plans the same
batch as ``chip_smoke.py`` (the ``newyork`` setting: 32 x 1920x1080 4:2:0
q95, chunk_bits 1024, from ``--seed``) and times every kernel on the same
inputs as ``chip_smoke.py``'s phase 2: the exit kernel on the converged
entries (all lanes, and the ``idx`` form at a seeded random half; where
the tree's exit kernel has a global-table form, that too), the
stream and store kernels, the fused pixel kernel, the IDCT kernel (with
the batch's layout hint where the tree's wrapper takes one), its library
yardstick (``torch.matmul``, TF32 off) and the color kernel. Every time is
``chip_smoke.event_ms``'s (the card spins before each call, so the
wrapper's host time is not counted), and the trees take turns call by
call, so that a drift of the card's clock falls on all of them alike.
Each kernel must give the same output in every tree.

``--exit-threads`` also builds this checkout's ``csrc/huffman.cu`` once
per block size, with ``kExitThreads`` set to it, times each build's exit
kernel in the same turns (tables in shared memory) and prints the blocks
an SM holds at that size (the CUDA occupancy calculator).

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

# appended to a block-size variant of huffman.cu: the exit kernel's blocks
# per SM with its tables in shared memory
_OCCUPANCY = """
extern "C" int kt_exit_blocks_per_sm(int smem_bytes) {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, exits_kernel<true>, kExitThreads, smem_bytes);
  return err == cudaSuccess ? blocks : -(int)err;
}
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
    exit kernel's operands for the block-size variants."""
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
        "huffman_store": lambda: FS.decode_coeffs_store(
            dev, meta, entries, bases, write_max, n_coef, **kw),
        "fused_pixels": lambda: FP.fused_pixels(units, m_t, mrow, **geo),
        "idct": lambda: IK.idct_units(units, m_t, mrow, **hint),
        "color": lambda: CK.upsample_color(planes, *cgeo),
    }
    if hasattr(HK, "run_exit_kernel"):  # its tables read from global memory
        fns["huffman_exits_global"] = lambda: HK.run_exit_kernel(
            dev, meta, entries, **kw, smem_budget=0)
    x = units.to(torch.float32)
    library = lambda: [torch.matmul(x, m_t[q])  # noqa: E731
                       for q in range(plan.m_matrices.shape[0])]
    exit_op = (HK, dev, meta, entries, kw)
    return fns, library, exit_op


def build_exit_variants(threads_list, build):
    """This checkout's huffman.cu built once per block size: {threads:
    loaded library}. The builds run at once."""
    src = (build.CSRC / "huffman.cu").read_text()
    pattern = r"constexpr int kExitThreads = \d+;"
    if len(re.findall(pattern, src)) != 1:
        raise SystemExit("huffman.cu has no single kExitThreads constant")
    out_dir = build.BUILD_DIR / "exit_threads"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for t in threads_list:
        cu = out_dir / f"huffman_t{t}.cu"
        cu.write_text(re.sub(pattern, f"constexpr int kExitThreads = {t};",
                             src) + _OCCUPANCY)
        so = out_dir / f"libhuffman_t{t}.so"
        procs[t] = (subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for t, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {t} threads:\n{log}")
        libs[t] = ctypes.CDLL(str(so))
    return libs


def exit_variant_call(lib, exit_op):
    """A call of a variant library's exit kernel, tables in shared memory,
    on the converged entries; returns (call, blocks per SM)."""
    HK, dev, meta, entries, kw = exit_op
    fn = lib.rt_decode_exits
    fn.argtypes = HK._SIGNATURES["rt_decode_exits"]
    fn.restype = ctypes.c_int
    occ = lib.kt_exit_blocks_per_sm
    occ.argtypes, occ.restype = [ctypes.c_int], ctypes.c_int
    args = HK.exit_args(dev, meta, entries)
    c = entries.p.shape[0]
    smem = HK.exit_table_bytes(dev)
    stream = HK.B.stream_of(entries.p)

    def call():
        out = [torch.empty_like(entries.p) for _ in range(4)]
        err = fn(*args, *(HK.B.ptr(t) for t in out), c, kw["s_max"],
                 kw["min_code_bits"], smem, stream)
        HK.B.check(err, "rt_decode_exits")
        return tuple(out)

    return call, occ(smem)


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
    calls, outs, exit_ops, library = [], {}, {}, None
    for label, pkg in pkgs.items():
        fns, lib_call, exit_ops[label] = tree_kernels(pkg, blobs, args, gpu)
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
    threads_list = [int(t) for t in args.exit_threads.split(",") if t]
    if threads_list:
        this = [lb for lb, d in trees
                if (ROOT / d).resolve() == (ROOT / "src").resolve()]
        if not this:
            raise SystemExit("--exit-threads needs this checkout's src "
                             "among the trees")
        build = importlib.import_module(f"{pkgs[this[0]]}.kernels.build")
        for t, lib in build_exit_variants(threads_list, build).items():
            call, blocks = exit_variant_call(lib, exit_ops[this[0]])
            if not all(torch.equal(a, b) for a, b in
                       zip(flat(call()), outs["huffman_exits"])):
                raise SystemExit(f"the exit kernel at {t} threads gives "
                                 f"another output")
            occupancy[t] = blocks
            calls.append(("huffman_exits", f"{this[0]} {t} threads", call))
    del outs

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
    for t, blocks in occupancy.items():
        print(f"[times] exit kernel at {t} threads: {blocks} blocks an SM "
              f"({blocks * t // 32} of 64 warps)", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ms": result, "reps": args.reps,
                      "exit_blocks_per_sm": occupancy}))


if __name__ == "__main__":
    main()
