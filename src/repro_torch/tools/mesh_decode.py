"""The decode over the cards of one process, measured (ROADMAP A9b).

Run from the root of a checkout on a machine with cards::

    PYTHONPATH=src python3 -m repro_torch.tools.mesh_decode [--out F.json]

For meshes of 1, 2 and 4 distinct cards (those the machine has), and with
``--same-card K`` a mesh of K blocks on ``cuda:0``, it decodes:

* the ``newyork`` batch (32 frames, 1920x1080, 4:2:0, q95, one entropy
  segment a frame) with jacobi ``post`` and ``full``, on the identity plan
  and on an ``lpt`` plan balanced over the mesh's blocks, to RGB;
* a skewed batch: one 1920x1080 q95 frame with a restart marker every
  MCU row, and three 320x240 q60 tails, to coefficients.

Each ``decode_on`` is held equal (``torch.equal``, ``sync_rounds`` and
``converged``) to the single-card ``decode()`` of the same plan on
``cuda:0``. Per case and mesh it prints, and writes to ``--out`` as JSON:
the warm ``decode_on`` wall ms (median of ``--reps``, after a first eager
decode and a second that captures the round graphs), beside
``decode()``'s and, on the identity plan, the mesh decode's own
schedules run over a mesh of one block on ``cuda:0`` (which ``decode_on``
hands to ``decode()``), held equal too; from one profiled
warm decode each card's busy ms (the union of its kernels and copies)
and idle share, and the copy time per exchange; rounds, host checks,
graph replays and kernel launches per card; exchange bytes per round and
per decode; and peer access between the cards. ``--quick`` runs small
frames (a check of the path, not a measurement). Every number names the
cards and their power limits (``nvidia-smi``).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from ..core.api import ParallelDecoder, clear_decode_programs
from ..jpeg import codec_ref as cr
from ..jpeg.encoder import DatasetSpec, build_dataset, synth_frame
from ..launch.mesh import Mesh, make_host_mesh


def card_lines() -> List[str]:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def skewed_blobs(width: int, height: int, seed: int) -> List[bytes]:
    """One multi-restart frame (a restart interval of one MCU row) and
    three small low-quality tails."""
    import numpy as np
    rng = np.random.default_rng(seed)
    big = cr.encode_baseline(synth_frame(rng, width, height, t=0.0),
                             quality=95, subsampling="4:2:0",
                             restart_interval=-(-width // 16)).jpeg_bytes
    tails = [cr.encode_baseline(synth_frame(rng, 320, 240, t=0.5 + i),
                                quality=60, subsampling="4:2:0").jpeg_bytes
             for i in range(3)]
    return [big] + tails


def _sync_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def union_ms(spans) -> float:
    """The ms covered by profiler spans ``(start_us, end_us)``."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def profile_cards(fn) -> Dict:
    """Each card's busy ms (union of its kernel and copy intervals) and
    copy ms, the wall ms, and the host ops of most self time, of one call
    of ``fn`` under the profiler; ``None`` per card where the profiler saw
    no device time."""
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        _sync_all()
        t0 = time.perf_counter()
        fn()
        _sync_all()
        wall = (time.perf_counter() - t0) * 1e3
    busy: Dict[int, list] = {}
    copies: Dict[int, list] = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        span = (e.time_range.start, e.time_range.end)
        busy.setdefault(e.device_index, []).append(span)
        if "memcpy" in e.name.lower():
            copies.setdefault(e.device_index, []).append(span)
    cards = sorted(busy)
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.self_cpu_time_total > 0),
                  key=lambda r: -r[1])[:10]
    return {"wall_ms": wall,
            "busy_ms": {c: union_ms(busy[c]) for c in cards},
            "copy_ms": {c: union_ms(copies.get(c, [])) for c in cards},
            "host_top": [{"op": k, "self_ms": ms, "calls": n}
                         for k, ms, n in host]}


def run_case(name: str, blobs: List[bytes], args, meshes: List[Mesh],
             sync: str, fuse: str, balance: str, emit: str) -> List[Dict]:
    rows = []
    ref_dec = ParallelDecoder.from_bytes(
        blobs, chunk_bits=args.chunk_bits, sync=sync, fuse=fuse,
        device="cuda:0")
    for _ in range(2):
        ref = ref_dec.decode(emit=emit)
    ts = []
    for _ in range(args.reps):
        _sync_all()
        t0 = time.perf_counter()
        ref_dec.decode(emit=emit)
        _sync_all()
        ts.append((time.perf_counter() - t0) * 1e3)
    single_ms = statistics.median(ts)
    one_block_ms = None
    if balance == "none":
        # the mesh decode's own schedules over one block, against decode()
        one = Mesh([torch.device("cuda", 0)])
        for _ in range(2):
            got = ref_dec._decode_mesh(one, emit)
        if not (torch.equal(got.coeffs.full("cuda:0"), ref.coeffs)
                and got.sync_rounds == ref.sync_rounds):
            raise SystemExit(f"{name} {sync}/{fuse}: a one-block mesh run "
                             f"differs from decode()")
        ts = []
        for _ in range(args.reps):
            _sync_all()
            t0 = time.perf_counter()
            ref_dec._decode_mesh(one, emit)
            _sync_all()
            ts.append((time.perf_counter() - t0) * 1e3)
        one_block_ms = statistics.median(ts)
        del got
    for mesh in meshes:
        k = mesh.size
        dec = ParallelDecoder.from_bytes(
            blobs, chunk_bits=args.chunk_bits, sync=sync, fuse=fuse,
            device="cuda:0", balance=balance, lanes=k)
        base = ref if balance == "none" else None
        if base is None:
            for _ in range(2):
                base = dec.decode(emit=emit)
        for _ in range(2):   # eager, then the graphs' capture
            out = dec.decode_on(mesh, emit=emit)
        same = (torch.equal(out.coeffs.full("cuda:0"), base.coeffs)
                and out.sync_rounds == base.sync_rounds
                and out.converged == base.converged
                and (emit != "rgb" or torch.equal(out.rgb.full("cuda:0"),
                                                  base.rgb)))
        if not same:
            raise SystemExit(f"{name} {sync}/{fuse}/{balance} on {mesh}: "
                             f"decode_on differs from decode()")
        ts = []
        for _ in range(args.reps):
            _sync_all()
            t0 = time.perf_counter()
            out = dec.decode_on(mesh, emit=emit)
            _sync_all()
            ts.append((time.perf_counter() - t0) * 1e3)
        prof = profile_cards(lambda: dec.decode_on(mesh, emit=emit))
        m = out.mesh
        halo = m["copy_bytes"].get("halo", 0)
        cards = sorted({int(str(d).split(":")[1]) for d in m["devices"]})
        row = {
            "case": name, "sync": sync, "fuse": fuse, "balance": balance,
            "emit": emit, "mesh": str(mesh), "blocks": k,
            "equal_to_decode": same, "sync_rounds": out.sync_rounds,
            "single_card_ms": single_ms, "one_block_mesh_ms": one_block_ms,
            "warm_ms": statistics.median(ts),
            "warm_ms_all": ts, "profiled_wall_ms": prof["wall_ms"],
            "busy_ms": {c: prof["busy_ms"].get(c) for c in cards},
            "idle_share": {c: (None if prof["busy_ms"].get(c) is None else
                               1 - prof["busy_ms"][c] / prof["wall_ms"])
                           for c in cards},
            "copy_ms_per_exchange": {
                c: (None if c not in prof["copy_ms"] or not m["exchanges"]
                    else prof["copy_ms"][c] / m["exchanges"])
                for c in cards},
            "host_checks": m["host_checks"], "exchanges": m["exchanges"],
            "round_bytes": m["round_bytes"], "copy_bytes": m["copy_bytes"],
            "halo_bytes_per_exchange": (halo / m["exchanges"]
                                        if m["exchanges"] else 0),
            "lanes": m["lanes"], "rows": m["rows"],
            "graph_replays": m["graph_replays"],
            "host_top": prof["host_top"], "host_ms": m.get("host_ms"),
            "launches": m["launches"], "peer_access": m["peer_access"]}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del dec, out
        clear_decode_programs()
    return rows


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--distinct", type=int, default=8)
    ap.add_argument("--repeat", type=int, default=4)
    ap.add_argument("--chunk-bits", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--meshes", default="1,2,4",
                    help="sizes of the meshes of distinct cards")
    ap.add_argument("--same-card", type=int, default=0,
                    help="also a mesh of this many blocks on cuda:0")
    ap.add_argument("--quick", action="store_true",
                    help="small frames: a check of the path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device is available", file=sys.stderr)
        return 2
    if args.quick:
        args.width, args.height, args.distinct, args.repeat = 320, 240, 2, 2
        args.reps = 2
    cards = card_lines()
    for ln in cards:
        print(f"[card] {ln}")
    n_cards = torch.cuda.device_count()
    meshes = [make_host_mesh(k)
              for k in (int(x) for x in args.meshes.split(","))
              if k <= n_cards]
    if args.same_card:
        meshes.append(Mesh([torch.device("cuda", 0)] * args.same_card))
    spec = DatasetSpec("newyork", args.distinct, args.width, args.height, 95)
    newyork = [b for b in build_dataset(spec, seed=args.seed).jpeg_bytes
               for _ in range(args.repeat)]
    skewed = skewed_blobs(args.width, args.height, args.seed)
    rows = []
    for fuse in ("post", "full"):
        for balance in ("none", "lpt"):
            rows += run_case("newyork", newyork, args, meshes, "jacobi",
                             fuse, balance, "rgb")
    for balance in ("none", "lpt"):
        rows += run_case("skewed", skewed, args, meshes, "jacobi", "post",
                         balance, "coeffs")
    result = {"cards": cards, "device_count": n_cards,
              "torch": torch.__version__, "rows": rows}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(f"[mesh] {len(rows)} decodes held equal to decode() on "
          f"{n_cards} card(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
