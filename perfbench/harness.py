"""One run of one cell: set-up, the timed window, the check, the result.

The cell, its configuration and its traffic mix are found by name from
``BENCHMARK.json``; each metric the cell reports is read by
``perfbench/metrics/<name>.py`` (``read(run)``: a number, or None where
the run holds nothing to read). Adding a cell or a metric adds files and
entries and edits none of this.

The timed path is the program's ``ParallelDecoder.decode(emit="rgb")``
over a ring of batches planned in set-up with
``ParallelDecoder.from_bytes(blobs, chunk_bits=...)`` and the program's
defaults for every other option. The loop is closed: one batch in
flight, each waited for (its RGB ready on the card) before the next is
called, as a training job waits for its input batch.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import json
import random
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import counts, inputs, reference, tracing

ROOT = Path(__file__).resolve().parents[1]
BANNED = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, with its
    configuration's file and its traffic mix's
    (``perfbench/workloads/<traffic>.json``)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / cfg["file"]).read_text())
    traffic = json.loads((root / "perfbench" / "workloads"
                          / f"{cell['traffic']}.json").read_text())

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return Cell(name, int(cell["chips"]), config, traffic,
                mine(bench["end_to_end"]), mine(bench["per_layer"]))


def load_reader(root: Path, metric: str) -> Callable:
    """``read`` of ``root/perfbench/metrics/<metric>.py``."""
    path = root / "perfbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def banned_modules(names) -> List[str]:
    """Loaded modules whose top-level name is one of ``BANNED``."""
    return sorted(n for n in names if n.split(".")[0] in BANNED)


def ring_frames(n_images: int, batch: int, ring: int, seed: int
                ) -> List[np.ndarray]:
    """Each ring slot's frames: every distinct frame ``batch // n_images``
    times, in an order drawn from the seed. Every slot holds the same
    frames, so every batch has the same work; the orders differ, so a
    batch's RGB is told from another's."""
    if batch % n_images:
        raise ValueError("a batch holds each distinct frame equally often")
    rng = np.random.default_rng(seed & (2 ** 64 - 1))
    base = np.repeat(np.arange(n_images), batch // n_images)
    return [rng.permutation(base) for _ in range(ring)]


def plan_ring(batches: List[List[bytes]], chunk_bits: int, device) -> list:
    """One planned decoder a batch, every other option the program's
    default."""
    from repro_torch.core.api import ParallelDecoder
    kw = {} if device is None else {"device": device}
    return [ParallelDecoder.from_bytes(b, chunk_bits=chunk_bits, **kw)
            for b in batches]


@dataclasses.dataclass
class Run:
    """What a run measured; the metric readers read it."""

    setup_s: float
    window_s: float
    batch_s: List[float]
    images: int
    rounds: List[int]
    launches: List[int]                   # each batch's launches
    trace: Optional[tracing.Trace]
    traced_work: List[counts.BatchWork]   # each traced batch's work
    peaks: Optional[Dict[str, float]]


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unread ({e})"


def open_card(chips: int, device: Optional[str]):
    """``(device, kind, sync)`` of the run: the first card, or ``device``
    where a test names one. None, with the reason on standard error,
    where the machine has fewer cards than the cell asks for."""
    if device is not None:
        return torch.device(device), device, lambda: None
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"this cell needs {chips} CUDA device(s); {n} available",
              file=sys.stderr)
        return None
    card = torch.device("cuda", 0)
    torch.cuda.set_device(card)
    print(f"card: {power_limit()}", file=sys.stderr)
    from repro_torch.kernels import build
    build.build_all()
    torch.set_num_threads(1)   # the window's host work is one thread
    return card, torch.cuda.get_device_name(card), \
        lambda: torch.cuda.synchronize(card)


def prepare(cell: Cell, seed: int, device: Optional[str], cache: Path,
            processes: Optional[int] = None):
    """The cell's frames (cached under ``cache``), the ring's frame
    orders from the seed, its planned decoders and each slot's work."""
    cfg, traffic = cell.config, cell.traffic
    frames = inputs.make_frames(cfg, int(traffic["restart_interval"]), cache,
                                processes)
    slots = ring_frames(int(cfg["n_images"]), int(traffic["batch"]),
                        int(traffic["ring"]), seed)
    chunk_bits = int(cfg["subsequence_bits"])
    ring = plan_ring([[frames.blobs[f] for f in ids] for ids in slots],
                     chunk_bits, device)
    work = [counts.batch_work(ids, frames.segment_bytes, frames.geometry,
                              chunk_bits) for ids in slots]
    return frames, slots, ring, work


def compare(sample, slots, frames: inputs.Frames, device,
            unconverged: int = 0) -> reference.Comparison:
    """Each image of the sampled batches (``(slot, rgb)`` pairs) against
    the reference's RGB of its frame."""
    comparison = reference.Comparison()
    comparison.unconverged = unconverged
    refs = {}
    for slot, rgb in sample:
        for j, f in enumerate(slots[slot]):
            if f not in refs:
                refs[f] = frames.reference(f, device)
            ok = rgb is not None and j < len(rgb)
            comparison.add(rgb[j] if ok else torch.empty(0, dtype=torch.uint8),
                           refs[f])
    return comparison


def warm_up(ring: list, keep: int, sync) -> None:
    """Every shape the window uses, before it: the program's first decode
    runs eagerly and its second captures the sync's CUDA graphs; then as
    many outputs are held at once as the window's sample keeps, so that
    the allocator already holds their blocks."""
    for _ in range(2):
        for dec in ring:
            dec.decode(emit="rgb")
            sync()
    held = []
    for k in range(keep + 2):
        held.append(ring[k % len(ring)].decode(emit="rgb").rgb)
        sync()


def profiler(on_card: bool, ring: list, sync):
    """A profiler for the traced batches, its machinery started by a
    first profile of one decode (that takes seconds, in set-up)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as first:
        ring[0].decode(emit="rgb")
        sync()
    first.events()
    return torch.profiler.profile(activities=acts)


@dataclasses.dataclass
class Window:
    """What the timed loop saw."""

    t_end: float
    batch_s: List[float] = dataclasses.field(default_factory=list)
    rounds: List[int] = dataclasses.field(default_factory=list)
    launches: List[int] = dataclasses.field(default_factory=list)
    traced_slots: List[int] = dataclasses.field(default_factory=list)
    sample: List[tuple] = dataclasses.field(default_factory=list)
    images: int = 0
    unconverged: int = 0


def window(ring: list, sync, seconds: float, batch: int, keep: int,
           seed: int, prof, trace_from: int, trace_batches: int) -> Window:
    """The timed loop: batches of the ring in turn, each called and waited
    for, until ``seconds`` have passed; ``keep`` outputs sampled uniformly
    (a reservoir drawn from the seed) for the check; with ``prof``, the
    batches from ``trace_from`` on traced.

    A traced batch does the same host work as any other: every batch runs
    in the harness's spans and reads its launches. The profiler starts one
    batch before the first traced one, and that batch runs outside the
    spans, so the reduction, bounded by the spans, leaves out what starting
    the profiler costs."""
    w = Window(t_end=time.perf_counter())
    pick = random.Random(seed)
    record = torch.profiler.record_function
    trace_to = trace_from + trace_batches
    lead_in = max(trace_from - 1, 0)
    deadline = time.perf_counter() + seconds
    i = 0
    while True:
        t_call = time.perf_counter()
        if t_call >= deadline:
            break
        slot = i % len(ring)
        if prof is not None and i == lead_in:
            prof.start()
        traced = prof is not None and trace_from <= i < trace_to
        spans = (contextlib.nullcontext
                 if prof is not None and i == lead_in < trace_from
                 else record)
        with spans(tracing.SPAN_DECODE):
            out = ring[slot].decode(emit="rgb")
        with spans(tracing.SPAN_WAIT):
            sync()
        w.t_end = time.perf_counter()
        with spans(tracing.SPAN_LOOP):
            w.batch_s.append(w.t_end - t_call)
            w.rounds.append(out.sync_rounds)
            if out.converged:
                w.images += batch
            else:
                w.unconverged += 1
            if len(w.sample) < keep:
                w.sample.append((i, slot, out.rgb))
            else:
                j = pick.randrange(i + 1)
                if j < keep:
                    w.sample[j] = (i, slot, out.rgb)
            st = ring[slot].launch_stats()
            w.launches.append(sum(st["launches"].values())
                              + st["graph_replays"])
            if traced:
                w.traced_slots.append(slot)
            del out
        if prof is not None and i == trace_to - 1:
            prof.stop()
        i += 1
    if prof is not None and lead_in <= i - 1 < trace_to - 1:
        prof.stop()
    return w


def main(argv=None, *, root: Path = ROOT, device: Optional[str] = None,
         processes: Optional[int] = None, t0: Optional[float] = None) -> int:
    """Run one cell once and print its result line. ``device`` None runs
    on the card and refuses to run without one; the tests pass "cpu".
    ``processes`` is how many processes encode (the host's cores)."""
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(root, args.workload)
    got = open_card(cell.chips, device)
    if got is None:
        return 2
    card, kind, sync = got
    on_card = device is None
    traffic = cell.traffic
    batch = int(traffic["batch"])
    keep = int(traffic["check_batches"])
    frames, slots, ring, work = prepare(cell, args.seed, device,
                                        root / "perfbench" / ".cache",
                                        processes)
    warm_up(ring, keep, sync)
    prof = profiler(on_card, ring, sync) if args.trace else None
    t_start = time.perf_counter()
    w = window(ring, sync, args.seconds, batch, keep, args.seed, prof,
               int(traffic["trace_from"]), int(traffic["trace_batches"]))

    found = banned_modules(list(sys.modules))
    if found:
        print(f"the run loaded {', '.join(found)}: the benchmark may load "
              f"none of {', '.join(BANNED)}", file=sys.stderr)
        return 3
    peak = torch.cuda.max_memory_allocated(card) if on_card else 0
    trace = None
    if prof is not None and w.traced_slots:
        trace = tracing.reduce(*tracing.from_profiler(prof))
    run = Run(setup_s=t_start - t0, window_s=w.t_end - t_start,
              batch_s=w.batch_s, images=w.images,
              rounds=w.rounds, launches=w.launches, trace=trace,
              traced_work=[work[s] for s in w.traced_slots],
              peaks=counts.peaks_for(kind) if on_card else None)
    listed = cell.per_layer if args.trace else cell.end_to_end
    metrics = {}
    for m in listed:
        value = load_reader(root, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if w.batch_s:
        print(f"batches {len(w.batch_s)}, median "
              f"{1e3 * float(np.median(w.batch_s))} ms, p95 "
              f"{1e3 * float(np.percentile(w.batch_s, 95))} ms, mean rounds "
              f"{float(np.mean(w.rounds))}", file=sys.stderr)

    # the check: the program's state freed first, the peak already read
    del ring, prof
    from repro_torch.core.api import clear_decode_programs
    clear_decode_programs()
    comparison = compare([(slot, rgb) for _, slot, rgb in sorted(
        w.sample, key=lambda x: x[0])], slots, frames, card, w.unconverged)
    correct, shown = reference.judge(comparison.numbers(),
                                     cell.config["limits"])
    correct = correct and comparison.images > 0
    result = {"correct": correct, "attempted": len(w.batch_s) * batch,
              "failed": w.unconverged * batch, "metrics": metrics,
              "device": {"platform": "gpu" if on_card else card.type,
                         "kind": kind, "count": cell.chips,
                         "memory_peak_bytes": int(peak)}}
    if trace is not None:
        result["device"].update(busy_s=trace.busy_s, window_s=trace.window_s)
        result["breakdown"] = {"device_ops": trace.device_ops,
                               "idle_gaps": trace.idle_gaps}
    result["checks"] = shown
    print(f"checked {comparison.images} images of {len(w.sample)} batches",
          file=sys.stderr)
    for k, v in shown.items():
        print(f"check {k} = {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0

