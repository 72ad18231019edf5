"""Serving across the cards of one host, measured (ROADMAP A15a).

Run from the root of a checkout on a machine with four cards::

    PYTHONPATH=src python3 -m repro_torch.tools.tp_serve \\
        --out tp_serve.json [--quick]

Each run starts its ranks, one process a card, through
``launch.mesh.run_ranks`` (torchrun's environment; NCCL; a run of one
rank starts no process group), and serves through ``launch.serve.run``
with bf16 weights drawn on each card from seed 0 (``init_sharded``: each
rank keeps its slice of the same draw). Every run serves 4 requests of
1,024 prompt tokens and 32 generated tokens:

* command-r-plus-104b at full width with 8 of its 64 layers (18.9 B
  parameters) on one card, and over ``model=4``;
* llama3-8b whole on one card, and over ``(data, model)`` = ``(1, 2)``,
  ``(1, 4)`` and ``(2, 2)``;
* command-r-plus-104b whole over ``model=4`` (107 B parameters, 53.5 GB
  a card).

and, to hold the split at published widths, command-r-plus-104b and
llama3-8b with one layer in f32 (f32 caches, 128 prompt tokens) on one
card and over ``model=4`` (llama also ``(2, 2)``), and llama3-8b whole
on one card serving 2 of the 4 requests.

Each rank serves its requests through ``run`` (cold), then once more on
the same weights (warm), then profiles 4 more decode steps. A run is
held against the one-card run of its model on the warm pass: the
prefill's last-position logits of each rank's requests (largest and
normwise difference), the greedy tokens, and the first decode step's
logits where the prefill picked the same token. Per rank it writes: the
cold and warm prefill ms, decode ms a step, tokens/s, peak memory, the
decode steps' idle share and the share of device time in NCCL kernels,
and the bounds (a decode step's bytes: the rank's weights but for an
untied embedding, and its caches, over 3.35 TB/s; a prefill's matrix
products over 989 TFLOP/s bf16).
``--quick`` cuts the layers and tokens (a check of the path, not a
measurement). Every number names the cards and their power limits
(``nvidia-smi``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..launch.mesh import run_ranks
from .mesh_decode import card_lines, union_ms

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
# the JAX package's bf16 tolerance for served logits
LM_TOL = dict(rtol=0.08, atol=0.15)
PROFILE_STEPS = 4


BATCH, PROMPT, GEN = 4, 1024, 32


@dataclasses.dataclass(frozen=True)
class Run:
    name: str
    arch: str
    n_periods: Optional[int]     # None: the whole model
    mesh: tuple                  # (data, model)
    ref: Optional[str] = None    # the one-card run it is held against
    dtype: str = "bfloat16"      # "float32": weights, activations, caches
    batch: int = BATCH
    prompt: int = PROMPT
    gen: int = GEN


# one layer in f32 at published widths: the split's own rounding, which
# the near one-hot attention of these random weights amplifies layer by
# layer in bf16 (the unsharded model's two-request run against its
# four-request run shows the same)
F32 = dict(dtype="float32", prompt=128, gen=8)
RUNS = (
    Run("crp1f-1", "command-r-plus-104b", 1, (1, 1), **F32),
    Run("crp1f-m4", "command-r-plus-104b", 1, (1, 4), "crp1f-1", **F32),
    Run("llama1f-1", "llama3-8b", 1, (1, 1), **F32),
    Run("llama1f-m4", "llama3-8b", 1, (1, 4), "llama1f-1", **F32),
    Run("llama1f-d2m2", "llama3-8b", 1, (2, 2), "llama1f-1", **F32),
    Run("crp8-1", "command-r-plus-104b", 8, (1, 1)),
    Run("crp8-m4", "command-r-plus-104b", 8, (1, 4), "crp8-1"),
    Run("llama-1", "llama3-8b", None, (1, 1)),
    Run("llama-1b2", "llama3-8b", None, (1, 1), "llama-1", batch=2),
    Run("llama-m2", "llama3-8b", None, (1, 2), "llama-1"),
    Run("llama-m4", "llama3-8b", None, (1, 4), "llama-1"),
    Run("llama-d2m2", "llama3-8b", None, (2, 2), "llama-1"),
    Run("crp-m4", "command-r-plus-104b", None, (1, 4)),
)
# --quick: (layers for a cut model, layers for a whole one, prompt, gen)
QUICK = (2, 4, 128, 8)


def _config(spec: dict):
    from ..configs import get_config
    cfg = dataclasses.replace(get_config(spec["arch"]), dtype=spec["dtype"],
                              param_dtype=spec["dtype"])
    if spec["n_periods"]:
        cfg = dataclasses.replace(cfg, n_periods=spec["n_periods"])
    return cfg


def _f32_caches(caches):
    from ..models.model import Caches
    return Caches(None if c is None else type(c)(*(
        t.float() if isinstance(t, torch.Tensor) and t.is_floating_point()
        else t for t in c)) for c in caches)


def _union_of(prof, pick) -> float:
    return union_ms([(e.time_range.start, e.time_range.end)
                     for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and pick(e.name)])


def _bounds(model, cfg, layout, batch: int, prompt: int, max_len: int):
    """(decode step ms, prefill ms, the bytes and the operations): the
    rank's weights (all but an untied embedding, of which a step reads a
    row a request) and the caches a step reads, over the memory rate; the
    prefill's products (weights, the score and value products over the
    cache, one head row a request) over the bf16 peak."""
    rows = layout.rows(batch)
    b = rows.stop - rows.start
    heads = layout.local("heads", cfg.n_heads)
    kv = layout.local("kv_heads", cfg.n_kv_heads)
    h, hkv = heads.stop - heads.start, kv.stop - kv.start
    layers = cfg.n_layers
    weight_bytes = sum(p.numel() * p.element_size()
                       for n, p in model.named_parameters()
                       if n != "embed" or cfg.tie_embeddings)
    cache_bytes = 2 * layers * b * max_len * hkv * cfg.head_dim * 2
    head = model.embed if cfg.tie_embeddings else model.lm_head
    per_layer = sum(p.numel() for n, p in model.named_parameters()
                    if n.startswith("blocks.0.") and p.dim() > 1)
    tokens = b * prompt
    flops = 2 * per_layer * layers * tokens \
        + 4 * layers * tokens * max_len * h * cfg.head_dim \
        + 2 * b * head.numel()
    return (1e3 * (weight_bytes + cache_bytes) / HBM_BYTES_PER_S,
            1e3 * flops / BF16_FLOP_PER_S, weight_bytes, flops)


def worker(spec: dict, out: Path) -> None:
    """One rank of a run (the environment of ``launch.mesh.run_ranks``)."""
    from ..launch import serve as LS
    from ..launch.mesh import init_process_mesh, shutdown_process_mesh
    from ..models.model import init_caches
    from ..serve.step import make_decode_step, make_prefill_step

    cfg = _config(spec)
    data, model = spec["mesh"]
    pm = init_process_mesh(data, model, "nccl" if data * model > 1
                           else None, "cuda", timeout_s=900)
    dev = pm.device
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        batch, prompt, gen = spec["batch"], spec["prompt"], spec["gen"]
        t0 = time.perf_counter()
        r = LS.run(cfg, batch, prompt, gen, device=dev, seed=0, mesh=pm)
        cold_s = time.perf_counter() - t0
        layout = r.model.layout

        # warm: the same requests on the same weights, fresh caches (in
        # f32 for an f32 run); its logits and tokens are the ones compared
        prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
        caches = init_caches(cfg, batch, r.max_len, dev, layout)
        if spec["dtype"] == "float32":
            caches = _f32_caches(caches)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        logits, caches = prefill(r.model, r.batch, caches)
        pre = logits[:, -1].float()
        tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
        torch.cuda.synchronize(dev)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        toks, first = [tok], None
        t0 = time.perf_counter()
        for i in range(gen - 1):
            tok, logits, caches = decode(r.model, tok, prompt + i, caches)
            first = logits[:, -1].float() if first is None else first
            toks.append(tok)
        torch.cuda.synchronize(dev)
        decode_ms = (time.perf_counter() - t0) * 1e3 / (gen - 1)

        act = [torch.profiler.ProfilerActivity.CPU,
               torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=act) as prof:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for i in range(PROFILE_STEPS):
                tok, _, caches = decode(r.model, tok, prompt + gen - 1 + i,
                                        caches)
            torch.cuda.synchronize(dev)
            wall = (time.perf_counter() - t0) * 1e3
        busy = _union_of(prof, lambda name: True)
        nccl = _union_of(prof, lambda name: "nccl" in name.lower())
        host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                       for e in prof.key_averages()
                       if e.self_cpu_time_total > 0),
                      key=lambda row: -row[1])[:8]
        decode_bound, prefill_bound, weight_bytes, flops = _bounds(
            r.model, cfg, layout, batch, prompt, r.max_len)
        res = dict(
            rank=pm.rank, coords=list(pm.coords), device=str(dev),
            backend=pm.backend, split=sorted(layout.split),
            rows=[layout.rows(batch).start, layout.rows(batch).stop],
            params=sum(p.numel() for p in r.model.parameters()),
            step_read_gb=weight_bytes / 1e9, prefill_tflop=flops / 1e12,
            cold_run_s=cold_s, cold_prefill_ms=r.prefill_s * 1e3,
            cold_decode_ms=r.decode_s * 1e3 / (gen - 1),
            prefill_ms=prefill_ms, decode_ms=decode_ms,
            tokens_per_s=batch * 1e3 / decode_ms,
            peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
            profile_wall_ms=wall, profile_busy_ms=busy,
            idle_share=(1 - busy / wall) if busy else None,
            nccl_ms=nccl, collective_share=(nccl / busy) if busy else None,
            decode_bound_ms=decode_bound, prefill_bound_ms=prefill_bound,
            host_top=[{"op": k, "self_ms": ms, "calls": n}
                      for k, ms, n in host],
            cpus=len(os.sched_getaffinity(0)), loadavg=os.getloadavg(),
            logits_finite=r.logits_finite)
        np.savez(out / f"{spec['name']}-rank{pm.rank}.npz",
                 prefill=pre.cpu().numpy(), first=first.cpu().numpy(),
                 tokens=torch.cat(toks, 1).cpu().numpy())
        (out / f"{spec['name']}-rank{pm.rank}.json").write_text(
            json.dumps(res))
    finally:
        shutdown_process_mesh(pm)


def _close(got, exp):
    return np.abs(got - exp) <= LM_TOL["atol"] + LM_TOL["rtol"] * np.abs(exp)


def compare(run: Run, out: Path, n_ranks: int) -> Dict:
    """A run's ranks against its one-card run: the prefill's logits and
    the greedy tokens of each rank's requests, the first decode step's
    logits where the prefill picked the same token; every rank of a model
    group holding the same logits."""
    ref = np.load(out / f"{run.ref}-rank0.npz")
    data, model = run.mesh
    n = run.batch // data
    worst_pre, worst_first, off, same_first, norm = 0.0, 0.0, 0, 0, 0.0
    tokens_equal, tokens = 0, 0
    group_equal = True
    for d in range(data):
        lead = np.load(out / f"{run.name}-rank{d * model}.npz")
        for m in range(1, model):
            z = np.load(out / f"{run.name}-rank{d * model + m}.npz")
            group_equal &= all(np.array_equal(z[k], lead[k])
                               for k in ("prefill", "first", "tokens"))
        rows = slice(d * n, (d + 1) * n)
        pre, exp = lead["prefill"], ref["prefill"][rows]
        worst_pre = max(worst_pre, float(np.abs(pre - exp).max()))
        norm = max(norm, float((np.linalg.norm(pre - exp, axis=-1)
                                / np.linalg.norm(exp, axis=-1)).max()))
        off += int((~_close(pre, exp)).sum())
        same = lead["tokens"][:, 0] == ref["tokens"][rows, 0]
        if same.any():
            got, exp = lead["first"][same], ref["first"][rows][same]
            worst_first = max(worst_first, float(np.abs(got - exp).max()))
            off += int((~_close(got, exp)).sum())
        same_first += int(same.sum())
        tokens_equal += int((lead["tokens"] == ref["tokens"][rows]).sum())
        tokens += lead["tokens"].size
    return dict(ref=run.ref, prefill_max_abs=worst_pre,
                prefill_normwise=norm,
                first_decode_max_abs=worst_first, logits_off_tol=off,
                first_token_equal=same_first, tokens_equal=tokens_equal,
                tokens=tokens, group_logits_equal=group_equal)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the results as JSON")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", default=None,
                    help="comma-separated run names (default: all)")
    ap.add_argument("--timeout", type=float, default=900,
                    help="seconds a run's ranks may take")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(json.loads(args.worker), Path(args.dir))
        return 0
    if not torch.cuda.is_available():
        print("tp_serve: no CUDA device", file=sys.stderr)
        return 2
    cards = card_lines()
    print("cards:", "; ".join(cards), flush=True)
    n_cards = len(cards)
    wanted = set(args.only.split(",")) if args.only else None
    result: Dict = {"cards": cards, "runs": {}}
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        for run in RUNS:
            world = run.mesh[0] * run.mesh[1]
            if (wanted and run.name not in wanted) or world > n_cards:
                continue
            n_periods, prompt, gen = run.n_periods, run.prompt, run.gen
            if args.quick:
                n_periods = min(n_periods or QUICK[1], QUICK[0]
                                if n_periods else QUICK[1])
                prompt, gen = QUICK[2], QUICK[3]
            spec = dict(name=run.name, arch=run.arch, n_periods=n_periods,
                        mesh=list(run.mesh), dtype=run.dtype,
                        batch=run.batch, prompt=prompt, gen=gen)
            t0 = time.perf_counter()
            ranks = run_ranks(
                ["-m", "repro_torch.tools.tp_serve", "--worker",
                 json.dumps(spec), "--dir", str(out)], world, args.timeout,
                log_dir=str(out / f"{run.name}-logs"))
            row: Dict = dict(spec, seconds=time.perf_counter() - t0)
            bad = [(r, rc, log) for r, (rc, log) in enumerate(ranks) if rc]
            if bad:
                failed.append(run.name)
                row["failed"] = [{"rank": r, "rc": rc, "log": log[-4000:]}
                                 for r, rc, log in bad]
                print(f"[tp] {run.name} failed:\n{bad[0][2][-4000:]}",
                      flush=True)
            else:
                row["ranks"] = [json.loads((out / f"{run.name}-rank{r}"
                                            f".json").read_text())
                                for r in range(world)]
                if run.ref and (out / f"{run.ref}-rank0.npz").exists():
                    row["vs"] = compare(run, out, world)
            result["runs"][run.name] = row
            print(json.dumps(row), flush=True)
            if args.out:
                Path(args.out).parent.mkdir(parents=True, exist_ok=True)
                Path(args.out).write_text(json.dumps(result, indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
