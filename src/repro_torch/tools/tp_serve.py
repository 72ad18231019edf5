"""Serving across the cards of one host, measured (ROADMAP A15a, A15b).

Run from the root of a checkout on a machine with four cards::

    PYTHONPATH=src python3 -m repro_torch.tools.tp_serve \\
        --out tp_serve.json [--quick] [--only a,b]

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
  a card);
* jamba-v0.1-52b with 1 of its 4 periods (8 layers, 13.3 B parameters)
  and deepseek-v2-236b with 7 of its 60 layers (25.2 B) on one card,
  and over ``model=4``;
* jamba-v0.1-52b whole over ``model=4`` (51.5 B parameters, 25.8 GB a
  card), and again under the ``kv_seq`` rule (``decode_kv_shard="seq"``)
  with caches of 32,768 positions, each rank holding 8,192 of them;
* deepseek-v2-236b with 31 of its 60 layers over ``model=4`` (120.6 B
  parameters, 60.8 GB a card, reckoned on the ``meta`` device: the
  deepest whose peak stays under 72 GB a card, ``DSV2_PERIODS``);

and, to hold the split at published widths, command-r-plus-104b and
llama3-8b with one layer, jamba with one period and deepseek-v2 with two
layers (its dense prefix layer and one MoE layer), in f32 (f32 caches,
128 prompt tokens) on one card and over ``model=4`` (llama also
``(2, 2)``; jamba also under ``kv_seq``, which holds the softmax merge of
``models.attention._seq_attention`` in f32), and llama3-8b whole on one
card serving 2 of the 4 requests.

Each rank serves its requests through ``run`` (cold), then once more on
the same weights (warm), then profiles 4 more decode steps. A run is
held against its reference run (one card, or for the ``kv_seq`` run the
same model over ``model=4`` without the rule) on the warm pass: the
prefill's last-position logits of each rank's requests (largest and
normwise difference), the greedy tokens, and the first decode step's
logits where the prefill picked the same token. Per rank it writes: the
cold and warm prefill ms, decode ms a step, tokens/s, peak memory, the
decode steps' idle share and the share of device time in NCCL kernels,
kernel launches a decode step, MoE layers' largest ``dropped_frac``,
and the bounds (a decode step's bytes: the rank's weights but for an
untied embedding, of its experts those its tokens were routed to, and
the filled positions of its caches, over 3.35 TB/s; a prefill's
products, of its experts the kept slots routed to them, over 989
TFLOP/s bf16). ``--quick`` cuts the layers and tokens (a check of the
path, not a measurement). Every number names the cards and their power
limits (``nvidia-smi``).
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
    ref: Optional[str] = None    # the run it is held against
    dtype: str = "bfloat16"      # "float32": weights, activations, caches
    batch: int = BATCH
    prompt: int = PROMPT
    gen: int = GEN
    seq: bool = False            # decode_kv_shard="seq": the kv_seq rule
    max_len: Optional[int] = None  # cache positions (default: just enough)


# deepseek-v2-236b over model=4: its dense prefix layer and 30 of its 59
# MoE layers, the deepest reckoned to peak under 72 GB a card (on the
# meta device: 30.41 B parameters, 60.8 GB in bf16, a card; the largest
# transient, one expert tensor drawn whole in f32, 5.0 GB)
DSV2_PERIODS = 30
# one layer in f32 at published widths: the split's own rounding, which
# the near one-hot attention of these random weights amplifies layer by
# layer in bf16 (the unsharded model's two-request run against its
# four-request run shows the same); jamba's smallest unit is a period of
# 8 layers, deepseek-v2's its dense prefix layer and one MoE layer
F32 = dict(dtype="float32", prompt=128, gen=8)
JAMBA, DSV2 = "jamba-v0.1-52b", "deepseek-v2-236b"
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
    Run("jamba1f-1", JAMBA, 1, (1, 1), **F32),
    Run("jamba1f-m4", JAMBA, 1, (1, 4), "jamba1f-1", **F32),
    Run("jamba1f-seq-m4", JAMBA, 1, (1, 4), "jamba1f-1", seq=True, **F32),
    Run("dsv2-2f-1", DSV2, 1, (1, 1), **F32),
    Run("dsv2-2f-m4", DSV2, 1, (1, 4), "dsv2-2f-1", **F32),
    Run("jamba8-1", JAMBA, 1, (1, 1)),
    Run("jamba8-m4", JAMBA, 1, (1, 4), "jamba8-1"),
    Run("dsv2-7-1", DSV2, 6, (1, 1)),
    Run("dsv2-7-m4", DSV2, 6, (1, 4), "dsv2-7-1"),
    Run("jamba-m4", JAMBA, None, (1, 4)),
    Run("jamba-seq-m4", JAMBA, None, (1, 4), "jamba-m4", seq=True,
        max_len=32768),
    Run("dsv2-31-m4", DSV2, DSV2_PERIODS, (1, 4)),
)
# --quick: one period of each model, 128 prompt tokens, 8 generated
QUICK = (1, 128, 8)


def _config(spec: dict):
    from ..configs import get_config
    cfg = dataclasses.replace(get_config(spec["arch"]), dtype=spec["dtype"],
                              param_dtype=spec["dtype"])
    if spec["n_periods"]:
        cfg = dataclasses.replace(cfg, n_periods=spec["n_periods"])
    if spec["seq"]:
        cfg = dataclasses.replace(cfg, decode_kv_shard="seq")
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


def _bounds(model, cfg, layout, batch: int, prompt: int, gen: int,
            max_len: int, routed: Dict[str, float]):
    """(decode step ms, prefill ms, the bytes and the operations).

    A decode step reads the rank's weights but for an untied embedding (a
    row a request), of its experts only the share its tokens were routed
    to (``routed["decode_hit"]``), and the filled positions of its caches
    (an SSD's state and conv inputs whole), over the memory rate. A
    prefill's products: 2 x its tokens x the rank's weights (its experts'
    for the kept slots routed to them, ``routed["prefill_slots"]`` of
    every token's k), the attention's score and value products over the
    filled positions (GQA; MLA's absorbed form over its latent; SSD's
    chunked scan), one head row a request, over the bf16 peak."""
    from ..models.model import init_caches
    rows = layout.rows(batch)
    b = rows.stop - rows.start
    tokens, filled = b * prompt, prompt + gen
    n_h = layout.local("heads", cfg.n_heads)
    h = n_h.stop - n_h.start
    expert_bytes = expert_params = other_bytes = other_params = 0
    for n, p in model.named_parameters():
        if n == "embed" and not cfg.tie_embeddings:
            continue
        if n.startswith("mtp."):
            continue
        if p.dim() == 3 and ".ffn.w_" in n:
            expert_bytes += p.numel() * p.element_size()
            expert_params += p.numel()
        else:
            other_bytes += p.numel() * p.element_size()
            other_params += p.numel()
    head = model.embed if cfg.tie_embeddings else model.lm_head
    cache_bytes = 0
    for c in init_caches(cfg, batch, max_len, "meta", layout):
        if c is None:
            continue
        share = 1.0 if type(c).__name__ == "SSMCache" \
            else min(1.0, filled / max_len)
        cache_bytes += share * sum(t.numel() * t.element_size() for t in c
                                   if isinstance(t, torch.Tensor))
    step_bytes = other_bytes + expert_bytes * routed.get("decode_hit", 0.0) \
        + cache_bytes
    flops = 2 * tokens * (other_params - head.numel()) \
        + 2 * tokens * expert_params * routed.get("prefill_slots", 0.0) \
        + 2 * b * head.numel()
    positions = filled / layout.model if layout.kv_seq else filled
    for mixer, _ in cfg.layer_specs:
        if mixer == "attn":
            heads = cfg.n_heads if layout.kv_seq else h
            flops += 4 * tokens * positions * heads * cfg.head_dim
        elif mixer == "mla":
            m = cfg.mla
            flops += 2 * tokens * filled * h * (2 * m.kv_lora + m.rope_dim)
        elif mixer == "ssm":
            s = cfg.ssm
            nh = s.expand * cfg.d_model // s.head_dim
            nh = nh // layout.model if layout.splits("heads") \
                and layout.splits("mlp") else nh
            flops += 2 * tokens * s.chunk * (s.d_state + nh * s.head_dim) \
                + 4 * tokens * nh * s.d_state * s.head_dim
    return (1e3 * step_bytes / HBM_BYTES_PER_S,
            1e3 * flops / BF16_FLOP_PER_S, step_bytes, flops)


class _Routing:
    """While installed, notes each MoE layer call's ``dropped_frac``, its
    tokens and the experts of this rank its kept slots were routed to,
    as tensors on the device (no host read until :meth:`summary`)."""

    def __init__(self, cfg, layout):
        from ..models import model as TM
        self.tm, self.calls = TM, []
        self.moe = TM.moe_ffn
        self.local = layout.local("experts", cfg.moe.n_experts) \
            if cfg.moe else None
        self.k = cfg.moe.top_k if cfg.moe else 0

    def __enter__(self):
        def noted(*args, **kw):
            y, aux = self.moe(*args, **kw)
            self.calls.append((aux["dropped_frac"], aux["idx"]))
            return y, aux
        self.tm.moe_ffn = noted
        return self

    def __exit__(self, *exc):
        self.tm.moe_ffn = self.moe

    def summary(self, n_prefill: int) -> Dict[str, float]:
        """Of the first ``n_prefill`` calls (the prefill's) the largest
        ``dropped_frac`` and the kept slots' share of this rank's experts
        an average token reaches; of the rest (decode steps) the share of
        this rank's experts hit a call."""
        if not self.calls:
            return {}
        lo, hi = self.local.start, self.local.stop
        n_local = hi - lo
        drops = [float(d) for d, _ in self.calls]
        hit, slots = [], []
        for j, (d, idx) in enumerate(self.calls):
            mine = (idx >= lo) & (idx < hi)
            if j < n_prefill:
                # kept slots on this rank's experts, over E x tokens: the
                # share of the experts' products a token's k slots need
                slots.append(float(mine.sum()) * (1 - drops[j])
                             / (idx.shape[0] * n_local))
            else:
                hit.append(len(torch.unique(idx[mine])) / n_local)
        return {"dropped_frac_max": max(drops),
                "prefill_slots": float(np.mean(slots)) if slots else 0.0,
                "decode_hit": float(np.mean(hit)) if hit else 0.0}


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
        r = LS.run(cfg, batch, prompt, gen, device=dev, seed=0, mesh=pm,
                   max_len=spec["max_len"])
        cold_s = time.perf_counter() - t0
        layout = r.model.layout

        # warm: the same requests on the same weights, fresh caches (in
        # f32 for an f32 run); its logits and tokens are the ones compared
        prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
        caches = init_caches(cfg, batch, r.max_len, dev, layout)
        if spec["dtype"] == "float32":
            caches = _f32_caches(caches)
        n_moe = sum(f == "moe" for _, f in cfg.layer_specs)
        with _Routing(cfg, layout) as routing:
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
                tok, logits, caches = decode(r.model, tok, prompt + i,
                                             caches)
                first = logits[:, -1].float() if first is None else first
                toks.append(tok)
            torch.cuda.synchronize(dev)
            decode_ms = (time.perf_counter() - t0) * 1e3 / (gen - 1)
        routed = routing.summary(n_moe)

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
        decode_bound, prefill_bound, step_bytes, flops = _bounds(
            r.model, cfg, layout, batch, prompt, gen, r.max_len, routed)
        launches = sum(1 for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        weight_bytes = sum(p.numel() * p.element_size()
                           for n, p in r.model.named_parameters()
                           if n != "embed" or cfg.tie_embeddings)
        res = dict(
            rank=pm.rank, coords=list(pm.coords), device=str(dev),
            backend=pm.backend, split=sorted(layout.split),
            layout=layout.report(), max_len=r.max_len,
            launches_per_step=launches / PROFILE_STEPS,
            step_bound_gb=step_bytes / 1e9, **routed,
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
    first_norm = 0.0
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
            first_norm = max(first_norm, float(
                (np.linalg.norm(got - exp, axis=-1)
                 / np.linalg.norm(exp, axis=-1)).max()))
            off += int((~_close(got, exp)).sum())
        same_first += int(same.sum())
        tokens_equal += int((lead["tokens"] == ref["tokens"][rows]).sum())
        tokens += lead["tokens"].size
    return dict(ref=run.ref, prefill_max_abs=worst_pre,
                prefill_normwise=norm,
                first_decode_max_abs=worst_first,
                first_decode_normwise=first_norm, logits_off_tol=off,
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
                n_periods, prompt, gen = QUICK
            spec = dict(name=run.name, arch=run.arch, n_periods=n_periods,
                        mesh=list(run.mesh), dtype=run.dtype,
                        batch=run.batch, prompt=prompt, gen=gen,
                        seq=run.seq, max_len=run.max_len)
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
