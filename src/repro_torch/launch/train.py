"""End-to-end training launcher.

Examples:
  # ~100M-param model for a few hundred steps on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
      --preset 100m --steps 300 --batch 8 --seq 256 --ckpt-dir ckpt \\
      --resume auto

  # any arch's smoke config, on the CPU
  PYTHONPATH=src python -m repro_torch.launch.train --arch jamba-v0.1-52b \\
      --smoke --device cpu

  # across processes, one a card (torchrun, or launch.mesh.run_ranks):
  # the model split over 2 ranks, the batch over 2
  torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --mesh data=2,model=2 --dist-backend nccl --ckpt-dir ckpt

The port of the JAX package's ``launch/train.py``, with its flags and
``--device`` (default ``cuda``: raises without a card). Data is
step-indexed and sharded (restart-safe); checkpoints are atomic and
``--resume auto`` picks up the latest; the straggler monitor logs slow
steps. ``--mesh data=D,model=M`` trains across D x M processes joined by
``--dist-backend`` (``launch.mesh.init_process_mesh``), under the JAX
launcher's training rules (``dist.plan.rules_for(kind="train")``): each
rank draws its slice of the weights (``init_sharded``) and takes its
data rank's rows of each global batch (``train.step.train_rows``); rank
0 logs. Checkpoints are saved in pieces by every rank, and ``--resume
auto`` restores onto the current mesh, which may differ from the one
that saved (``train.checkpoint``). The JAX launcher's XLA flags have no
counterpart.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config, get_smoke_config
from ..core.api import resolve_device
from ..data.tokens import Prefetcher, SyntheticTokens
from ..dist.fault import StepTimer, StragglerMonitor
from ..models.model import Model, init_sharded, torch_dtype
from ..train.checkpoint import (latest_step, restore_checkpoint,
                                save_checkpoint)
from ..train.optimizer import AdamWConfig, OptState, init_opt_state
from ..train.step import make_train_step, train_rows
from .mesh import init_process_mesh, parse_mesh, shutdown_process_mesh
from .multihost import init_distributed, shutdown_distributed


def scale_to_100m(cfg):
    """Shrink an arch config to ~100M params, keeping its family intact."""
    return dataclasses.replace(
        cfg,
        d_model=512, n_heads=8,
        n_kv_heads=min(cfg.n_kv_heads, 8),
        head_dim=64, d_ff=2048,
        vocab=min(cfg.vocab, 32000),
        n_periods=min(cfg.n_periods, 8),
        attn_chunk=512,
    )


@dataclasses.dataclass
class TrainRun:
    """What one :func:`main` trained: the model and optimizer state after
    its last step, the step it started from (0, or the checkpoint it
    resumed), each step's loss and time (host clock around the step,
    ending in a device synchronise), and the straggler count."""

    model: Model
    opt_state: OptState
    start: int
    losses: Dict[int, float]
    step_s: List[float]
    stragglers: int


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="llama3-8b")
    ap.add_argument("--preset", choices=["smoke", "100m"], default="smoke")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--save-every", type=int, default=100)
    ap.add_argument("--resume", default="none")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    ap.add_argument("--jpeg-stream", type=int, default=0, metavar="N",
                    help="dry-run the JPEG input pipeline over N distinct "
                         "batches first and report the streaming decode "
                         "stats (compile-once buckets, warm-step ms)")
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="store address of a multi-process launch (or "
                         "REPRO_COORDINATOR); the JPEG stream is then fed "
                         "per process")
    ap.add_argument("--processes", type=int, default=None,
                    help="total process count of the multi-process launch "
                         "(or REPRO_NUM_PROCESSES)")
    ap.add_argument("--process-id", type=int, default=None,
                    help="this process's id (or REPRO_PROCESS_ID)")
    ap.add_argument("--mesh", default=None, metavar="data=D,model=M",
                    help="train across D x M processes, one a rank, each "
                         "holding its slice of the weights and its rows of "
                         "the batch (started once a process: torchrun or "
                         "launch.mesh.run_ranks)")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                    help="the process group's backend, which --mesh of "
                         "more than one rank needs: nccl (a card a rank) "
                         "or gloo (the CPU, or ranks sharing a card)")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> TrainRun:
    args = parse_args(argv)
    data, model = parse_mesh(args.mesh) if args.mesh else (1, 1)
    pm = None
    if data * model > 1:
        pm = init_process_mesh(data, model, args.dist_backend, args.device,
                               coordinator=args.coordinator,
                               rank=args.process_id)
        from .multihost import process_info
        ctx = process_info()
        dev = pm.device
    else:
        ctx = init_distributed(args.coordinator, args.processes,
                               args.process_id)
        dev = resolve_device(args.device)
    try:
        if args.jpeg_stream:
            from .report import jpeg_stream_dryrun, render_decode_stats
            stats = jpeg_stream_dryrun(args.jpeg_stream,
                                       batch_size=args.batch, device=dev,
                                       ctx=ctx)
            if ctx.is_main:
                print(render_decode_stats(stats), flush=True)
        return train(args, dev, pm)
    finally:
        if pm is not None:
            shutdown_process_mesh(pm)
        elif ctx.initialized:
            shutdown_distributed()


def train(args: argparse.Namespace, dev: torch.device, pm=None) -> TrainRun:
    """The training loop of :func:`main`'s ``args`` on ``dev``; with a
    ``ProcessMesh`` ``pm``, this rank's part of it."""
    if args.smoke or args.preset == "smoke":
        cfg = get_smoke_config(args.arch)
    else:
        cfg = scale_to_100m(get_config(args.arch))
    maxpos = args.seq + 8 if cfg.norm == "layernorm" else 0
    layout = None if pm is None else pm.layout(cfg, args.batch, "train")
    lead = pm is None or pm.rank == 0
    log = print if lead else (lambda *a, **k: None)
    log(f"arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M "
        f"device={dev}")
    if layout is not None:
        log(f"mesh data={pm.data} model={pm.model} backend={pm.backend} "
            f"{layout.report()}")

    model = init_sharded(torch.Generator(device=dev).manual_seed(0), cfg,
                         layout, dev, maxpos)
    params = dict(model.named_parameters())
    opt_cfg = AdamWConfig(lr=args.lr)
    opt_state = init_opt_state(params, opt_cfg)
    step_fn = make_train_step(cfg, opt_cfg, microbatches=args.microbatches,
                              schedule_kwargs={"total": args.steps})

    start = 0
    if args.resume == "auto" and args.ckpt_dir:
        ls = latest_step(args.ckpt_dir)
        if ls is not None:
            restored = restore_checkpoint(
                args.ckpt_dir, ls, {"params": params, "opt": opt_state},
                layout=layout)
            with torch.no_grad():
                for k, p in params.items():
                    p.copy_(restored["params"][k])
            opt_state = restored["opt"]
            start = ls
            log(f"resumed from step {ls}")

    rows = train_rows(layout, args.batch, args.microbatches)
    src = SyntheticTokens(cfg.vocab, args.seq, args.batch)
    pf = Prefetcher(src, start_step=start)
    mon = StragglerMonitor()
    losses, step_s = {}, []
    t0 = time.time()
    try:
        for i in range(start, args.steps):
            step_i, batch = pf.next()
            assert step_i == i
            n = len(rows)
            if cfg.frontend == "vision":
                batch = dict(batch, patches=np.zeros(
                    (args.batch, cfg.n_patches, 1024), np.float32))
            batch = {k: torch.from_numpy(v[rows]).to(dev)
                     for k, v in batch.items()}
            if cfg.is_encdec:
                # zero frames, as the JAX launcher feeds; in the activation
                # dtype, which the port's encoder takes (its products refuse
                # mixed dtypes where ``jnp`` promotes the f32 zeros)
                batch["frames"] = torch.zeros(
                    (n, cfg.enc_seq, 128), device=dev,
                    dtype=torch_dtype(cfg.dtype))
            with StepTimer() as t:
                model, opt_state, metrics = step_fn(model, opt_state, batch)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            slow = mon.record(t.seconds)
            losses[i] = float(metrics["loss"])
            step_s.append(t.seconds)
            if i % args.log_every == 0 or i == args.steps - 1:
                log(f"step {i:5d} loss={losses[i]:.4f} "
                    f"gnorm={float(metrics.get('grad_norm', 0)):.2f} "
                    f"dt={t.seconds*1e3:.0f}ms{' SLOW' if slow else ''}",
                    flush=True)
            if args.ckpt_dir and (i + 1) % args.save_every == 0:
                save_checkpoint(args.ckpt_dir, i + 1,
                                {"params": params, "opt": opt_state}, model)
        if args.ckpt_dir:
            save_checkpoint(args.ckpt_dir, args.steps,
                            {"params": params, "opt": opt_state}, model)
    finally:
        pf.close()
    dt = time.time() - t0
    log(f"done: {args.steps - start} steps in {dt:.1f}s "
        f"({(args.steps - start) / max(dt, 1e-9):.2f} steps/s); "
        f"stragglers={mon.slow_steps}")
    return TrainRun(model=model, opt_state=opt_state, start=start,
                    losses=losses, step_s=step_s, stragglers=mon.slow_steps)


if __name__ == "__main__":
    main()
