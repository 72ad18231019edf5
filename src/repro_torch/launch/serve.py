"""Batched serving: prefill a batch of prompts, then decode tokens.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
      --batch 4 --prompt-len 64 --gen 32 [--device cpu]

The port of the JAX package's ``launch/serve.py``, with its flags and
``--device`` (default ``cuda``: raises without a card). ``main`` serves
the arch's smoke config; :func:`run` serves any config of the ten archs.

Across cards, one process a rank (torchrun, or
``launch.mesh.run_ranks``), with the backend named:

  torchrun --nproc-per-node 4 -m repro_torch.launch.serve \\
      --arch llama3-8b --mesh data=1,model=4 --dist-backend nccl

Each rank holds its slice of the weights and its rows of the batch
(``dist.plan.ShardLayout``), for every arch; rank 0 prints the run's
numbers and what the layout splits and holds whole.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.api import resolve_device
from ..models.config import ModelConfig
from ..models.model import Model, check_served, init_caches, init_sharded
from ..serve.step import make_decode_step, make_prefill_step
from .mesh import ProcessMesh, init_process_mesh, shutdown_process_mesh


@dataclasses.dataclass
class ServeRun:
    """What one :func:`run` served, and its times (host clock around work
    that ends in a device synchronise)."""

    model: Model
    batch: Dict[str, torch.Tensor]  # tokens (B, prompt_len); VLM: patches;
                                    # encoder-decoder: frames
    caches: List                    # filled up to position `pos`
    tokens: torch.Tensor            # (B, gen) int32: greedy, prefill's first
    prefill_logits: torch.Tensor    # (B, vocab) f32 of the last position
    first_decode_logits: torch.Tensor  # (B, vocab) f32 of the first step
    logits_finite: bool             # every logit of the run was finite
    pos: int                        # the next free cache position
    max_len: int
    prefill_s: float
    decode_s: float                 # the gen - 1 decode steps
    mesh: Optional[ProcessMesh] = None  # B above: this rank's rows of it

    @property
    def decode_steps(self) -> int:
        return self.tokens.shape[1] - 1


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cfg: ModelConfig, batch: int, prompt_len: int, gen: int,
        device="cuda", patches: Optional[torch.Tensor] = None,
        seed: int = 0, mesh=None, backend: Optional[str] = None,
        max_len: Optional[int] = None) -> ServeRun:
    """Serve ``batch`` requests of ``prompt_len`` tokens (and, for the VLM,
    ``patches`` (batch, n_patches, 1024), drawn from ``seed`` when None;
    for the encoder-decoder, frames (batch, enc_seq, 128) drawn from
    ``seed``): one prefill, then ``gen - 1`` greedy decode steps, ``gen``
    tokens a request. Weights come from a ``torch.Generator`` seeded
    ``seed`` on ``device``, prompts from ``numpy`` with the seed.

    ``mesh``: a joined :class:`~repro_torch.launch.mesh.ProcessMesh`, or
    ``(data, model)``, which this call joins over ``backend`` and leaves
    before it returns. Each rank then draws its slice of the same
    weights (``models.model.init_sharded``) and serves its rows of the
    same requests; the run's tensors are this rank's rows.

    ``max_len``: the caches' positions (by default the prompt, the patches,
    the generated tokens and 8 more).
    """
    check_served(cfg)
    own = mesh is not None and not isinstance(mesh, ProcessMesh)
    if own:
        mesh = init_process_mesh(*mesh, backend, device)
    try:
        return _serve(cfg, batch, prompt_len, gen, device, patches, seed,
                      mesh, max_len)
    finally:
        if own:
            shutdown_process_mesh(mesh)


def _serve(cfg, batch, prompt_len, gen, device, patches, seed,
           mesh: Optional[ProcessMesh], max_len: Optional[int]) -> ServeRun:
    dev = mesh.device if mesh is not None else resolve_device(device)
    layout = mesh.layout(cfg, batch) if mesh is not None else None
    n_vis = cfg.n_patches if cfg.frontend == "vision" else 0
    need = prompt_len + gen + n_vis
    max_len = need + 8 if max_len is None else max_len
    if max_len < need:
        raise ValueError(f"a cache of {max_len} positions cannot hold "
                         f"{need}")
    maxpos = max_len if cfg.norm == "layernorm" else 0
    model = init_sharded(torch.Generator(device=dev).manual_seed(seed), cfg,
                         layout, dev, max_positions=maxpos)

    rng = np.random.default_rng(seed)
    inputs = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (batch, prompt_len))).to(
        device=dev, dtype=torch.int32)}
    if cfg.frontend == "vision":
        if patches is None:
            patches = torch.from_numpy(
                rng.normal(0, 1, (batch, cfg.n_patches, 1024))).to(
                torch.bfloat16)
        if tuple(patches.shape) != (batch, cfg.n_patches, 1024):
            raise ValueError(f"patches of shape {tuple(patches.shape)}; "
                             f"{cfg.name} takes "
                             f"{(batch, cfg.n_patches, 1024)}")
        inputs["patches"] = patches.to(dev)
    elif patches is not None:
        raise ValueError(f"{cfg.name} has no vision frontend")
    if cfg.is_encdec:
        inputs["frames"] = torch.from_numpy(
            rng.normal(0, 1, (batch, cfg.enc_seq, 128))).to(
            device=dev, dtype=torch.bfloat16)

    if layout is not None:
        inputs = layout.batch(inputs)
    caches = init_caches(cfg, batch, max_len, dev, layout)
    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg)

    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = prefill(model, inputs, caches)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    finite = torch.isfinite(logits).all()  # on the device: no host read
    prefill_logits = logits[:, -1].float()
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out = [tok]
    pos0 = prompt_len + n_vis
    first = None
    t0 = time.perf_counter()
    for i in range(gen - 1):
        tok, logits, caches = decode(model, tok, pos0 + i, caches)
        finite &= torch.isfinite(logits).all()
        if first is None:
            first = logits[:, -1].float()
        out.append(tok)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return ServeRun(model=model, batch=inputs, caches=caches,
                    tokens=torch.cat(out, dim=1),
                    prefill_logits=prefill_logits, first_decode_logits=first,
                    logits_finite=bool(finite), pos=pos0 + gen - 1,
                    max_len=max_len, prefill_s=t_prefill, decode_s=t_decode,
                    mesh=mesh)


def main(argv: Optional[List[str]] = None) -> ServeRun:
    from ..configs import ARCH_IDS, get_smoke_config

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="llama3-8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    ap.add_argument("--jpeg-stream", type=int, default=0, metavar="N",
                    help="dry-run the JPEG input pipeline over N distinct "
                         "batches first and report the streaming decode "
                         "stats (compile-once buckets, warm-step ms)")
    ap.add_argument("--decode-serve", type=int, default=0, metavar="N",
                    help="dry-run the continuous-batching decode service "
                         "with N open-loop requests first and report its "
                         "serve stats (occupancy, deadline misses, "
                         "admitted buckets)")
    ap.add_argument("--serve-rate", type=float, default=0.0, metavar="IPS",
                    help="Poisson arrival rate for --decode-serve "
                         "(images/sec; 0 = saturated backlog drain)")
    ap.add_argument("--serve-slo", type=float, default=250.0, metavar="MS",
                    help="per-request deadline for --decode-serve")
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
                    help="serve across D x M processes, one a rank, each "
                         "holding its slice of the weights (started once a "
                         "process: torchrun or launch.mesh.run_ranks)")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                    help="the process group's backend, which --mesh of "
                         "more than one rank needs: nccl (a card a rank) "
                         "or gloo (the CPU, or ranks sharing a card)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    from .mesh import parse_mesh
    from .multihost import (init_distributed, process_info,
                            shutdown_distributed)
    data, model = parse_mesh(args.mesh) if args.mesh else (1, 1)
    pm = None
    if data * model > 1:
        pm = init_process_mesh(data, model, args.dist_backend, args.device,
                               coordinator=args.coordinator,
                               rank=args.process_id)
        ctx = process_info()
    else:
        ctx = init_distributed(args.coordinator, args.processes,
                               args.process_id)
    try:
        if args.jpeg_stream:
            from .report import jpeg_stream_dryrun, render_decode_stats
            stats = jpeg_stream_dryrun(args.jpeg_stream,
                                       batch_size=args.batch,
                                       device=args.device, ctx=ctx)
            if ctx.is_main:
                print(render_decode_stats(stats), flush=True)

        if args.decode_serve and ctx.is_main:
            from .report import decode_serve_dryrun, render_serve_stats
            sstats, load = decode_serve_dryrun(args.decode_serve,
                                               batch_size=args.batch,
                                               rate_ips=args.serve_rate,
                                               slo_ms=args.serve_slo,
                                               device=args.device)
            print(render_serve_stats(sstats, load), flush=True)

        r = run(cfg, args.batch, args.prompt_len, args.gen, args.device,
                mesh=pm)
    finally:
        if pm is not None:
            shutdown_process_mesh(pm)
        elif ctx.initialized:
            shutdown_distributed()
    if not ctx.is_main:
        return r
    print(f"arch={cfg.name} batch={args.batch} device={r.tokens.device}")
    if pm is not None:
        print(f"mesh data={data} model={model} backend={pm.backend} "
              f"{r.model.layout.report()}")
    print(f"prefill: {args.prompt_len} tokens x {args.batch} in "
          f"{r.prefill_s * 1e3:.1f}ms")
    print(f"decode : {r.decode_steps} steps in {r.decode_s * 1e3:.1f}ms "
          f"({r.decode_steps * args.batch / max(r.decode_s, 1e-9):.1f} "
          f"tok/s)")
    print("sample token ids:", r.tokens[0, :16].tolist())
    return r


if __name__ == "__main__":
    main()
