#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs a
CUDA device and ``nvcc``, and exits non-zero without printing a result
otherwise. Phases, each of which exits non-zero on failure:

1. build: compile every kernel source with nvcc for sm_90a, all at once;
2. kernel parity: each kernel against its plain PyTorch version on the
   full-width batch's plan (exits, the exits of a random half of the lanes
   (the ``idx`` form), streams, coefficients, IDCT samples and the fused
   pixel and color kernels' RGB bit-identical), with each one's time, its
   plain version's time and its bound. The exit, stream and store kernels
   are held with their tables in shared memory and in global memory
   (budget 0), the exit kernel over every lane and at the ``idx`` lanes,
   the store kernel also on a plan of the same frames at chunk_bits=256
   (most units split between lanes); stream kernel + scatter against the
   plain write pass and the store kernel, with the scatter's time on a
   line of its own; the fused pixel and color kernels also on 4:2:2 and
   4:4:4 batches, the pixel kernel on partial last tiles and with six
   matrices (read from global memory), the color kernel on a crop whose
   width is not a multiple of its run; the IDCT kernel also on partial
   last tiles, with units that mix matrices and with six matrices;
3. oracle: small images through ``decode_batch`` with every sync schedule
   and fuse mode, and a grayscale group; coefficients equal the
   sequential oracle, RGB within 1 of it;
4. full width, at the paper's ``newyork`` setting (1920x1080, 4:2:0,
   q95, chunk_bits=1024): 32 frames (8 distinct, each 4 times) through
   ``decode_batch`` along every path: jacobi with fuse="post", "full" and
   "none", faithful and specmap with "post", sequential with "full", and
   the frames' luma as a grayscale batch with "post" and "none". Every
   launch count is set to 0 just before each path and read just after;
   coefficients equal the plain path's on the card, RGB within 1,
   ``sync_rounds`` the plain path's of the same schedule (sequential: 1),
   and each path launched exactly its kernels. Then each path's warm
   decode time, sync rounds and host checks (cold and warm, beside the
   parent's), and a profile of its device time;
5. the program cache: 8 batches of 8 of the 32 frames, drawn with
   ``--seed``, through ``ParallelDecoder`` on jacobi "post", then "full":
   each key one program allocated once, each batch's coefficients the
   plain path's for its own frames and its RGB within 1; the warm decode
   time, host checks and the device bytes the cache holds;
6. the decode service (``batch_size=8``, ``validate=True``,
   ``fuse="post"``): the 8 distinct frames 8 times each and 4 damaged
   requests (a scan cut mid-segment, a flipped bit in the scan, a mangled
   DQT length, bytes that are not a JPEG), shuffled; each damaged request
   gets the status ``validate_blob`` gives it, each clean one RGB within 1
   of its frame's plain decode. Then images/s, p50/p99 latency,
   occupancy and the cache's allocations at the highest rate the service
   sustains and at half of it;
7. the VLM input pipeline: the frames built by ``build_dataset`` (its
   bytes checked equal to the frames encoded here), each ``--repeat``
   times, through ``JpegVisionPipeline(device="cuda", sync_stats=True)``
   at its defaults (patch 16, embed 1024, jacobi, ``post``) in batches of
   8, then as one batch of all 32. The launch counts are set to 0 before
   the stream and read after it; the RGB behind every batch's tokens is
   within 1 of the plain path's, where it is equal the tokens equal the
   same embedding of the plain RGB, and each bucket allocates one
   program. Then the warm batch's images/s and tokens/s, its device time
   split into decode and patchify + embed by the profiler, its idle
   share, and ``decode_stats()``;
8. lane balance: the 32 frames with ``balance="lpt"`` and
   ``"roundrobin"`` over 4 lane blocks, jacobi ``post`` and ``full``,
   decoded eagerly and then from CUDA graphs: coefficients, RGB and sync
   rounds equal to the identity plan's; the real chunks per block;
8b. the decode over a mesh (``ParallelDecoder.decode_on``): the 32
   frames over a mesh of the one card, over ``Mesh([cuda:0] * 4)`` (four
   lane blocks on one card, exchanging by local copies) and, on a machine
   with several cards, over all of them: jacobi ``post``, ``full`` and
   ``none``, faithful and specmap ``post``, and jacobi ``post`` on an
   ``lpt`` plan over 4 blocks, each decoded eagerly and then from each
   block's round graphs; coefficients, RGB, ``sync_rounds`` and
   ``converged`` equal (``torch.equal``) to ``decode()`` of the same
   plan, every block with lanes launched the exit kernel and every block
   with images the pixel kernel. Prints each decode's warm ms beside
   ``decode()``'s, lanes and rows per block, host checks, graph replays,
   exchange bytes a round and in all, peer access and the launches per
   block;
9. two processes: ``decode_multihost`` in two subprocesses over a
   ``TCPStore`` on localhost (this script with ``--mp-rank``; a hard
   timeout kills both), each decoding its half of the frames on
   ``cuda:{rank % device_count}``: jacobi ``post`` with RGB, sequential
   ``full`` (the chunk-size vote), and validated with one damaged blob on
   the last process. Coefficients equal each process's slice of the
   single-process plain decode, RGB within 1; each process's warm decode
   and exchange times;
10. the kernel verifier (``repro_torch.analysis.kernel_check``): the host
   geometry of every launch candidate on every ladder rung; then phase
   2's batch (``newyork`` at chunk_bits=1024; the store kernel also at
   256; the pixel and color kernels also at 4:2:2, 4:4:4 and on the
   crop) through the checked build of every kernel (built with the
   release libraries in phase 1) under each of its launches among the
   candidate ``LaunchConfig``s: an empty bounds record, every IDCT,
   pixel and color output element written once, and output
   ``torch.equal`` to the release build's and the plain version's; each
   kernel's checked-build time beside its release time. Then the
   self-test: the seeded faults S1 (off-by-one row read), S2 (short copy
   grid) and S3 (the pixel kernel on a misaligned tile) on the card and a
   duplicate-index scatter, each caught by its family, and each seed
   against its plain version;
10b. the traced-program checker (``repro_torch.analysis.trace_check``,
   ``python -m repro_torch.analysis contracts``) over the card's grid: the
   JAX checker's tier-0 cells (two small batches times the four syncs,
   and a ``roundrobin`` flip) on the kernels, the small one on the plain
   backend on the card, and the 32 frames at full width on the kernels
   (jacobi with every fuse mode, faithful and specmap ``post``,
   sequential ``full``, an ``lpt`` flip over 4 lane blocks), each decoded
   cold, warm (capturing the round graphs) and as a second batch of its
   bucket: the lane-graph taint of every aten op and kernel launch, no
   float64 and no host read but the sync loops' own host checks in the
   entropy stage, every captured graph read node by node (kernels,
   memsets and device copies only; two exit-kernel nodes, whose pointers
   are the program's buffers before every replay), no output aliasing a
   program buffer, the int32 lattice; 0 violations, and every seeded
   fault caught by its own contract. Prints each cell, the nodes of each
   graph by kind, each full-width cell's warm decode ms with and without
   the tracker, and the phase's seconds;
11. the launch autotuner (``repro_torch.kernels.autotune``): the measured
   search on the ``newyork`` bucket for jacobi ``post`` and ``full``, the
   table in a temporary directory: each candidate's warm decode ms (3 in
   turns) and sync rounds, which must be the default's; the winner's
   coefficients and RGB equal to the default's; a second resolution
   reads the table and measures nothing; the losers' programs freed.
   Then the store kernel's ``lane`` and ``warp`` writers at 32 lanes
   (sequential), 208,960 and 835,776 lanes;
12. LM/VLM serving (``repro_torch.models``, ``repro_torch.launch.serve``):
   the five served archs' smoke configs in f32 (TF32 off), built on the
   CPU from ``--seed`` and copied to the card, prefill and 8 decode
   steps on both, logits within rtol 1e-4, atol 5e-4 with the KV cache
   in f32 on both sides and within rtol 0.08, atol 0.15 with the bf16
   cache, greedy tokens equal where the top-2 margin exceeds the
   tolerance; then llava-next-mistral-7b
   at full width through ``launch.serve.run`` (bf16 weights drawn on the
   card from ``--seed``): 4 requests, each a 1920x384 4:2:0 frame decoded
   by ``JpegVisionPipeline(patch=16, embed_dim=1024)`` on the card into
   its 2,880 patch tokens (B1, B2, B4; the launch counts set to 0 before
   the requests and read after), and a 64-token prompt; a prefill of
   11,776 tokens and 31 greedy decode steps (32 tokens). Checks: the
   patch tokens equal the embedding of the plain-path RGB, every logit is
   finite, the first decode step's logits are within rtol 0.08, atol 0.15
   of a prefill of prompt + token. Prints the prefill ms, decode ms a
   step, tokens/s, peak memory, the decode loop's idle share, the top
   kernels of a prefill and of 4 decode steps, and each figure's bound;
13. MoE, MLA, SSD and encoder-decoder serving: 13a as 12a for
   deepseek-v2, deepseek-v3, mamba2, jamba and whisper (every floating
   cache tensor in f32, jamba within atol 2e-3; the MoE archs' prefill
   routing equal, card against CPU; the encoder-decoder's frames drawn
   from ``--seed``); 13b three archs at full width through
   ``launch.serve.run`` (bf16 weights drawn on the card from ``--seed``),
   4 requests of 32 generated tokens each: deepseek-v2-236b at its
   published widths with 7 of its 60 layers (``n_periods=6``: 25.22 B
   parameters) and 512-token prompts; mamba2-780m whole with 2,048-token
   prompts (8 SSD chunks); whisper-base whole over 1,500 frames with
   64-token prompts. Checks every logit finite and, for mamba2, the first
   decode step within rtol 0.08, atol 0.15 of a prefill of prompt +
   token (deepseek's and whisper's gaps reported: see ``FAMILY_RUNS``).
   Prints each run's prefill ms, decode ms a step,
   tokens/s, peak memory, decode idle share, top kernels and bounds, and
   deepseek's dropped_frac at prefill. Phase 13 launches no kernel of
   the port: no Pallas kernel lies on these paths;
14. training (``repro_torch.train``, ``repro_torch.launch.train``), after
   phase 13's models are freed: 14a each of the ten archs' smoke config
   in f32 (TF32 off), built on the CPU from ``--seed`` and copied to the
   card, the same ``SyntheticTokens`` batch on both: ``forward_train``'s
   loss within rtol 1e-5 and every gradient within 1e-3 of its leaf's
   largest value, the MoE routing equal, card against CPU; then one
   ``make_train_step`` step on each (lr 1e-3): loss, grad norm (within
   1e-3) and every parameter (within 2 x lr) after it; 14b the launcher
   as users run it (``launch.train.main`` with ``--arch llama3-8b
   --preset 100m --steps 12 --batch 8 --seq 256 --microbatches 2
   --save-every 6``), then its step-12 checkpoint removed and the same
   command with ``--resume auto``: the restored parameters and optimizer
   state equal the saved ones bit for bit, steps 6-11 rerun with losses
   within rtol 1e-3 of the uninterrupted run's; step times and the
   straggler count; 14c llava-next-mistral-7b at full width (32 layers,
   7.26 B bf16 parameters drawn on the card from ``--seed``) trained with
   AdamW (bf16 moments, lr 1e-4, constant schedule, remat ``full``) on
   batches of 2 requests, each a 1920x384 q95 frame decoded by
   ``JpegVisionPipeline`` on the card into 2,880 patch tokens (B1, B2,
   B4 launched every step) and 64 text tokens: steps 1-3 on fresh
   frames, step 4 on step 3's batch again, whose loss must fall. Prints
   the memory reckoned from the shapes before the run, each step's split
   (decode + patchify + embed, forward + backward, optimizer by events),
   the warm step's wall and busy ms, idle share, positions/s and label
   tokens/s, grad norms, peak memory, the top kernels and the bound;
15. serving across ranks (``launch.mesh``, ``dist.plan.ShardLayout``,
   ``dist.tensor_parallel``), after phase 14's models are freed: each
   case served unsharded on the card (its logits and MoE routing kept on
   the host, its model freed), then by two processes over ``model=2``
   (``launch.mesh.run_ranks``; gloo on ``cuda:0`` on a machine of one
   card, NCCL on two cards where it has them), each rank drawing its
   slice of the same weights (``init_sharded``) and fed the unsharded
   run's tokens: 15a the five dense GQA archs' smoke configs in f32,
   logits within rtol 1e-4, atol 5e-4 of the unsharded run's; 15b
   command-r-plus-104b at its published widths with 2 of its 64 layers
   (9.45 B parameters); 15c the other five archs' smoke configs (MoE,
   MLA, SSD, the encoder-decoder) in f32 as 15a (jamba's atol 2e-3, as
   phase 13's), every MoE layer's routing equal on both ranks and to the
   unsharded run's; 15d jamba-v0.1-52b at its published widths with 1
   of its 4 periods (8 layers, 13.27 B parameters) in f32; 15b and 15d
   with 2 requests of 128 tokens and 4 steps, logits normwise within
   ``TP_NORM_TOL`` (15b) and ``TP_F32_NORM_TOL`` (15d). Both ranks'
   logits and routing equal, greedy tokens
   equal where the unsharded run's margin is clear. Prints the backend,
   the cards, what each layout splits, each rank's draw and serve times
   and peak memory, the differences in bf16 ulps and the MoE layers'
   largest ``dropped_frac``;
16. training across ranks (``dist.plan.grad_classes``,
   ``train.step.exchange_grads``, ``train.checkpoint``,
   ``train.step.make_pipelined_forward``), two processes on the card
   over gloo (``launch.mesh.run_ranks``; NCCL refuses two ranks on one
   card): 16a each arch's smoke config in f32 (TF32 off) over model=2 and
   16b llama3-8b's and deepseek-v2's (capacity 0.5, 96 positions a row:
   experts overflow) over data=2, each rank drawing its slice of the
   same weights and its rows of the same batch, one ``make_train_step``
   step held against the unsplit run on the card: the loss, every joined
   gradient (normwise), the grad norm, the joined moments and parameters
   after the step, each MoE layer call's routing and ``dropped_frac``;
   what the ranks hold whole (16b: everything) bit-identical on both;
   16c ``python -m repro_torch.launch.train --mesh model=2`` with
   checkpoints every 2 steps, its last removed, then ``--resume auto``
   over ``--mesh data=2``: steps 2-3 rerun from the step-2 checkpoint,
   losses within ``RESUME_RTOL``; 16d the pipelined forward over 2
   stages against the whole forward on the card, then its backward
   (llama3-8b's and gemma-7b's smoke configs, remat ``full``) against the
   unsplit backward of the same microbatches: each gradient within
   ``TT_PIPE_GRAD_TOL`` of its leaf's largest, the whole leaves
   bit-identical on both stages. Prints each case's largest differences
   and the phase's seconds. No kernel of the port
   lies on these paths;
17. the dry run (``repro_torch.launch.dryrun``) against phase 14c's
   measured step: ``lower_cell`` of the same llava-next-mistral-7b train
   step (its batch and positions, AdamW with bf16 moments) on the
   ``meta`` device, one rank; its reckoned peak a card within 0.95-1.25
   of phase 14c's ``torch.cuda.max_memory_allocated``. Prints both,
   the dry run's bf16 and f32 FLOPs beside ``tools/tp_train.step_flops``'
   and phase 14c's bound, its roofline against the H100's datasheet
   peaks, the phase's seconds and the card's name and power limit. It
   launches no kernel.

``launches`` in the kernel record counts phase 4's paths, phase 7's
stream, phase 8b's mesh decodes, phase 12's requests and phase 14c's steps, and for the seeds
S1-S3 phase 10's self-test. The line before the
last is the per-kernel JSON record; the last line is ``{"ok": true,
"device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
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
# host checks a decode of the default newyork batch made before the sync
# loops ran in blocks (one a round; PERF.md section 5)
PARENT_HOST_CHECKS = {"jacobi": 27, "faithful": 54}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


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


# -- phase 8b: the decode over a mesh ------------------------------------------

# (label, sync, fuse, balance) of phase 8b; lpt balances over 4 blocks
MESH_PATHS = (("jacobi/post", "jacobi", "post", "none"),
              ("jacobi/full", "jacobi", "full", "none"),
              ("jacobi/none", "jacobi", "none", "none"),
              ("faithful/post", "faithful", "post", "none"),
              ("specmap/post", "specmap", "post", "none"),
              ("jacobi/post lpt", "jacobi", "post", "lpt"))


def mesh_decodes(args, blobs, gpu, counters, kernels) -> None:
    """Phase 8b: ``decode_on`` over a mesh of the one card, over four
    blocks of it and, where the machine has several, over its cards, on
    every path of ``MESH_PATHS``; each held ``torch.equal`` to
    ``decode()`` of the same plan with equal rounds."""
    from repro_torch.core.api import ParallelDecoder
    from repro_torch.launch.mesh import Mesh, make_host_mesh
    import repro_torch.core.api as api

    t_phase = time.perf_counter()
    meshes = [Mesh([gpu]), Mesh([gpu] * 4)]
    if torch.cuda.device_count() >= 2:
        meshes.append(make_host_mesh())
    for label, sync, fuse, balance in MESH_PATHS:
        dec = ParallelDecoder.from_bytes(
            blobs, chunk_bits=args.chunk_bits, sync=sync, fuse=fuse,
            balance=balance, lanes=4 if balance != "none" else None)
        ref = dec.decode()
        single = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dec.decode()
            torch.cuda.synchronize()
            single.append((time.perf_counter() - t0) * 1e3)
        for mesh in meshes:
            for fn, attr in counters.values():
                setattr(fn, attr, 0)
            outs = [dec.decode_on(mesh) for _ in range(2)]
            torch.cuda.synchronize()
            counts = {k: getattr(fn, attr)
                      for k, (fn, attr) in counters.items()}
            for rec in kernels:
                rec["launches"] += counts[rec["name"]]
            what = f"phase 8b: {label} on {mesh.size} block(s) of " \
                f"{len(set(mesh.devices.flat))} card(s)"
            for out in outs:
                check(torch.equal(out.coeffs.full(gpu), ref.coeffs)
                      and torch.equal(out.rgb.full(gpu), ref.rgb)
                      and out.sync_rounds == ref.sync_rounds
                      and out.converged == ref.converged,
                      f"{what}: differs from decode()")
            m = outs[-1].mesh
            if mesh.size > 1:
                for b, (n, launched, rows) in enumerate(zip(
                        m["lanes"], m["launches"], m["rows"])):
                    check(not n or launched.get("huffman_exits", 0) > 0,
                          f"{what}: block {b} launched no exit kernel")
                    pix = "idct" if fuse == "none" else "fused_pixels"
                    check(rows[0] == rows[1] or launched.get(pix, 0) > 0,
                          f"{what}: block {b} launched no {pix}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = dec.decode_on(mesh)
            torch.cuda.synchronize()
            warm = (time.perf_counter() - t0) * 1e3
            m = out.mesh
            launches = m.get("launches") or []
            print(f"[mesh] {label} on {mesh}: equal to decode() "
                  f"({out.sync_rounds} rounds); warm {warm:.2f} ms "
                  f"(decode() {statistics.median(single):.2f} ms); lanes "
                  f"{m.get('lanes')}, rows {m.get('rows')}; host checks "
                  f"{m['host_checks']}, graph replays {m['graph_replays']}; "
                  f"exchange {m.get('round_bytes', 0)} B a round, "
                  f"{m.get('copy_bytes', {})} B in all; peer access "
                  f"{m.get('peer_access', {})}; launches per block "
                  + "; ".join(", ".join(f"{k} {v}" for k, v in
                                        sorted(d.items()) if v)
                              for d in launches), flush=True)
            del outs, out
        del dec, ref
        api.clear_decode_programs()
    print(f"[mesh] phase 8b {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# -- phase 9: decode_multihost in two processes on the card -------------------

N_PROCS = 2
PROC_TIMEOUT_S = 600
# the pipeline phase's batch size (a training step's images)
STREAM_BATCH = 8


def process_worker(args) -> None:
    """One process of phase 9 (``--mp-rank``): joins the store from the
    ``REPRO_*`` variables, takes its ``HostFeed`` half of the frames and
    decodes them with ``decode_multihost`` three ways; prints one
    ``RESULT`` line and saves its RGB for the parent to compare."""
    import hashlib
    import pickle
    sys.path.insert(0, str(SRC))
    from repro_torch.launch.multihost import (HostFeed, decode_multihost,
                                              init_distributed,
                                              shutdown_distributed)
    work = Path(args.mp_dir)
    with open(work / "blobs.pkl", "rb") as f:  # written by the parent
        blobs, bad_at = pickle.load(f)
    ctx = init_distributed(timeout_s=120)
    local = HostFeed.from_corpus(blobs, ctx).local_blobs
    cases = {}

    def run(name, feed, reps, **kw):
        outs, ms = [], []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = decode_multihost(feed, ctx, chunk_bits=args.chunk_bits,
                                   **kw)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            outs.append(out)
        out = outs[-1]
        co = out.local.coeffs.cpu().numpy()
        cases[name] = {
            "digest": hashlib.sha256(co.tobytes()).hexdigest(),
            "ms": ms, "exchange_ms": [o.exchange_ms for o in outs],
            "units": out.unit_counts, "offset": out.global_coeffs.offset,
            "compiles": out.compiles, "bucket": out.shape.label(),
            "device": str(out.local.coeffs.device),
            "converged": bool(out.local.converged),
            "status": (None if out.status is None
                       else [int(v) for v in out.status]),
            "host_statuses": out.host_statuses}
        return out

    out = run("jacobi/post", local, 1 + max(2, args.reps // 2), emit="rgb")
    torch.save(out.local.rgb.cpu(), work / f"rgb{ctx.process_id}.pt")
    del out
    run("sequential/full", local, 1, sync="sequential", fuse="full")
    feed = list(local)
    if ctx.process_id == N_PROCS - 1:
        bad = bytearray(feed[bad_at])
        bad[4:6] = b"\x00\x00"  # APP0 length 0: the image is rejected
        feed[bad_at] = bytes(bad)
    run("validated", feed, 1, validate=True)
    print("RESULT " + json.dumps({"rank": ctx.process_id, "cases": cases}),
          flush=True)
    shutdown_distributed()


def run_processes(args, blobs, plain_coeffs, plain_rgb) -> None:
    """Phase 9: two processes, each decoding its half of the frames on
    ``cuda:{rank % device_count}`` (both on one card here); every one's
    coefficients must equal its slice of the single-process plain decode
    and its RGB be within 1 of it. A failure or a timeout of either
    process fails the run."""
    import hashlib
    import pickle
    import socket
    import tempfile
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    per = len(blobs) // N_PROCS
    rows = plain_coeffs.shape[0] // len(blobs)
    bad_at = 5 % per
    with tempfile.TemporaryDirectory() as work:
        with open(Path(work) / "blobs.pkl", "wb") as f:
            pickle.dump((blobs, bad_at), f)
        procs = []
        for rank in range(N_PROCS):
            env = dict(os.environ, REPRO_COORDINATOR=f"127.0.0.1:{port}",
                       REPRO_NUM_PROCESSES=str(N_PROCS),
                       REPRO_PROCESS_ID=str(rank))
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--mp-rank", str(rank), "--mp-dir", work,
                 "--chunk-bits", str(args.chunk_bits),
                 "--reps", str(args.reps)], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        deadline = time.monotonic() + PROC_TIMEOUT_S
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))[0])
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            for p in procs:
                p.wait()
            fail(f"phase 9: a process did not finish in {PROC_TIMEOUT_S} s")
        results = []
        for rank, (p, out) in enumerate(zip(procs, outs)):
            lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
            if p.returncode != 0 or not lines:
                print(out[-4000:])
                fail(f"phase 9: process {rank} exited {p.returncode}")
            results.append(json.loads(lines[-1][len("RESULT "):]))
        rgbs = [torch.load(Path(work) / f"rgb{r}.pt") for r in range(N_PROCS)]
    for rank, (res, rgb) in enumerate(zip(results, rgbs)):
        lo = rank * per
        exp = plain_coeffs[lo * rows:(lo + per) * rows].cpu().numpy()
        want = hashlib.sha256(exp.tobytes()).hexdigest()
        cases = res["cases"]
        for name in ("jacobi/post", "sequential/full"):
            c = cases[name]
            check(c["digest"] == want and c["converged"], f"phase 9: process "
                  f"{rank}'s {name} coefficients differ from its slice of "
                  f"the single-process decode")
            check(c["offset"] == lo * rows and c["compiles"] == 1,
                  f"phase 9: process {rank}'s {name} offset or allocations")
        check(cases["jacobi/post"]["device"] ==
              f"cuda:{rank % torch.cuda.device_count()}",
              f"phase 9: process {rank} decoded on "
              f"{cases['jacobi/post']['device']}")
        d = (rgb.to(torch.int16)
             - plain_rgb[lo:lo + per].cpu().to(torch.int16)).abs()
        check(int(d.max()) <= 1, f"phase 9: process {rank}'s RGB differs "
              f"from the single-process decode by {int(d.max())}")
        v = cases["validated"]
        status = [0] * per
        if rank == N_PROCS - 1:
            exp[bad_at * rows:(bad_at + 1) * rows] = 0
            status[bad_at] = 2
        check(v["status"] == status and v["digest"] == hashlib.sha256(
            exp.tobytes()).hexdigest(), f"phase 9: process {rank}'s "
              f"validated decode differs")
        check(len({r["cases"]["jacobi/post"]["bucket"] for r in results})
              == 1, "phase 9: the processes decoded in different buckets")
        c = cases["jacobi/post"]
        warm = statistics.median(c["ms"][1:])
        xms = statistics.median(c["exchange_ms"][1:])
        print(f"[procs] process {rank} on {c['device']}: {per} frames, "
              f"coefficients equal its slice of the single-process decode "
              f"(jacobi/post, sequential/full with the chunk-size vote "
              f"{cases['sequential/full']['bucket'].split(':cb')[1]} bits), "
              f"RGB within {int(d.max())} ({int((d == 1).sum())} samples off "
              f"by one); warm decode_multihost {warm:.1f} ms (cold "
              f"{c['ms'][0]:.1f}), exchanges {xms:.2f} ms of it; validated "
              f"with a damaged blob: statuses {v['host_statuses']}",
              flush=True)


# -- phase 10: the kernel verifier --------------------------------------------

# the seeds: (name, source, the JAX verifier's pallas_call it replaces)
SEEDS = (("seed_oob_rows", "src/repro_torch/kernels/csrc/seeds.cu",
          "src/repro/analysis/kernel_check.py:1706"),
         ("seed_ident", "src/repro_torch/kernels/csrc/seeds.cu",
          "src/repro/analysis/kernel_check.py:1738"),
         ("seed_misaligned_tile", "src/repro_torch/kernels/csrc/pixels.cu",
          "src/repro/analysis/kernel_check.py:1760"))


def verify_kernels(args, blobs, layouts, gpu) -> list:
    """Phase 10; returns the seeds' kernel records."""
    from repro_torch.analysis import kernel_check as K
    from repro_torch.core.api import ParallelDecoder
    from repro_torch.kernels import seeds as S

    t0 = time.perf_counter()
    vs, cells = K.check_geometry()
    check(not vs, "phase 10: host geometry: "
          + "; ".join(v.format() for v in vs[:5]))
    print(f"[verify] host geometry (csrc/geometry.cuh built with g++): "
          f"{cells} cells, every candidate on every ladder rung up to "
          f"{K.MAX_LANES} lanes and {K.MAX_UNITS} units, 0 violations "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    dec = ParallelDecoder.from_bytes(blobs, chunk_bits=args.chunk_bits,
                                     device=gpu)
    others = [ParallelDecoder.from_bytes(b, chunk_bits=args.chunk_bits,
                                         device=gpu)
              for b in layouts.values()]
    g = dec.plan.geometry
    timings = {}
    vs, n, refused = K.verify_batch(
        dec, "newyork", layouts=others, crops=[(g.height - 2, g.width - 2)],
        timings=timings, time_fn=lambda fn: cuda_ms(fn, args.reps))
    del dec, others
    dec256 = ParallelDecoder.from_bytes(blobs, chunk_bits=256, device=gpu)
    vs256, n256, refused256 = K.verify_batch(dec256, "newyork@256",
                                             only=["huffman_store"])
    del dec256
    torch.cuda.empty_cache()
    vs += vs256
    for v in vs[:20]:
        print(f"[verify] {v.format()}")
    check(not vs, f"phase 10: {len(vs)} violations in the checked build")
    check(not refused + refused256, f"phase 10: launches refused: "
          f"{refused + refused256}")
    print(f"[verify] checked build: {n + n256} launches of the six kernels "
          f"under every launch candidate on newyork (1024-bit chunks; the "
          f"store kernel also at 256; pixels and color also at 4:2:2, "
          f"4:4:4 and a {g.width - 2}x{g.height - 2} crop): 0 bounds "
          f"violations, every IDCT, pixel and color output element written "
          f"once, outputs equal to the release build's and the plain "
          f"versions' ({time.perf_counter() - t0:.1f} s)", flush=True)
    for name, (checked_ms, release_ms) in timings.items():
        print(f"[verify] {name}: checked build {checked_ms:.4f} ms, release "
              f"{release_ms:.4f} ms ({checked_ms / release_ms:.2f}x)",
              flush=True)

    # the self-test, its launches counted
    for fn in (S.seed_oob_rows, S.seed_ident, S.seed_misaligned_tile):
        fn.launches = 0
    failures, caught = K.run_self_test(device="cuda", seed=args.seed)
    counts = S.launch_counts()
    check(not failures, f"phase 10: self-test: {failures}")
    check(all(counts.values()), f"phase 10: a seed was not launched in the "
          f"self-test: {counts}")
    for v in caught:
        print(f"[verify] self-test caught: {v.format()}", flush=True)
    # each seed against its plain version, timed
    rng = np.random.default_rng(args.seed)
    x = torch.from_numpy(rng.integers(-8, 9, (S.ROWS, S.COLS)).astype(
        np.float32)).to(gpu)
    y = torch.from_numpy(rng.integers(-8, 9, S.IDENT_N).astype(
        np.float32)).to(gpu)
    coeffs, m_t, mrow, geo = S.seed_pixel_operands(gpu, args.seed)
    # S3's grid covers TILE_BLOCKS tiles of TILE_MCUS MCUs: the bound
    # counts the units it reads and the MCUs it writes, not the whole frame
    s3_mcus = S.TILE_MCUS * S.TILE_BLOCKS
    s3_units = s3_mcus * geo["upm"]
    s3_mcu_bytes = 64 * geo["v_max"] * geo["h_max"] * 3

    def s1_plain():
        try:
            return S.seed_oob_rows_plain(x)
        except IndexError:
            return None

    cases = [
        (lambda: S.seed_oob_rows(x),
         lambda: S.seed_oob_rows_plain(x, strict=False), s1_plain,
         nbytes(x) + 4, S.ROWS * S.COLS, lambda: x[1:].sum()),
        (lambda: S.seed_ident(y), lambda: S.seed_ident_plain(y)[0],
         lambda: S.seed_ident_plain(y), 2 * nbytes(y), 0,
         lambda: torch.zeros_like(y)[:8].copy_(y[:8])),
        (lambda: S.seed_misaligned_tile(coeffs, m_t, mrow, **geo),
         lambda: S.seed_misaligned_tile_plain(coeffs, m_t, mrow, **geo)[0],
         lambda: S.seed_misaligned_tile_plain(coeffs, m_t, mrow, **geo),
         nbytes(coeffs[:s3_units], m_t, mrow[:s3_units])
         + s3_mcus * s3_mcu_bytes, 2 * s3_units * 64 * 64, None),
    ]
    records = []
    for (name, source, replaces), (kern, plain, timed_plain, moved, ops,
                                    lib) in zip(SEEDS, cases):
        got, exp = kern(), plain()
        torch.cuda.synchronize()
        err = float((got.float() - exp.float()).abs().max())
        check(err == 0, f"phase 10: {name} differs from its plain version "
              f"by {err}")
        ms = cuda_ms(kern, args.reps)
        plain_ms = cuda_ms(timed_plain, args.reps)
        lib_ms = cuda_ms(lib, args.reps) if lib is not None else None
        b_ms, b_by = bound(moved, ops, F32_FLOP_PER_S)
        records.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=counts[name],
                            max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
        print(f"[verify] {name} (checked build): {counts[name]} launches in "
              f"the self-test, max_abs_err {err} against its plain version, "
              f"{ms:.4f} ms (plain {plain_ms:.4f} ms, bound {b_ms:.6f} ms "
              f"by {b_by}"
              + ("" if lib_ms is None else f", library {lib_ms:.4f} ms")
              + ")", flush=True)
    return records


# -- phase 10b: the traced-program checker -------------------------------------

# the seeds of trace_check.run_self_test on the card
TRACE_SEEDS = {"gather-creep", "float64 op", ".item() in a sync round",
               "returned work-buffer view",
               "buffer reallocated after capture",
               "device-to-host copy in a graph", "skipped halo edge",
               "output aliasing a block's buffer"}


def check_traces(blobs, gpu) -> None:
    """Phase 10b: ``trace_check`` over the card's grid, the full-width
    cells on ``blobs``, with its self-test."""
    from repro_torch.analysis import trace_check as T

    t0 = time.perf_counter()
    report = T.check(device=gpu, self_test=True, newyork=blobs)
    for line in report.lines(verbose=True):
        print(f"[contracts] {line}", flush=True)
    check(report.ok, f"phase 10b: {len(report.violations)} contract "
          f"violations; seeds not caught: {report.failures}")
    caught = {v.cell for v in report.caught}
    check(caught == TRACE_SEEDS, f"phase 10b: seeds caught {sorted(caught)}")
    check(len(report.meshes) == 2 and all(m.graphs for m in report.meshes),
          f"phase 10b: the mesh contracts ran on {len(report.meshes)} mesh "
          f"cells and read {[m.graphs for m in report.meshes]} graphs")
    graphs = 0
    for r in report.cells:
        if r.cell.full_width and r.cell.sync == "jacobi":
            check(r.graphs and r.replays, f"phase 10b: {r.label} read no "
                  f"graph or audited no replay")
        for g in r.graphs:
            graphs += 1
            check(set(g) <= T.GRAPH_NODE_KINDS, f"phase 10b: {r.label}: "
                  f"graph nodes {g}")
            if r.cell.backend == "cuda":
                check(g.get("exit kernel") == T.EXIT_NODES_PER_GRAPH,
                      f"phase 10b: {r.label}: graph nodes {g}")
    print(f"[contracts] {len(report.cells)} cells, {graphs} graphs read "
          f"node by node, {sum(r.replays for r in report.cells)} replays "
          f"audited, {len(report.caught)} seeded faults caught; phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


# -- phase 11: the launch autotuner -----------------------------------------

def tune_launch(args, blobs, gpu) -> None:
    from repro_torch.core import api
    from repro_torch.core import decode as D
    from repro_torch.core.api import ParallelDecoder
    from repro_torch.core.sync import chain_entries, jacobi_sync
    from repro_torch.kernels import autotune as AT
    from repro_torch.kernels.fused import store as FS
    from repro_torch.kernels.huffman import ops as HK

    with tempfile.TemporaryDirectory() as tmp:
        os.environ[AT.TABLE_ENV] = str(Path(tmp) / "launch.json")
        os.environ.pop(AT.LAUNCH_ENV, None)
        AT.clear_launch_cache()
        base = ParallelDecoder.from_bytes(blobs, chunk_bits=args.chunk_bits,
                                          device=gpu,
                                          launch=AT.DEFAULT_LAUNCH)
        for fuse in ("post", "full"):
            t0 = time.perf_counter()
            decs, rounds, checks, times = {}, {}, {}, {}

            def measure(cfg):
                d = decs.get(cfg)
                if d is None:
                    d = decs[cfg] = ParallelDecoder(
                        base.plan, fuse=fuse, device=gpu, shape=base.shape,
                        launch=cfg)
                    for _ in range(2):  # eager, then the graphs' capture
                        d.decode()
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = d.decode()
                torch.cuda.synchronize()
                dt = time.perf_counter() - t
                rounds[cfg] = out.sync_rounds
                checks[cfg] = d.launch_stats()["host_checks"]
                times.setdefault(cfg, []).append(dt * 1e3)
                return dt

            win = AT.resolve_launch(base.shape, "cuda", fuse,
                                    measure=measure)
            spent = time.perf_counter() - t0
            check(set(rounds.values()) == {rounds[AT.DEFAULT_LAUNCH]},
                  f"phase 11 {fuse}: sync rounds differ across candidates: "
                  f"{ {c.label(): r for c, r in rounds.items()} }")
            ref, got = decs[AT.DEFAULT_LAUNCH].decode(), decs[win].decode()
            torch.cuda.synchronize()
            check(torch.equal(ref.coeffs, got.coeffs)
                  and torch.equal(ref.rgb, got.rgb), f"phase 11 {fuse}: the "
                  f"winner {win.label()} decodes otherwise than the defaults")
            del ref, got
            AT.clear_launch_cache()

            def never(cfg):
                raise RuntimeError("a tuned bucket measured again")

            check(AT.resolve_launch(base.shape, "cuda", fuse,
                                    measure=never) == win,
                  f"phase 11 {fuse}: the table did not give the winner back")
            print(f"[tune] jacobi/{fuse} on the newyork bucket: "
                  f"{len(decs)} candidates measured "
                  f"{len(times[AT.DEFAULT_LAUNCH])} times each in turns in "
                  f"{spent:.1f} s; winner {win.label()}"
                  f"{' (the default)' if win == AT.DEFAULT_LAUNCH else ''}, "
                  f"its decode equal to the defaults'; a second resolution "
                  f"read the table and measured nothing", flush=True)
            for cfg in sorted(times, key=lambda c: statistics.median(
                    times[c])):
                ts = times[cfg]
                print(f"[tune]   {cfg.label():32s} warm decode "
                      f"{statistics.median(ts):.3f} ms (min {min(ts):.3f}, "
                      f"max {max(ts):.3f}), {rounds[cfg]} sync rounds, "
                      f"{checks[cfg]} host checks", flush=True)
            decs.clear()
            api.discard_decode_programs(lambda p: p.launch != win)
            torch.cuda.empty_cache()
        os.environ.pop(AT.TABLE_ENV, None)
        AT.clear_launch_cache()
    del base
    api.clear_decode_programs()

    # the store kernel's writers at 32 lanes (sequential), and at the
    # newyork batch's 1024- and 256-bit chunks
    line = []
    for label, kw in (("sequential", dict(sync="sequential")),
                      ("1024-bit", dict(chunk_bits=args.chunk_bits)),
                      ("256-bit", dict(chunk_bits=256))):
        dec = ParallelDecoder.from_bytes(blobs, device=gpu, fuse="full",
                                         launch=AT.DEFAULT_LAUNCH, **kw)
        sh, dev = dec.shape, dec.dev
        meta = D.chunk_meta(dev)
        skw = dict(s_max=sh.s_max, min_code_bits=sh.min_code_bits)
        res = jacobi_sync(dev, max_rounds=sh.n_chunks + 2,
                          decode_exits=lambda d, e: HK.run_exit_kernel(
                              d, meta, e, **skw,
                              smem_budget=HK.EXIT_SMEM_BUDGET),
                          permuted=sh.permuted)
        entries = chain_entries(dev, res.exits, sh.permuted)
        bases = D.chunk_write_bases(dev, res.exits.n, permuted=sh.permuted)
        seg_end = torch.cat([dev["seg_coeff_base"][1:],
                             dev["units_end"][None]])
        wmax = seg_end[dev["chunk_seg"].to(torch.int64)] - 1
        outs, ms = {}, {}
        reps = 2 if label == "sequential" else args.reps
        writers = ("lane", "warp") if dec.plan.n_chunks >= 32 else ("lane",)
        for writer in writers:  # the warp writer needs a warp of lanes
            cfg = AT.parse_launch_override(f"writer={writer}")
            run = lambda: FS.run_store_kernel(  # noqa: E731
                dev, meta, entries, bases, wmax, sh.n_units * 64, **skw,
                smem_budget=HK.EXIT_SMEM_BUDGET, launch=cfg)
            outs[writer] = run()
            ms[writer] = cuda_ms(run, reps)
        check(torch.equal(outs["lane"], outs.get("warp", outs["lane"])),
              f"phase 11: the store kernel's writers differ at {label}")
        line.append(f"{dec.plan.n_chunks} lanes ({label}) " + " / ".join(
            f"{w} {t:.3f}" for w, t in ms.items()) + " ms")
        del dec, dev, meta, res, entries, bases, wmax, outs
        torch.cuda.empty_cache()
    print(f"[tune] store kernel writers, zero fill included: "
          + "; ".join(line), flush=True)


# -- phase 12: LM/VLM serving -------------------------------------------------

# the dense decoder-only and VLM archs the port serves
SERVED_ARCHS = ("llava-next-mistral-7b", "llama3-8b", "command-r-plus-104b",
                "gemma-7b", "nemotron-4-15b")
# the JAX package's tolerance for decode against prefill
# (tests/test_models.py), which the CPU tests hold bf16 logits to
LM_TOL = dict(rtol=0.08, atol=0.15)
# f32 logits with the KV cache in f32 on both sides, card against CPU:
# about 3x the largest difference measured on an H100 (1.56e-4,
# command-r-plus-104b; PERF.md section 6, PR 19)
LM_F32_TOL = dict(rtol=1e-4, atol=5e-4)
BF16_FLOP_PER_S = 989e12      # dense bf16 on the tensor cores
# the full-width requests: 4, each one 1920x384 frame (120 x 24 = 2,880
# patches of 16, the model's n_patches) and a 64-token prompt; 32 tokens
# generated (one by the prefill), as launch/serve.py counts them
LM_BATCH, LM_PROMPT, LM_GEN = 4, 64, 32
LM_FRAME = (1920, 384)
LM_PROFILE_STEPS = 4


def lm_close(got: torch.Tensor, exp: torch.Tensor, tol=LM_TOL
             ) -> torch.Tensor:
    """Where ``got`` is within ``tol`` of ``exp``."""
    return (got - exp).abs() <= tol["atol"] + tol["rtol"] * exp.abs()


def f32_caches(caches):
    """Every floating tensor of the model's caches in f32."""
    from repro_torch.models import model as TM

    def one(c):
        return None if c is None else type(c)(*(
            t.float() if isinstance(t, torch.Tensor) and t.is_floating_point()
            else t for t in c))

    return TM.Caches(one(c) for c in caches)


def moe_recorder():
    """(records, restore): while installed, each MoE layer's call appends
    its routing (``idx``, on the CPU) and ``dropped_frac``."""
    from repro_torch.models import model as TM
    moe_ffn, records = TM.moe_ffn, []

    def recorded(p, cfg, x, layout=None):
        y, aux = moe_ffn(p, cfg, x, layout)
        records.append((aux["idx"].cpu(), float(aux["dropped_frac"])))
        return y, aux

    TM.moe_ffn = recorded
    return records, lambda: setattr(TM, "moe_ffn", moe_ffn)


def lm_smoke_parity(args, gpu, archs=SERVED_ARCHS, phase=12,
                    f32_tol=None) -> None:
    """Phase 12a (13a): each arch's smoke config in f32, built once on the
    CPU from ``--seed``, its weights copied to the card; 2 prompts of 24
    positions (and the encoder-decoder's frames), then 8 decode steps, both
    sides fed the CPU's greedy token. Twice: with every floating cache
    tensor in f32, logits within ``LM_F32_TOL`` (or the arch's entry of
    ``f32_tol``) and each MoE layer's prefill routing equal; with the
    config's own caches (which round the f32 keys, values and conv inputs,
    so a last-bit difference can flip a rounding), within ``LM_TOL``. Each
    time the card's greedy token is the CPU's wherever the CPU's top-2
    margin exceeds the tolerance."""
    import copy
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as TM

    def caches(cfg, device, f32):
        cs = TM.init_caches(cfg, 2, 32, device=device)
        return f32_caches(cs) if f32 else cs

    for arch in archs:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                                  param_dtype="float32")
        cpu = TM.init_params(torch.Generator().manual_seed(args.seed), cfg,
                             device="cpu")
        card = copy.deepcopy(cpu).to(gpu)
        rng = np.random.default_rng(args.seed)
        nv = cfg.n_patches if cfg.frontend == "vision" else 0
        batch = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab, (2, 24 - nv))).to(torch.int32)}
        if nv:
            batch["patches"] = torch.from_numpy(
                rng.normal(0, 1, (2, nv, 1024))).to(torch.bfloat16)
        if cfg.is_encdec:
            batch["frames"] = torch.from_numpy(
                rng.normal(0, 1, (2, cfg.enc_seq, 128))).to(torch.bfloat16)
        on_card = {k: v.to(gpu) for k, v in batch.items()}
        line = []
        for f32, tol in ((True, (f32_tol or {}).get(arch, LM_F32_TOL)),
                         (False, LM_TOL)):
            what = f"phase {phase} {arch} ({'f32' if f32 else 'own'} " \
                   f"cache)"
            routes, restore = moe_recorder()
            try:
                lc, cc = TM.forward_prefill(cpu, batch,
                                            caches(cfg, "cpu", f32))
                n_cpu = len(routes)
                lg, cg = TM.forward_prefill(card, on_card,
                                            caches(cfg, gpu, f32))
            finally:
                restore()
            if f32:
                check(len(routes) == 2 * n_cpu and all(
                    torch.equal(a[0], b[0]) and a[1] == b[1] for a, b in
                    zip(routes[:n_cpu], routes[n_cpu:])), f"{what}: the "
                    f"prefill's MoE routing differs between card and CPU")
            worst, sure = 0.0, 0
            for step in range(9):
                exp, got = lc[:, -1].float(), lg[:, -1].float().cpu()
                gap = float((got - exp).abs().max())
                check(bool(lm_close(got, exp, tol).all()), f"{what}: logits "
                      f"on the card differ from the CPU's at step {step} by "
                      f"{gap}")
                worst = max(worst, gap)
                tok = torch.argmax(exp, -1)
                top2 = torch.topk(exp, 2).values
                clear = (top2[:, 0] - top2[:, 1]) > tol["atol"] \
                    + tol["rtol"] * top2[:, 0].abs()
                check(torch.equal(torch.argmax(got, -1)[clear], tok[clear]),
                      f"{what}: a greedy token differs at step {step}")
                sure += int(clear.sum())
                if step == 8:
                    break
                tok = tok[:, None].to(torch.int32)
                lc, cc = TM.forward_decode(cpu, tok, 24 + step, cc)
                lg, cg = TM.forward_decode(card, tok.to(gpu), 24 + step, cg)
            routed = f", prefill routing of {n_cpu} MoE layers equal" \
                if f32 and n_cpu else ""
            line.append(f"{'f32' if f32 else 'own'} cache within rtol "
                        f"{tol['rtol']} atol {tol['atol']} (largest "
                        f"difference {worst:.3g}; greedy tokens equal at "
                        f"the {sure} of 18 positions whose top-2 margin "
                        f"exceeds it{routed})")
        print(f"[serve] smoke {arch} (f32, TF32 off), prefill and 8 decode "
              f"steps, card against CPU: " + "; ".join(line), flush=True)


def profile_rows(fn, top: int = 8, tag: str = "serve"):
    """(device busy ms, wall ms) of one call of ``fn`` under the profiler,
    printing its ``top`` kernel rows by device time."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = sorted(((device_us(e) / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  reverse=True)
    for ms, n, key in rows[:top]:
        print(f"[{tag}]   {ms:9.3f} ms {n:6d}x  {key[:100]}")
    return sum(r[0] for r in rows), wall


def serve_lm(args, gpu, card, counters, kernels) -> None:
    """Phase 12: LM/VLM serving. 12a the smoke parity; 12b
    llava-next-mistral-7b at full width through ``launch.serve.run``, its
    patch tokens from ``JpegVisionPipeline`` on the card (B1, B2, B4)."""
    from repro_torch import decode_batch
    from repro_torch.configs import get_config
    from repro_torch.data.jpeg_pipeline import JpegVisionPipeline
    from repro_torch.jpeg.encoder import DatasetSpec, build_dataset
    from repro_torch.launch import serve as LS
    from repro_torch.models import model as TM

    lm_smoke_parity(args, gpu)

    cfg = get_config("llava-next-mistral-7b")
    w, h = LM_FRAME
    spec = DatasetSpec("llava-requests", LM_BATCH, w, h, args.quality)
    blobs = build_dataset(spec, seed=args.seed).jpeg_bytes
    pipe = JpegVisionPipeline(patch=16, embed_dim=1024, device=gpu,
                              chunk_bits=args.chunk_bits)
    check((h // pipe.patch) * (w // pipe.patch) == cfg.n_patches,
          f"phase 12: {w}x{h} frames do not give {cfg.n_patches} patches")
    plain = decode_batch(blobs, chunk_bits=args.chunk_bits, backend="torch",
                         device=gpu).rgb
    seen = []
    embed = pipe.embed
    pipe.embed = lambda rgb: seen.append(rgb) or embed(rgb)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    t0 = time.perf_counter()
    patches, _ = pipe.patches_for(blobs)
    torch.cuda.synchronize()
    patch_ms = (time.perf_counter() - t0) * 1e3
    r = LS.run(cfg, LM_BATCH, LM_PROMPT, LM_GEN, device=gpu, patches=patches,
               seed=args.seed)
    torch.cuda.synchronize()
    counts = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    for rec in kernels:  # the seeds S1-S3 have no counter
        rec["launches"] += counts.get(rec["name"], 0)
    launched = {k for k, n in counts.items() if n > 0}
    check(launched == {"huffman_exits", "huffman_streams", "fused_pixels"},
          f"phase 12: the requests' decode launched {sorted(launched)}")
    # param_count() leaves out the projector and the final norm
    n_params = sum(p.numel() for p in r.model.parameters())
    check(len(r.model.blocks) == cfg.n_layers and n_params == (
        cfg.param_count() + r.model.vis_proj1.numel()
        + r.model.vis_proj2.numel() + cfg.d_model), f"phase 12: the model "
        f"has {len(r.model.blocks)} layers and {n_params} parameters")

    rgb = seen.pop()
    worst = int((rgb.to(torch.int16) - plain.to(torch.int16)).abs().max())
    exp = embed(plain)
    same = [i for i in range(LM_BATCH) if torch.equal(rgb[i], plain[i])]
    check(worst <= 1 and tuple(patches.shape) == (
        LM_BATCH, cfg.n_patches, 1024) and all(
        torch.equal(patches[i], exp[i]) for i in same),
        f"phase 12: patch tokens {tuple(patches.shape)} differ from the "
        f"embedding of the plain-path RGB (RGB within {worst})")
    check(r.logits_finite, "phase 12: a logit is not finite")
    del rgb, exp, plain
    print(f"[serve] {LM_BATCH} requests, {w}x{h} 4:2:0 q{args.quality} "
          f"frames ({sum(map(len, blobs)) / 1e3:.1f} KB): launches " +
          ", ".join(f"{k} {n}" for k, n in counts.items() if n) +
          f"; RGB within {worst} of the plain path, "
          f"{len(same)} of {LM_BATCH} images equal and their tokens equal "
          f"the plain RGB's embedding; patches_for {patch_ms:.1f} ms "
          f"(cold bucket); {card}", flush=True)

    # the decode loop's idle share and warm step time: a few more steps on
    # the run's caches (max_len leaves 8 positions after the run's tokens)
    tok = r.tokens[:, -1:]

    def steps(n, pos):
        nonlocal tok
        for i in range(n):
            logits, _ = TM.forward_decode(r.model, tok, pos + i, r.caches)
            tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
        torch.cuda.synchronize()

    print(f"[serve] {LM_PROFILE_STEPS} decode steps, device time by "
          f"kernel:", flush=True)
    busy, prof_ms = profile_rows(lambda: steps(LM_PROFILE_STEPS, r.pos))
    t0 = time.perf_counter()
    steps(LM_PROFILE_STEPS, r.pos + LM_PROFILE_STEPS)
    warm_ms = (time.perf_counter() - t0) * 1e3 / LM_PROFILE_STEPS
    # device busy and wall time of the same profiled steps; the profiler's
    # own host cost is in that wall, so the share is an upper estimate
    step_busy = busy / LM_PROFILE_STEPS
    dec_ms = r.decode_s * 1e3 / r.decode_steps
    idle = f"{1 - busy / prof_ms:.3f}" if busy else "not measured"

    # decode against prefill: the first decode step's logits against the
    # last logits of a prefill of prompt + that token
    caches_bytes = nbytes(*(t for c in r.caches for t in (c.k, c.v)))
    r.caches = None
    caches = TM.init_caches(cfg, LM_BATCH, r.max_len, device=gpu)
    batch = dict(r.batch, tokens=torch.cat([r.batch["tokens"],
                                            r.tokens[:, :1]], 1))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = TM.forward_prefill(r.model, batch, caches)
    torch.cuda.synchronize()
    prefill2_ms = (time.perf_counter() - t0) * 1e3
    ref = logits[:, -1].float()
    err = float((r.first_decode_logits - ref).abs().max())
    check(bool(lm_close(r.first_decode_logits, ref).all())
          and bool(torch.isfinite(ref).all()), f"phase 12: the first decode "
          f"step's logits differ from the prefill of prompt + token by {err}")
    print(f"[serve] a prefill of the same {LM_BATCH} x "
          f"{batch['tokens'].shape[1] + cfg.n_patches} tokens, device time "
          f"by kernel:", flush=True)
    pf_busy, pf_prof_ms = profile_rows(
        lambda: TM.forward_prefill(r.model, batch, caches))
    del caches, logits, batch

    # bounds from the shapes: a decode step reads every parameter but the
    # embedding (gathered) and the whole cache (the mask covers all of
    # max_len); a prefill's products are 2 x (block parameters) a token, the
    # projector's a patch and the head's a request, in bf16, plus the f32
    # scores and values over the whole cache (TF32 off)
    blk = sum(p.numel() for p in r.model.blocks.parameters())
    vis = r.model.vis_proj1.numel() + r.model.vis_proj2.numel()
    head = r.model.lm_head.numel()
    step_bytes = 2 * (n_params - r.model.embed.numel()) + caches_bytes
    step_bound = step_bytes / HBM_BYTES_PER_S * 1e3
    seq = LM_PROMPT + cfg.n_patches
    bf16_flop = 2 * (blk * LM_BATCH * seq + vis * LM_BATCH * cfg.n_patches
                     + head * LM_BATCH)
    f32_flop = 2 * 2 * LM_BATCH * seq * cfg.n_heads * r.max_len \
        * cfg.head_dim * cfg.n_periods
    pf_bound = (bf16_flop / BF16_FLOP_PER_S + f32_flop / F32_FLOP_PER_S) * 1e3
    # the causal work alone: query i scores and weighs i + 1 keys
    causal_flop = f32_flop / r.max_len * (seq + 1) / 2
    causal_bound = (bf16_flop / BF16_FLOP_PER_S
                    + causal_flop / F32_FLOP_PER_S) * 1e3
    tps = LM_BATCH * r.decode_steps / r.decode_s
    floor_gb = (2 * n_params + caches_bytes) / 1e9
    print(f"[serve] llava-next-mistral-7b full width ({len(r.model.blocks)} "
          f"layers, d_model {cfg.d_model}, {n_params / 1e9:.3f} B "
          f"parameters, bf16), batch {LM_BATCH}, max_len {r.max_len}: "
          f"prefill of {LM_BATCH} x {seq} = {LM_BATCH * seq} tokens "
          f"{r.prefill_s * 1e3:.1f} ms (the run's; again with one more "
          f"token {prefill2_ms:.1f} ms; device busy {pf_busy:.1f} of "
          f"{pf_prof_ms:.1f} ms profiled), bound {pf_bound:.1f} ms "
          f"({bf16_flop / 1e12:.1f} TFLOP bf16 over 989 TFLOP/s + "
          f"{f32_flop / 1e12:.1f} TFLOP f32 over 67 TFLOP/s: the score "
          f"block over all of max_len, as the reference computes it; the "
          f"causal work alone {causal_flop / 1e12:.1f} TFLOP f32, bound "
          f"{causal_bound:.1f} ms); {card}",
          flush=True)
    print(f"[serve] decode: {r.decode_steps} greedy steps {dec_ms:.2f} ms a "
          f"step ({tps:.1f} tokens/s; warm steps after the run "
          f"{warm_ms:.2f} ms), bound {step_bound:.2f} ms a step "
          f"({step_bytes / 1e9:.2f} GB: weights but the embedding, and the "
          f"{caches_bytes / 1e9:.2f} GB cache, over 3.35 TB/s); decode loop "
          f"idle share {idle} (device busy {step_busy:.2f} ms a step over "
          f"{LM_PROFILE_STEPS} profiled steps of "
          f"{prof_ms / LM_PROFILE_STEPS:.2f} ms wall, the profiler's host "
          f"cost included); peak memory "
          f"{peak / 1e9:.2f} GB (weights and cache {floor_gb:.2f} GB); "
          f"decode against prefill of prompt + token: largest difference "
          f"{err:.3g}, within rtol {LM_TOL['rtol']} atol {LM_TOL['atol']}; "
          f"every logit finite; sample tokens "
          f"{r.tokens[0, :8].tolist()}; {card}", flush=True)
    del r, pipe, patches


# -- phase 13: MoE, MLA, SSD and encoder-decoder serving ---------------------

# the families this phase serves: MLA + MoE (deepseek-v2, deepseek-v3 with
# the sigmoid_bias router), SSD (mamba2), hybrid SSD/attention + MoE
# (jamba), encoder-decoder (whisper)
FAMILY_ARCHS = ("deepseek-v2-236b", "deepseek-v3-671b", "mamba2-780m",
                "jamba-v0.1-52b", "whisper-base")
# jamba's f32 logits move 10x more than the others' under the same last-
# bit differences: its attention outputs reach 70 with sharp scores, and
# the CPU differs from the JAX package by up to 4.7e-4 (the CPU tests,
# tests/test_torch_ssm.py); about 4x that
JAMBA_F32_TOL = dict(rtol=1e-4, atol=2e-3)
# the full-width runs: (arch, n_periods or None for the whole model,
# requests, prompt tokens, generated tokens, whether the first decode step
# is held within LM_TOL of a prefill of prompt + token or only reported);
# deepseek-v2 keeps its published widths and 7 of its 60 layers (the
# dense prefix layer and 6 MoE layers: 25.22 B parameters, 50.4 GB in
# bf16). Reported only: deepseek's 2,052-token prefill drops slots at
# capacity factor 1.25, where a 4-token step drops none; whisper's decode
# differs from its prefill at full width in the JAX package itself, by
# up to 3.1 in bf16 and 0.79 in f32 with f32 caches (JAX on the CPU,
# random weights: a last-bit difference between an M=1 and an M=65
# product moves its attention, which these weights make near one-hot).
FAMILY_RUNS = (("deepseek-v2-236b", 6, 4, 512, 32, False),
               ("mamba2-780m", None, 4, 2048, 32, True),
               ("whisper-base", None, 4, 64, 32, False))


def family_flops(model, cfg, batch, seq, max_len):
    """(bf16, f32) FLOP of a prefill of ``batch`` x ``seq`` tokens into
    caches of ``max_len``, as the reference computes it: 2 x (parameters)
    a token for the products outside the experts (the cross-attention's
    keys and values a frame, the encoder's products a frame, the head's
    a request), every expert's whole capacity buffer, the attention's f32
    scores and values over the whole cache (MLA: the absorbed form over
    its latents; whisper's cross-attention over every frame; the
    encoder's over every frame), and the SSD's chunked products (its
    Q x Q block per chunk in f32)."""
    from repro_torch.models.ffn import capacity
    t, tok = batch * seq, 0
    bf16 = f32 = 0.0
    enc_t = batch * cfg.enc_seq
    for blk in model.enc:
        bf16 += 2 * enc_t * sum(p.numel() for p in blk.parameters())
        f32 += 2 * 2 * batch * cfg.enc_seq ** 2 * cfg.n_heads * cfg.head_dim
    if model.aud_proj is not None:
        bf16 += 2 * enc_t * model.aud_proj.numel()
    for blk in model.blocks:
        n = sum(p.numel() for p in blk.parameters())
        if blk.ffn_kind == "moe":
            ex = blk.ffn.w_gate.numel() + blk.ffn.w_up.numel() \
                + blk.ffn.w_down.numel()
            n -= ex
            bf16 += 2 * ex * capacity(cfg, t)
        if blk.xattn is not None:
            kv = blk.xattn.wk.numel() + blk.xattn.wv.numel()
            n -= kv
            bf16 += 2 * enc_t * kv
            f32 += 2 * 2 * t * cfg.n_heads * cfg.enc_seq * cfg.head_dim
        bf16 += 2 * t * n
        if blk.mixer == "attn":
            f32 += 2 * 2 * t * cfg.n_heads * max_len * cfg.head_dim
        elif blk.mixer == "mla":
            m = cfg.mla
            f32 += 2 * t * cfg.n_heads * max_len * (2 * m.kv_lora
                                                     + m.rope_dim)
        elif blk.mixer == "ssm":
            s = cfg.ssm
            nh = s.expand * cfg.d_model // s.head_dim
            q = s.chunk
            nc = -(-seq // q)
            bf16 += 2 * batch * nc * q * q * s.d_state
            f32 += 2 * batch * nc * q * (q * nh * s.head_dim
                                         + 2 * nh * s.d_state * s.head_dim)
    head = model.embed if cfg.tie_embeddings else model.lm_head
    bf16 += 2 * batch * head.numel()
    return bf16, f32


def serve_family(args, gpu, card, arch, n_periods, batch, prompt, gen,
                 hold) -> None:
    """Phase 13b, one arch at full width through ``launch.serve.run``
    (bf16 weights drawn on the card from ``--seed``): ``batch`` requests
    of ``prompt`` tokens, ``gen`` generated. Prints the prefill ms and its
    bound, the decode ms a step and its bound, tokens/s, peak memory, the
    decode loop's idle share, the top kernels of a prefill and of 4 decode
    steps, and deepseek's dropped_frac at prefill; checks every logit is
    finite and, with ``hold``, the first decode step within ``LM_TOL`` of
    a prefill of prompt + token."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as LS
    from repro_torch.models import model as TM

    cfg = get_config(arch)
    cut = ""
    if n_periods is not None and n_periods != cfg.n_periods:
        cut = (f"depth cut to n_periods={n_periods}: {n_periods + len(cfg.prefix_layers)} "
               f"of {cfg.n_layers} layers; ")
        cfg = dataclasses.replace(cfg, n_periods=n_periods)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    routes, restore = moe_recorder()
    try:
        r = LS.run(cfg, batch, prompt, gen, device=gpu, seed=args.seed)
    finally:
        restore()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    check(r.logits_finite, f"phase 13 {arch}: a logit is not finite")
    n_params = sum(p.numel() for p in r.model.parameters())
    check(len(r.model.blocks) == cfg.n_layers, f"phase 13 {arch}: "
          f"{len(r.model.blocks)} layers")
    drops = [d for idx, d in routes if idx.shape[0] == batch * prompt]
    check(len(drops) == sum(f == "moe" for _, f in cfg.layer_specs),
          f"phase 13 {arch}: {len(drops)} MoE layers ran at prefill")

    tok = r.tokens[:, -1:]

    def steps(n, pos):
        nonlocal tok
        for i in range(n):
            logits, _ = TM.forward_decode(r.model, tok, pos + i, r.caches)
            tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
        torch.cuda.synchronize()

    print(f"[serve] {arch}: {LM_PROFILE_STEPS} decode steps, device time "
          f"by kernel:", flush=True)
    busy, prof_ms = profile_rows(lambda: steps(LM_PROFILE_STEPS, r.pos))
    t0 = time.perf_counter()
    steps(LM_PROFILE_STEPS, r.pos + LM_PROFILE_STEPS)
    warm_ms = (time.perf_counter() - t0) * 1e3 / LM_PROFILE_STEPS
    step_busy = busy / LM_PROFILE_STEPS
    dec_ms = r.decode_s * 1e3 / r.decode_steps
    idle = f"{1 - busy / prof_ms:.3f}" if busy else "not measured"

    cache_t = [t for c in r.caches if c is not None for t in c
               if isinstance(t, torch.Tensor)]
    caches_bytes = nbytes(*cache_t)
    enc_bytes = nbytes(r.caches.enc_out) if r.caches.enc_out is not None \
        else 0
    r.caches = None
    # decode against prefill: the first decode step's logits against the
    # last logits of a prefill of prompt + that token
    caches = TM.init_caches(cfg, batch, r.max_len, device=gpu)
    inputs = dict(r.batch, tokens=torch.cat([r.batch["tokens"],
                                             r.tokens[:, :1]], 1))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, _ = TM.forward_prefill(r.model, inputs, caches)
    torch.cuda.synchronize()
    prefill2_ms = (time.perf_counter() - t0) * 1e3
    ref = logits[:, -1].float()
    err = float((r.first_decode_logits - ref).abs().max())
    close = bool(lm_close(r.first_decode_logits, ref).all())
    n_off = int((~lm_close(r.first_decode_logits, ref)).sum())
    check(bool(torch.isfinite(ref).all()), f"phase 13 {arch}: the prefill "
          f"of prompt + token gave a logit that is not finite")
    check(close or not hold, f"phase 13 {arch}: the first decode step's "
          f"logits differ from the prefill of prompt + token by {err}")
    held = "held" if hold else "reported, not held"
    print(f"[serve] {arch}: a prefill of {batch} x {prompt + 1} tokens, "
          f"device time by kernel:", flush=True)
    pf_busy, pf_prof_ms = profile_rows(
        lambda: TM.forward_prefill(r.model, inputs, caches))
    del caches, logits, inputs

    # bounds from the shapes: a decode step reads every decoder parameter
    # (every expert's, as the capacity buffers of all of them are
    # computed; not the embedding, gathered, nor the encoder's) and the
    # whole cache, and whisper's encoding once; a prefill reads every
    # parameter once and does family_flops' work
    dec_params = sum(p.numel() for p in r.model.blocks.parameters()) \
        + sum(p.numel() for p in r.model.final_norm.parameters()) \
        + (0 if cfg.tie_embeddings else r.model.lm_head.numel())
    step_bytes = 2 * dec_params + caches_bytes + enc_bytes
    step_bound = step_bytes / HBM_BYTES_PER_S * 1e3
    bf16_flop, f32_flop = family_flops(r.model, cfg, batch, prompt,
                                       r.max_len)
    pf_ops = (bf16_flop / BF16_FLOP_PER_S + f32_flop / F32_FLOP_PER_S) * 1e3
    pf_bytes = (2 * n_params + caches_bytes) / HBM_BYTES_PER_S * 1e3
    pf_bound, pf_by = (pf_ops, "operations") if pf_ops >= pf_bytes \
        else (pf_bytes, "bytes")
    tps = batch * r.decode_steps / r.decode_s
    drop = (f"; dropped_frac at prefill by MoE layer "
            f"{[round(d, 4) for d in drops]}" if drops else "")
    print(f"[serve] {arch} full width ({cut}{len(r.model.blocks)} decoder "
          f"layers{f' + {cfg.n_enc_layers} encoder layers over {cfg.enc_seq} frames' if cfg.is_encdec else ''}, "
          f"d_model {cfg.d_model}, {n_params / 1e9:.3f} B parameters, "
          f"bf16), batch {batch}, max_len {r.max_len}: prefill of {batch} x "
          f"{prompt} tokens {r.prefill_s * 1e3:.1f} ms (the run's; again "
          f"with one more token {prefill2_ms:.1f} ms; device busy "
          f"{pf_busy:.1f} of {pf_prof_ms:.1f} ms profiled), bound "
          f"{pf_bound:.2f} ms by {pf_by} ({bf16_flop / 1e12:.2f} TFLOP bf16 "
          f"over 989 TFLOP/s + {f32_flop / 1e12:.2f} TFLOP f32 over 67 "
          f"TFLOP/s = {pf_ops:.2f} ms; {(2 * n_params + caches_bytes) / 1e9:.2f} "
          f"GB over 3.35 TB/s = {pf_bytes:.2f} ms){drop}; {card}",
          flush=True)
    print(f"[serve] {arch} decode: {r.decode_steps} greedy steps "
          f"{dec_ms:.2f} ms a step ({tps:.1f} tokens/s; warm steps after "
          f"the run {warm_ms:.2f} ms), bound {step_bound:.3f} ms a step "
          f"({step_bytes / 1e9:.3f} GB: decoder weights, the "
          f"{caches_bytes / 1e9:.3f} GB cache"
          f"{f' and the {enc_bytes / 1e9:.3f} GB encoding' if enc_bytes else ''}"
          f", over 3.35 TB/s); decode loop idle share {idle} (device busy "
          f"{step_busy:.2f} ms a step over {LM_PROFILE_STEPS} profiled "
          f"steps of {prof_ms / LM_PROFILE_STEPS:.2f} ms wall, the "
          f"profiler's host cost included); peak memory {peak / 1e9:.2f} GB "
          f"(weights and cache {(2 * n_params + caches_bytes) / 1e9:.2f} "
          f"GB); decode against prefill of prompt + token: largest "
          f"difference {err:.3g}, {n_off} logits outside rtol "
          f"{LM_TOL['rtol']} atol {LM_TOL['atol']} ({held}); every logit "
          f"finite; sample tokens {r.tokens[0, :8].tolist()}; {card}",
          flush=True)
    del r
    torch.cuda.empty_cache()


def serve_families(args, gpu, card) -> None:
    """Phase 13: 13a the five archs' smoke parity, card against CPU;
    13b deepseek-v2 (7 of 60 layers), mamba2 and whisper at full width."""
    lm_smoke_parity(args, gpu, FAMILY_ARCHS, 13,
                    {"jamba-v0.1-52b": JAMBA_F32_TOL})
    for run in FAMILY_RUNS:
        serve_family(args, gpu, card, *run)


# -- phase 14: training ---------------------------------------------------------

# 14a: one train step of each smoke config in f32, card against CPU. The
# loss and every gradient are held as the CPU tests hold them against
# the JAX package (tests/test_torch_train.py): each gradient leaf within
# TRAIN_GRAD_TOL x its largest |value|; after the step, every parameter
# within TRAIN_STEP_ATOL (AdamW's first step moves a weight by about lr x
# the sign of its gradient, so a gradient within rounding of zero can
# move it by up to 2 x lr the other way: the count of weights beyond
# 1e-6 is printed); the grad norm within TRAIN_GRAD_TOL (jamba's differs
# by 2.1e-4 on an H100: PERF.md section 6)
TRAIN_LR = 1e-3
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = 1e-3
TRAIN_STEP_ATOL = 2 * TRAIN_LR
# 14b: the launcher as users run it, then resumed from its step-6
# checkpoint; the resumed losses within this of the uninterrupted run's
TRAIN_ARGV = ["--arch", "llama3-8b", "--preset", "100m", "--steps", "12",
              "--batch", "8", "--seq", "256", "--microbatches", "2",
              "--save-every", "6"]
RESUME_RTOL = 1e-3
# 14c: llava-next-mistral-7b at full width, each request one 1920x384
# frame (2,880 patches) and 64 text tokens, 2 requests a step; steps 1-3
# fresh frames, step 4 repeats step 3's batch
VLM_TRAIN_BATCH, VLM_TRAIN_TEXT, VLM_TRAIN_STEPS = 2, 64, 4
VLM_TRAIN_LR = 1e-4
MEMORY_LIMIT_GB = 76.0


def train_smoke_parity(args, gpu) -> None:
    """Phase 14a: each arch's smoke config in f32, built once on the CPU
    from ``--seed`` and copied to the card; the same ``SyntheticTokens``
    batch (and the VLM's patches, the encoder-decoder's frames, drawn
    from ``--seed``) on both. ``forward_train``'s loss and every gradient
    (TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL), each MoE layer's routing equal;
    then one ``make_train_step`` step on each (``lr`` TRAIN_LR): the loss,
    the grad norm and every parameter after it (TRAIN_STEP_ATOL)."""
    import copy
    import dataclasses
    from repro_torch.configs import ARCH_IDS, get_smoke_config
    from repro_torch.data.tokens import SyntheticTokens
    from repro_torch.models import model as TM
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.step import make_train_step

    def grads(model, batch):
        model.requires_grad_(True)
        model.zero_grad(set_to_none=True)
        loss, _ = TM.forward_train(model, batch)
        loss.backward()
        out = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
               .detach().float().cpu() for k, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return loss.item(), out

    for arch in ARCH_IDS:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                                  param_dtype="float32")
        cpu = TM.init_params(torch.Generator().manual_seed(args.seed), cfg,
                             device="cpu")
        card = copy.deepcopy(cpu).to(gpu)
        rng = np.random.default_rng(args.seed)
        nv = cfg.n_patches if cfg.frontend == "vision" else 0
        arrays = SyntheticTokens(cfg.vocab, 24 - nv, 2, args.seed).batch_at(0)
        batch = {k: torch.from_numpy(v) for k, v in arrays.items()}
        if nv:
            batch["patches"] = torch.from_numpy(
                rng.normal(0, 1, (2, nv, 1024))).to(torch.bfloat16)
        if cfg.is_encdec:
            batch["frames"] = torch.from_numpy(
                rng.normal(0, 1, (2, cfg.enc_seq, 128))).to(torch.bfloat16)
        on_card = {k: v.to(gpu) for k, v in batch.items()}
        what = f"phase 14 {arch}"
        routes, restore = moe_recorder()
        try:
            lc, g_cpu = grads(cpu, batch)
            n_cpu = len(routes)
            lg, g_card = grads(card, on_card)
        finally:
            restore()
        check(len(routes) == 2 * n_cpu and all(
            torch.equal(a[0], b[0]) and a[1] == b[1]
            for a, b in zip(routes[:n_cpu], routes[n_cpu:])),
            f"{what}: the MoE routing differs between card and CPU")
        check(abs(lg - lc) <= TRAIN_LOSS_RTOL * abs(lc), f"{what}: loss "
              f"{lg} on the card, {lc} on the CPU")
        worst = 0.0
        for k, exp in g_cpu.items():
            gap = float((g_card[k] - exp).abs().max())
            scale = float(exp.abs().max())
            check(gap <= TRAIN_GRAD_TOL * scale, f"{what}: the gradient of "
                  f"{k} differs by {gap} (largest |value| {scale})")
            worst = max(worst, gap / scale if scale else 0.0)
        opt = AdamWConfig(lr=TRAIN_LR)
        step = make_train_step(cfg, opt)
        out = {}
        for side, model, b in (("cpu", cpu, batch), ("card", card, on_card)):
            params = dict(model.named_parameters())
            _, st, m = step(model, init_opt_state(params, opt), b)
            out[side] = (float(m["loss"]), float(m["grad_norm"]),
                         {k: p.detach().float().cpu()
                          for k, p in model.named_parameters()})
        (l0, n0, p0), (l1, n1, p1) = out["cpu"], out["card"]
        gap = max(float((p1[k] - p0[k]).abs().max()) for k in p0)
        off = sum(int(((p1[k] - p0[k]).abs() > 1e-6).sum()) for k in p0)
        n = sum(v.numel() for v in p0.values())
        check(abs(l1 - l0) <= TRAIN_LOSS_RTOL * abs(l0)
              and abs(n1 - n0) <= TRAIN_GRAD_TOL * abs(n0)
              and gap <= TRAIN_STEP_ATOL,
              f"{what}: the train step differs: loss {l1} / {l0}, grad norm "
              f"{n1} / {n0}, parameters by {gap}")
        routed = f"; routing of {n_cpu} MoE calls equal" if n_cpu else ""
        print(f"[train] smoke {arch} (f32, TF32 off), card against CPU: loss "
              f"{lg:.6f} / {lc:.6f}; every gradient within "
              f"{worst:.2e} of its leaf's largest |value| (held at "
              f"{TRAIN_GRAD_TOL}){routed}; one train step: grad norm "
              f"{n1:.6g} / {n0:.6g}, parameters within {gap:.3g} ({off} of "
              f"{n} beyond 1e-6; held at {TRAIN_STEP_ATOL})", flush=True)
        del cpu, card


def train_launcher(args, gpu) -> None:
    """Phase 14b: ``repro_torch.launch.train.main`` with TRAIN_ARGV (on
    the card: its default ``--device``), checkpoints every 6 steps; then
    its step-12 checkpoint removed, as if the job had died after the save
    at step 6, and the same command with ``--resume auto``. The tree
    restored equals, bit for bit, the tree saved at step 6; the resumed
    run's steps are 6-11 and its losses finite and within RESUME_RTOL of
    the uninterrupted run's."""
    import shutil
    from repro_torch.launch import train as LT

    def host(tree):
        if isinstance(tree, dict):
            return {k: host(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return type(tree)(*(host(v) for v in tree)) \
                if hasattr(tree, "_fields") else tuple(map(host, tree))
        return None if tree is None else tree.detach().cpu().clone()

    def same(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        if isinstance(a, tuple):
            return len(a) == len(b) and all(map(same, a, b))
        if a is None or b is None:
            return a is b
        return a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())

    saved, restored = {}, {}
    save, restore = LT.save_checkpoint, LT.restore_checkpoint

    def saving(d, step, tree, *args, **kw):
        saved[step] = host(tree)
        return save(d, step, tree, *args, **kw)

    def restoring(d, step, target, *args, **kw):
        out = restore(d, step, target, *args, **kw)
        restored[step] = host(out)  # the run then updates it in place
        return out

    LT.save_checkpoint, LT.restore_checkpoint = saving, restoring
    with tempfile.TemporaryDirectory() as tmp:
        try:
            argv = TRAIN_ARGV + ["--ckpt-dir", tmp]
            first = LT.main(argv)
            check(sorted(saved) == [6, 12] and LT.latest_step(tmp) == 12,
                  f"phase 14b: checkpoints saved at {sorted(saved)}")
            shutil.rmtree(os.path.join(tmp, "step_00000012"))
            again = LT.main(argv + ["--resume", "auto"])
        finally:
            LT.save_checkpoint, LT.restore_checkpoint = save, restore
    check(list(restored) == [6] and same(restored[6], saved[6]),
          "phase 14b: the restored tree differs from the one saved at step 6")
    check(again.start == 6 and sorted(again.losses) == list(range(6, 12)),
          f"phase 14b: the resumed run ran steps {sorted(again.losses)}")
    gaps = [abs(again.losses[i] - first.losses[i]) for i in range(6, 12)]
    check(all(np.isfinite(list(first.losses.values())))
          and all(np.isfinite(list(again.losses.values())))
          and all(g <= RESUME_RTOL * abs(first.losses[i])
                  for g, i in zip(gaps, range(6, 12))),
          f"phase 14b: resumed losses {again.losses} against {first.losses}")
    n = sum(p.numel() for p in first.model.parameters())
    print(f"[train] launcher: python -m repro_torch.launch.train "
          f"{' '.join(TRAIN_ARGV)} --ckpt-dir <tmp> ({n / 1e6:.1f} M "
          f"parameters, bf16, f32 moments): losses "
          f"{[round(first.losses[i], 4) for i in sorted(first.losses)]}, "
          f"step ms {[round(s * 1e3, 1) for s in first.step_s]}, "
          f"stragglers {first.stragglers}; resumed from step 6 (--resume "
          f"auto): the restored parameters and optimizer state equal the "
          f"saved ones bit for bit, steps 6-11 losses "
          f"{[round(again.losses[i], 4) for i in sorted(again.losses)]} "
          f"(largest gap to the uninterrupted run {max(gaps):.3g}), step ms "
          f"{[round(s * 1e3, 1) for s in again.step_s]}, stragglers "
          f"{again.stragglers}", flush=True)
    del first, again, saved, restored


def train_vlm(args, gpu, card, counters, kernels) -> dict:
    """Phase 14c: llava-next-mistral-7b at full width trained on patches
    from ``JpegVisionPipeline`` on the card (B1, B2, B4);
    ``make_train_step(schedule="constant")``, AdamW with bf16 moments, lr
    VLM_TRAIN_LR, remat ``full``."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.data.jpeg_pipeline import JpegVisionPipeline
    from repro_torch.data.tokens import SyntheticTokens
    from repro_torch.jpeg.encoder import DatasetSpec, build_dataset
    from repro_torch.models import model as TM
    from repro_torch.train import step as TS
    from repro_torch.dist.plan import ShardLayout
    from repro_torch.tools.tp_train import reckon, step_flops
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # what earlier phases still hold: the peak less this is the phase's own
    held = torch.cuda.memory_allocated()
    cfg = get_config("llava-next-mistral-7b")
    check(cfg.remat == "full", f"phase 14c: remat {cfg.remat}")
    w, h = LM_FRAME
    bsz = VLM_TRAIN_BATCH
    seq = cfg.n_patches + VLM_TRAIN_TEXT
    model = TM.init_params(torch.Generator(device=gpu).manual_seed(args.seed),
                           cfg, device=gpu)
    n_params = sum(p.numel() for p in model.parameters())
    check(len(model.blocks) == cfg.n_layers == 32 and cfg.d_model == 4096,
          "phase 14c: the model is not the full-width one")
    mem = reckon(cfg, ShardLayout(), bsz, seq, moment_bytes=2)
    predicted = sum(mem.values()) / 1e9
    print(f"[train] llava-next-mistral-7b full width, batch {bsz} x {seq} "
          f"positions: memory reckoned from the shapes " + ", ".join(
              f"{k} {v / 1e9:.2f} GB" for k, v in mem.items())
          + f": {predicted:.1f} GB", flush=True)
    if predicted > MEMORY_LIMIT_GB:
        bsz = 1
        print(f"[train] over {MEMORY_LIMIT_GB} GB: batch cut to 1",
              flush=True)

    spec = DatasetSpec("llava-train", bsz * (VLM_TRAIN_STEPS - 1), w, h,
                       args.quality)
    blobs = build_dataset(spec, seed=args.seed).jpeg_bytes
    pipe = JpegVisionPipeline(patch=16, embed_dim=1024, device=gpu,
                              chunk_bits=args.chunk_bits)
    texts = SyntheticTokens(cfg.vocab, VLM_TRAIN_TEXT, bsz, args.seed)
    opt = AdamWConfig(lr=VLM_TRAIN_LR, moment_dtype="bfloat16")
    params = dict(model.named_parameters())
    opt_state = init_opt_state(params, opt)
    step_fn = TS.make_train_step(cfg, opt, schedule="constant")

    # the optimizer's share of the step: events around adamw_update
    marks = []
    adamw = TS.adamw_update

    def timed_adamw(*a, **k):
        e0, e1 = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        e0.record()
        out = adamw(*a, **k)
        e1.record()
        marks.append((e0, e1))
        return out

    TS.adamw_update = timed_adamw
    rows, launches = [], {}
    try:
        for i in range(VLM_TRAIN_STEPS):
            fresh = i < VLM_TRAIN_STEPS - 1
            j = i if fresh else VLM_TRAIN_STEPS - 2
            frames = blobs[j * bsz: (j + 1) * bsz]
            for fn, attr in counters.values():
                setattr(fn, attr, 0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            patches, _ = pipe.patches_for(frames)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            counts = {k: getattr(fn, attr)
                      for k, (fn, attr) in counters.items()}
            for k, n in counts.items():
                launches[k] = launches.get(k, 0) + n
            want = {"huffman_exits", "huffman_streams", "fused_pixels"}
            got = {k for k, n in counts.items() if n}
            check(got == want or (not fresh and got <= want),
                  f"phase 14c step {i + 1}: the decode launched "
                  f"{sorted(got)}")
            check(tuple(patches.shape) == (bsz, cfg.n_patches, 1024),
                  f"phase 14c: patches {tuple(patches.shape)}")
            batch = {k: torch.from_numpy(v).to(gpu)
                     for k, v in texts.batch_at(j).items()}
            batch["patches"] = patches
            model, opt_state, m = step_fn(model, opt_state, batch)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            opt_ms = marks[-1][0].elapsed_time(marks[-1][1])
            check(np.isfinite(loss) and np.isfinite(gnorm),
                  f"phase 14c step {i + 1}: loss {loss}, grad norm {gnorm}")
            rows.append(dict(loss=loss, gnorm=gnorm, decode_ms=(t1 - t0) * 1e3,
                             step_ms=(t2 - t1) * 1e3, opt_ms=opt_ms,
                             tokens=int(m["tokens"]), counts=counts))
            kind = "fresh frames" if fresh else f"step {i}'s batch again"
            print(f"[train] step {i + 1} ({kind}): "
                  f"loss {loss:.5f}, grad norm {gnorm:.4g}; decode + "
                  f"patchify + embed {(t1 - t0) * 1e3:.1f} ms (launches "
                  + ", ".join(f"{k} {n}" for k, n in counts.items() if n)
                  + f"), train step {(t2 - t1) * 1e3:.1f} ms (optimizer "
                  f"{opt_ms:.1f} ms by events)", flush=True)
            del patches, batch, m
        peak = torch.cuda.max_memory_allocated()
        check(rows[-1]["loss"] < rows[-2]["loss"], f"phase 14c: the "
              f"repeated batch's loss {rows[-1]['loss']} is not below "
              f"{rows[-2]['loss']}")
        # a profiled step on the same batch: device busy, idle share, the
        # top kernels
        patches, _ = pipe.patches_for(blobs[-bsz:])
        batch = {k: torch.from_numpy(v).to(gpu)
                 for k, v in texts.batch_at(VLM_TRAIN_STEPS - 2).items()}
        batch["patches"] = patches
        print("[train] a profiled train step, device time by kernel:",
              flush=True)
        busy, prof_ms = profile_rows(
            lambda: step_fn(model, opt_state, batch), top=10, tag="train")
    finally:
        TS.adamw_update = adamw
    for rec in kernels:
        rec["launches"] += launches.get(rec["name"], 0)

    warm = rows[VLM_TRAIN_STEPS - 2]
    bf16_flop, f32_flop = step_flops(model, cfg, ShardLayout(), bsz, seq)
    bound_ms = (bf16_flop / BF16_FLOP_PER_S + f32_flop / F32_FLOP_PER_S) * 1e3
    # the profiled step's busy time over the warm step's unprofiled wall
    # (the profiler's own host cost stretches the profiled step's wall)
    idle = f"{max(0.0, 1 - busy / warm['step_ms']):.3f}" if busy \
        else "not measured"
    fb_ms = warm["step_ms"] - warm["opt_ms"]
    print(f"[train] llava-next-mistral-7b full width ({len(model.blocks)} "
          f"layers, d_model {cfg.d_model}, {n_params / 1e9:.3f} B "
          f"parameters, bf16; AdamW bf16 moments, lr {VLM_TRAIN_LR}, remat "
          f"{cfg.remat}), batch {bsz} x {seq} positions ({cfg.n_patches} "
          f"patches of a {w}x{h} q{args.quality} frame + {VLM_TRAIN_TEXT} "
          f"text tokens a request): warm step (step "
          f"{VLM_TRAIN_STEPS - 1}) {warm['decode_ms'] + warm['step_ms']:.1f} "
          f"ms wall = decode + patchify + embed {warm['decode_ms']:.1f} + "
          f"forward + backward {fb_ms:.1f} + optimizer {warm['opt_ms']:.1f}; "
          f"a profiled step busy {busy:.1f} ms ({prof_ms:.1f} ms wall under "
          f"the profiler): idle share of the warm train step {idle}; "
          f"{bsz * seq / warm['step_ms'] * 1e3:.0f} positions/s, "
          f"{warm['tokens'] / warm['step_ms'] * 1e3:.0f} label tokens/s; "
          f"bound {bound_ms:.1f} ms by operations ({bf16_flop / 1e12:.1f} "
          f"TFLOP bf16 over 989 TFLOP/s + {f32_flop / 1e12:.1f} TFLOP f32 "
          f"over 67 TFLOP/s); grad norms "
          f"{[round(r['gnorm'], 4) for r in rows]}; losses "
          f"{[round(r['loss'], 5) for r in rows]} (the repeated batch's "
          f"below its first); peak memory {(peak - held) / 1e9:.2f} GB "
          f"(reckoned {predicted:.1f}; {peak / 1e9:.2f} GB with the "
          f"{held / 1e9:.2f} GB earlier phases hold); {card}", flush=True)
    del model, opt_state, params, pipe, patches, batch
    gc.collect()
    torch.cuda.empty_cache()
    return dict(batch=bsz, seq=seq, peak=peak - held, bf16=bf16_flop,
                f32=f32_flop, bound_ms=bound_ms)


def train_families(args, gpu, card, counters, kernels) -> dict:
    """Phase 14: 14a the ten archs' smoke train step, card against CPU;
    14b the launcher with a checkpoint and a resume; 14c
    llava-next-mistral-7b trained at full width on decoded frames, whose
    measured step (batch, positions, peak, FLOPs, bound) it returns."""
    for name, fn, call_args in (
            ("14a", train_smoke_parity, (args, gpu)),
            ("14b", train_launcher, (args, gpu)),
            ("14c", train_vlm, (args, gpu, card, counters, kernels))):
        t0 = time.perf_counter()
        out = fn(*call_args)
        print(f"[train] phase {name} took {time.perf_counter() - t0:.1f} s",
              flush=True)
    return out


# -- phase 17: the dry run against the measured step ---------------------------

# the dry run's reckoned peak a card over phase 14c's measured one
DRYRUN_PEAK_RANGE = (0.95, 1.25)


def dry_run_step(card, step: dict) -> None:
    """Phase 17: ``launch.dryrun.lower_cell`` of phase 14c's train step
    (llava-next-mistral-7b at full width, its batch and positions, one
    microbatch, AdamW with bf16 moments) on the ``meta`` device of this
    process, one rank: its reckoned peak a card within DRYRUN_PEAK_RANGE
    of phase 14c's ``torch.cuda.max_memory_allocated`` (the phase's own);
    its bf16 and f32 FLOPs beside ``step_flops``'s and phase 14c's bound;
    its roofline against the H100's datasheet peaks."""
    from repro_torch.launch.dryrun import lower_cell, roofline
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.train.optimizer import AdamWConfig

    t0 = time.perf_counter()
    st = lower_cell("llava-next-mistral-7b", "train_4k", MeshShape(1, 1),
                    batch=step["batch"], seq=step["seq"], microbatches=1,
                    opt_cfg=AdamWConfig(lr=VLM_TRAIN_LR,
                                        moment_dtype="bfloat16"))
    secs = time.perf_counter() - t0
    ratio = st["peak_bytes"] / step["peak"]
    lo, hi = DRYRUN_PEAK_RANGE
    rf = roofline(st)
    print(f"[dryrun] phase 17: llava-next-mistral-7b train step, batch "
          f"{step['batch']} x {step['seq']} positions, one card, reckoned "
          f"on meta in {st['compile_s']} s: peak {st['peak_bytes'] / 1e9:.2f} "
          f"GB a card (arguments {st['argument_bytes'] / 1e9:.2f}: "
          f"parameters {st['param_bytes'] / 1e9:.2f}, optimizer "
          f"{st['opt_bytes'] / 1e9:.2f}, inputs "
          f"{st['input_bytes'] / 1e9:.4f}; temporaries "
          f"{st['temp_bytes'] / 1e9:.2f}) against phase 14c's "
          f"max_memory_allocated {step['peak'] / 1e9:.2f} GB: ratio "
          f"{ratio:.4f} (held within {lo}-{hi}); FLOPs bf16 "
          f"{st['flops_bf16'] / 1e12:.2f} T (step_flops "
          f"{step['bf16'] / 1e12:.2f} T), f32 {st['flops_f32'] / 1e12:.2f} "
          f"T (step_flops {step['f32'] / 1e12:.2f} T); bytes accessed "
          f"{st['hbm_bytes_accessed'] / 1e12:.3f} TB; roofline compute "
          f"{rf['compute_s'] * 1e3:.1f} ms, memory "
          f"{rf['memory_s'] * 1e3:.1f} ms: {rf['dominant']}-bound "
          f"{rf['bound_s'] * 1e3:.1f} ms (phase 14c's bound by operations "
          f"{step['bound_ms']:.1f} ms); the phase {secs:.1f} s; {card}",
          flush=True)
    check(lo <= ratio <= hi, f"phase 17: the dry run's peak "
          f"{st['peak_bytes'] / 1e9:.2f} GB is {ratio:.3f} of the measured "
          f"{step['peak'] / 1e9:.2f} GB")


# -- phase 15: serving across ranks ------------------------------------------

# 15a: the dense GQA archs' smoke configs in f32 (TF32 off, every cache
# tensor in f32), held as phase 12 holds the card against the CPU. 15b:
# command-r-plus-104b at its published widths with 2 of its 64 layers
# (9.45 B parameters, 18.9 GB in bf16). 15c: the other families' smoke
# configs (MoE, MLA, SSD, the encoder-decoder) in f32, as 15a, their
# routing equal on both ranks and to the unsharded run's. 15d:
# jamba-v0.1-52b at its published widths with 1 of its 4 periods (8
# layers, 4 of them MoE: 13.27 B parameters) in f32 (53 GB; f32 caches):
# in bf16 these 8 layers decorrelate as 15b's would at that depth
# (normwise 0.25-0.37 on an H100, PR 25; PERF.md section 6), so the
# split's math is held where rounding does not compound. Each: 2
# requests, the prefill and 4 decode steps, unsharded on the card, then
# over model=2
TP_ARCH, TP_PERIODS = "command-r-plus-104b", 2
TP_FAMILY_ARCH, TP_FAMILY_PERIODS = "jamba-v0.1-52b", 1
# the full-width cases: phase -> (arch, periods, dtype)
TP_FULL = {"15b": (TP_ARCH, TP_PERIODS, "bfloat16"),
           "15d": (TP_FAMILY_ARCH, TP_FAMILY_PERIODS, "float32")}
TP_BATCH, TP_PROMPT, TP_SMOKE_PROMPT, TP_STEPS = 2, 128, 24, 4
TP_RANKS = TT_RANKS = 2
TP_TIMEOUT_S = 300
# 15b's and 15d's logits against the unsharded run's, by step: the norm
# of the difference over the norm of the logits. Element by element the
# two differ by more than bf16 rounding: the random weights make
# attention near one-hot at full width (ParamBuilder scales wq by its
# head count and wk by its kv heads, so scores have a std near 440), and
# a last-bit change of a key moves which position a head reads. Measured
# 0.016-0.077 on an H100 (PERF.md section 6); a split that drops or
# repeats a term differs by the whole norm. 15a and 15c hold the split
# math tightly
TP_NORM_TOL = 0.25
# 15d's, in f32: PR 24 measured 9.1e-5 for a layer of command-r-plus over
# four H100s; a dropped or repeated term differs by the whole norm
TP_F32_NORM_TOL = 1e-2


def tp_config(arch=TP_ARCH, n_periods=TP_PERIODS, dtype="bfloat16"):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), n_periods=n_periods,
                               dtype=dtype, param_dtype=dtype)


def tp_cases(seed):
    """(name, config, inputs) of phase 15: each dense arch's smoke config
    in f32 (named by its arch), then command-r-plus-104b at published
    widths (named ``"15b"``), then each other family's smoke config in
    f32, then jamba at published widths (``"15d"``)."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    rng = np.random.default_rng(seed)
    cases = []

    def smoke(arch):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                                  param_dtype="float32")
        nv = cfg.n_patches if cfg.frontend == "vision" else 0
        inputs = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab, (TP_BATCH, TP_SMOKE_PROMPT - nv))).to(torch.int32)}
        if nv:
            inputs["patches"] = torch.from_numpy(rng.normal(
                0, 1, (TP_BATCH, nv, 1024))).to(torch.bfloat16)
        if cfg.is_encdec:
            inputs["frames"] = torch.from_numpy(rng.normal(
                0, 1, (TP_BATCH, cfg.enc_seq, 128))).to(torch.bfloat16)
        cases.append((arch, cfg, inputs))

    def full(phase):
        cfg = tp_config(*TP_FULL[phase])
        cases.append((phase, cfg, {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab, (TP_BATCH, TP_PROMPT))).to(
            torch.int32)}))

    for arch in SERVED_ARCHS:
        smoke(arch)
    full("15b")
    for arch in FAMILY_ARCHS:
        smoke(arch)
    full("15d")
    return cases


def tp_serve(model, cfg, inputs, feed, device, layout=None):
    """The prefill and ``TP_STEPS`` decode steps of ``inputs`` through the
    serving steps (``serve.step``), each step fed ``feed[:, i]`` (this
    rank's rows) or, without ``feed``, its own greedy token; an f32
    config's caches in f32. Returns the logits of every position (steps
    + 1, rows, vocab) and the greedy tokens (rows, steps + 1) on the
    host, the seconds, and each MoE layer call's routing (``idx`` of
    this rank's tokens, ``dropped_frac``)."""
    from repro_torch.models.model import init_caches
    from repro_torch.serve.step import make_decode_step, make_prefill_step
    n_pos = sum(v.shape[1] for k, v in inputs.items()
                if k in ("tokens", "patches"))
    caches = init_caches(cfg, TP_BATCH, n_pos + TP_STEPS + 8, device, layout)
    if cfg.param_dtype == "float32":
        caches = f32_caches(caches)
    batch = {k: v.to(device) for k, v in inputs.items()}
    if layout is not None:
        batch = layout.batch(batch)
        feed = None if feed is None else feed[layout.rows(TP_BATCH)]
    decode = make_decode_step(cfg)
    records, restore = moe_recorder()
    try:
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        logits, caches = make_prefill_step(cfg)(model, batch, caches)
        out = [logits[:, -1].float()]
        tok = torch.argmax(out[0], -1)[:, None].to(torch.int32)
        toks = [tok]
        for i in range(TP_STEPS):
            if feed is not None:
                tok = feed[:, i:i + 1].to(device)
            tok, logits, caches = decode(model, tok, n_pos + i, caches)
            out.append(logits[:, -1].float())
            toks.append(tok)
        torch.cuda.synchronize(device)
        secs = time.perf_counter() - t0
    finally:
        restore()
    return torch.stack(out).cpu(), torch.cat(toks, 1).cpu(), secs, records


def tp_worker(args) -> None:
    """One rank of phase 15 (``--tp-dir``, started by
    ``launch.mesh.run_ranks``): joins the process mesh, then for each
    case draws its slice of the weights, serves the parent's requests fed
    the parent's tokens (the full-width cases twice: cold, warm) and saves
    its logits and routing."""
    sys.path.insert(0, str(SRC))
    from repro_torch.launch.mesh import (init_process_mesh,
                                         shutdown_process_mesh)
    from repro_torch.models.model import init_sharded
    work = Path(args.tp_dir)
    job = torch.load(work / "job.pt")
    torch.backends.cuda.matmul.allow_tf32 = False
    pm = init_process_mesh(1, TP_RANKS, job["backend"], "cuda",
                           timeout_s=TP_TIMEOUT_S)
    try:
        stats, logits, routing = {}, {}, {}
        for (name, cfg, inputs), feed in zip(tp_cases(args.seed),
                                             job["feeds"]):
            layout = pm.layout(cfg, TP_BATCH)
            t0 = time.perf_counter()
            model = init_sharded(torch.Generator(device=pm.device)
                                 .manual_seed(args.seed), cfg, layout,
                                 pm.device)
            torch.cuda.synchronize(pm.device)
            init_s = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats(pm.device)
            got, _, cold, records = tp_serve(model, cfg, inputs, feed,
                                             pm.device, layout)
            logits[name], routing[name] = got, records
            if name in TP_FULL:
                _, _, warm, _ = tp_serve(model, cfg, inputs, feed, pm.device,
                                         layout)
                stats[name] = {
                    "split": layout.report(), "init_s": init_s,
                    "cold_s": cold, "warm_s": warm,
                    "params": sum(p.numel() for p in model.parameters()),
                    "peak_gb": torch.cuda.max_memory_allocated(
                        pm.device) / 1e9}
            del model
        torch.save({"logits": logits, "routing": routing},
                   work / f"rank{pm.rank}.pt")
        print("RESULT " + json.dumps(dict(stats=stats, rank=pm.rank,
                                          device=str(pm.device),
                                          backend=pm.backend)), flush=True)
    finally:
        shutdown_process_mesh(pm)


def serve_across_ranks(args, gpu) -> None:
    """Phase 15: each case of ``tp_cases`` unsharded on the card (its
    logits and routing kept on the host, its model freed), then over
    ``model=2`` in two processes (``launch.mesh.run_ranks``): over gloo
    on ``cuda:0`` on a machine of one card, over NCCL on two cards where
    it has them. Each rank draws its slice of the same weights
    (``init_sharded``) and serves the same 2 requests fed the unsharded
    run's tokens. Both ranks' logits and routing must be equal; the smoke
    configs' (f32) logits within ``LM_F32_TOL`` of the unsharded run's
    and their routing the unsharded run's; the full-width runs' within
    ``TP_NORM_TOL`` normwise; greedy tokens equal wherever the unsharded
    run's top-2 margin exceeds the limit (for a full-width run, the
    largest difference measured)."""
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models.model import init_params
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    exp, feeds, whole, exp_routing = {}, [], {}, {}
    for name, cfg, inputs in tp_cases(args.seed):
        model = init_params(torch.Generator(device=gpu).manual_seed(
            args.seed), cfg, device=gpu)
        logits, toks, secs, records = tp_serve(model, cfg, inputs, None,
                                               gpu)
        exp[name], exp_routing[name] = logits, records
        feeds.append(toks[:, :TP_STEPS])
        if name in TP_FULL:
            _, _, warm, _ = tp_serve(model, cfg, inputs, None, gpu)
            whole[name] = {
                "params": sum(p.numel() for p in model.parameters()),
                "cold_s": secs, "warm_s": warm, "layers": cfg.n_layers}
        del model
        torch.cuda.empty_cache()
    backend = "nccl" if torch.cuda.device_count() >= TP_RANKS else "gloo"
    with tempfile.TemporaryDirectory() as work:
        torch.save({"feeds": feeds, "backend": backend},
                   Path(work) / "job.pt")
        ranks = run_ranks([str(Path(__file__).resolve()), "--tp-dir", work,
                           "--seed", str(args.seed)], TP_RANKS,
                          TP_TIMEOUT_S)
        results, got = [], []
        for r, (rc, log) in enumerate(ranks):
            lines = [ln for ln in log.splitlines() if ln.startswith("RESULT ")]
            if rc != 0 or not lines:
                print(log[-4000:])
                fail(f"phase 15: rank {r} exited {rc}")
            results.append(json.loads(lines[-1][len("RESULT "):]))
            got.append(torch.load(Path(work) / f"rank{r}.pt"))
    devices = [res["device"] for res in results]
    check(len(set(devices)) == (TP_RANKS if backend == "nccl" else 1),
          f"phase 15: ranks on {devices}")
    smoke, full, moe = {}, {}, []
    for name, want in exp.items():
        logits = got[0]["logits"][name]
        check(all(torch.equal(g["logits"][name], logits) for g in got),
              f"phase 15 {name}: the ranks hold different logits")
        check(bool(torch.isfinite(logits).all()), f"phase 15 {name}: a "
              f"logit is not finite")
        rank_routing = [g["routing"][name] for g in got]
        check(len(rank_routing[0]) == len(exp_routing[name])
              and all(len(rr) == len(rank_routing[0]) and all(
                  torch.equal(a[0], b[0]) and a[1] == b[1]
                  for a, b in zip(rr, rank_routing[0]))
                      for rr in rank_routing),
              f"phase 15 {name}: the ranks route differently")
        diff = (logits - want).abs()
        top2 = torch.topk(want, 2).values
        margin = top2[..., 0] - top2[..., 1]
        if name not in TP_FULL:
            tol = JAMBA_F32_TOL if name == TP_FAMILY_ARCH else LM_F32_TOL
            check(bool(lm_close(logits, want, tol).all()),
                  f"phase 15 {name}: logits differ from the unsharded "
                  f"run's by {float(diff.max()):.3g}")
            if exp_routing[name]:
                check(all(torch.equal(a[0], b[0]) for a, b in
                          zip(rank_routing[0], exp_routing[name])),
                      f"phase 15 {name}: routing differs from the "
                      f"unsharded run's")
                moe.append(f"{name} {len(exp_routing[name])}")
            clear = margin > tol["atol"] + tol["rtol"] * top2[..., 0].abs()
            smoke[name] = f"{name} {float(diff.max()):.2g}"
        else:
            limit = TP_F32_NORM_TOL if TP_FULL[name][2] == "float32" \
                else TP_NORM_TOL
            norm = (torch.linalg.vector_norm(logits - want, dim=-1)
                    / torch.linalg.vector_norm(want, dim=-1)).amax(-1)
            check(float(norm.max()) <= limit, f"phase 15 {name}: "
                  f"logits differ from the unsharded run's by "
                  f"{[round(float(v), 6) for v in norm]} normwise")
            worst = float(diff.max())
            clear = margin > worst
            ulps = (diff / bf16_ulp(want.abs().amax(-1, keepdim=True))
                    ).amax(dim=(1, 2))
            off = int((~lm_close(logits, want)).sum())
            same = torch.argmax(logits, -1) == torch.argmax(want, -1)
            drops = [d for _, d in exp_routing[name]]
            same_route = sum(int((a[0] == b[0]).all(-1).sum()) for a, b in
                             zip(rank_routing[0], exp_routing[name]))
            n_route = sum(a[0].shape[0] for a in exp_routing[name])
            full[name] = (
                f"normwise difference by position "
                f"{[float(f'{v:.3g}') for v in norm]} (limit "
                f"{limit}), largest {worst:.3g} "
                f"({[round(float(u), 1) for u in ulps]} bf16 ulps of "
                f"the row's largest logit), {off} of {want.numel()} "
                f"outside rtol 0.08, atol 0.15; greedy tokens equal at the "
                f"{int(clear.sum())} of {clear.numel()} positions whose "
                f"margin exceeds it ({int(same.sum())} equal in all)"
                + (f"; dropped_frac by MoE layer call up to "
                   f"{max(drops):.3f}; the same experts for {same_route} of "
                   f"{n_route} tokens' MoE layer calls" if drops else ""))
        check(torch.equal(torch.argmax(logits, -1)[clear],
                          torch.argmax(want, -1)[clear]),
              f"phase 15 {name}: a greedy token differs where the "
              f"unsharded run's margin is clear")
    limit = f"(limit rtol {LM_F32_TOL['rtol']} atol {LM_F32_TOL['atol']})"
    print(f"[tp] phase 15a: the dense archs' smoke configs in f32 over "
          f"model={TP_RANKS}, largest |logit difference| from the unsharded "
          f"run: {', '.join(smoke[a] for a in SERVED_ARCHS)} {limit}",
          flush=True)
    print(f"[tp] phase 15c: the other families' smoke configs in f32 over "
          f"model={TP_RANKS}: {', '.join(smoke[a] for a in FAMILY_ARCHS)} "
          f"{limit}, jamba's atol {JAMBA_F32_TOL['atol']}; routing of the "
          f"MoE layer calls ({', '.join(moe)}) equal on both ranks and to "
          f"the unsharded run's", flush=True)
    for name, (arch, _, dtype) in TP_FULL.items():
        w = whole[name]
        stats = [res["stats"][name] for res in results]
        print(f"[tp] phase {name}: {arch} at published widths in {dtype}, "
              f"{w['layers']} layers ({w['params'] / 1e9:.2f} B "
              f"parameters), {TP_BATCH} x {TP_PROMPT} tokens and {TP_STEPS} "
              f"steps: unsharded on {gpu} {w['cold_s']:.2f} s cold, "
              f"{w['warm_s']:.2f} s warm; over model={TP_RANKS} on "
              f"{devices} by {backend}, {stats[0]['split']}, "
              + "; ".join(f"rank {r} {st['params'] / 1e9:.2f} B "
                          f"parameters drawn in {st['init_s']:.1f} s, served "
                          f"{st['cold_s']:.2f} s cold, {st['warm_s']:.2f} s "
                          f"warm, peak {st['peak_gb']:.1f} GB"
                          for r, st in enumerate(stats))
              + f"; logits equal on both ranks; {full[name]}", flush=True)
    print(f"[tp] phase 15 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# -- phase 16: training across ranks ---------------------------------------

# 16a: each arch's smoke config in f32 (TF32 off) over model=2; 16b
# llama3-8b's and deepseek-v2's over data=2, deepseek-v2's with capacity
# factor 0.5 and 96 positions a row so that experts overflow; a batch of
# TT_BATCH rows, one make_train_step step (lr TT_LR, constant schedule).
# Held against the unsplit run on the card: the loss within rtol 1e-5,
# each joined gradient normwise within TT_NORM (the archs of TT_NORM_LOOSE
# looser), the grad norm within the same share, mu and nu within 2 and 4
# times it, the parameters within 2 x lr (TRAIN_STEP_ATOL's reason). The
# CPU tests (tests/_torch_tp_train.py) measured the split's own rounding
# at up to 7.4e-5 normwise (jamba 7.2e-4, deepseek-v3 3.6e-4, whisper
# 3.3e-4, llava 1.9e-4): random-init smoke models move by 1e-4-2e-3 under
# an ulp's change of their weights
TT_BATCH, TT_SEQ, TT_LR = 2, 24, 1e-3
TT_DROP = (("deepseek-v2-236b", 0.5, 96),)
TT_NORM = 2e-4
TT_NORM_LOOSE = {"jamba-v0.1-52b": 4e-3, "deepseek-v3-671b": 2e-3,
                 "whisper-base": 2e-3, "llava-next-mistral-7b": 1.2e-3}
# 16c: the launcher as users run it, 4 steps over --mesh model=2 saving
# every 2, its step-4 checkpoint removed, then --resume auto over --mesh
# data=2 (bf16 smoke: the resumed losses within RESUME_RTOL)
TT_ARGV = ["-m", "repro_torch.launch.train", "--arch", "llama3-8b",
           "--smoke", "--steps", "4", "--batch", "4", "--seq", "64",
           "--save-every", "2", "--log-every", "1", "--dist-backend",
           "gloo"]
# 16d: llama3-8b's smoke config with 2 periods in f32 over 2 stages, 8
# rows in 4 microbatches, against the whole forward on the card: within
# this share of the largest |logit|; then the backward of sum(logits *
# ct) (ct drawn from --seed, remat "full") of llama3-8b's and gemma-7b's
# (its embedding tied to the head) against the unsplit model's backward of
# the same microbatches on the card (tools.tp_train.microbatch_logits: the
# pipeline's order of sums): each leaf within TT_PIPE_GRAD_TOL of its
# largest |value| (0 on the CPU, tests/test_torch_gpipe_grad.py; 5e-7
# against each microbatch's backward summed first to last), the
# embedding, head and final norm bit-identical on both stages
TT_PIPE = (2, 8, 24, 4)
TT_PIPE_TOL = 1e-4
TT_PIPE_GRAD = ("llama3-8b", "gemma-7b")
TT_PIPE_GRAD_TOL = 1e-5
TT_TIMEOUT_S = 300


def tt_cases(seed):
    """(name, config, arrays, data split) of phase 16a and 16b: each
    arch's smoke config in f32 over model=2, then llama3-8b's and the
    MoE drop case over data=2; ``TT_BATCH`` rows, row 0's first 3 labels
    masked, patches and frames drawn from ``seed``."""
    import dataclasses
    from repro_torch.configs import ARCH_IDS, get_smoke_config
    rng = np.random.default_rng(seed)
    cases = []

    def case(name, arch, seq, split, **moe):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                                  param_dtype="float32")
        if moe:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, **moe))
        nv = cfg.n_patches if cfg.frontend == "vision" else 0
        toks = rng.integers(0, cfg.vocab, (TT_BATCH, seq - nv + 1))
        labels = toks[:, 1:].copy()
        labels[0, :3] = -100
        arrays = {"tokens": toks[:, :-1].astype(np.int32),
                  "labels": labels.astype(np.int32)}
        if nv:
            arrays["patches"] = rng.normal(0, 1, (TT_BATCH, nv, 1024))
        if cfg.is_encdec:
            arrays["frames"] = rng.normal(0, 1, (TT_BATCH, cfg.enc_seq, 128))
        cases.append((name, cfg, arrays, split))

    for arch in ARCH_IDS:
        case(arch, arch, TT_SEQ, False)
    case("llama3-8b d2", "llama3-8b", TT_SEQ, True)
    for arch, factor, seq in TT_DROP:
        case(f"{arch} drops d2", arch, seq, True, capacity_factor=factor)
    return cases


def tt_pipe_case(arch, seed):
    """(config, tokens, cotangent) of a phase 16d backward case: the smoke
    config in f32 with ``TT_PIPE``'s periods and ``remat="full"``, the
    tokens and ``ct`` drawn from ``seed``."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    periods, b, seq, _ = TT_PIPE
    cfg = dataclasses.replace(get_smoke_config(arch), n_periods=periods,
                              remat="full", dtype="float32",
                              param_dtype="float32")
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (b, seq)).astype(np.int32)
    ct = rng.standard_normal((b, seq, cfg.vocab), dtype=np.float32)
    return cfg, torch.from_numpy(tokens), torch.from_numpy(ct)


def tt_batch(arrays, rows, device):
    return {k: torch.from_numpy(np.ascontiguousarray(v[rows])).to(
        device, torch.bfloat16 if k in ("patches", "frames") else None)
        for k, v in arrays.items()}


def tt_run(model, cfg, batch):
    """Of ``model`` (a rank's slice or the whole) on ``batch``: the loss of
    a forward without gradients and each MoE layer call's routing, then
    one ``make_train_step`` step: its loss and grad norm, each gradient
    as the step's exchange completed it, every parameter and moment after
    it; on the host."""
    from repro_torch.models import model as TM
    from repro_torch.train import step as TS
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    records, restore = moe_recorder()
    try:
        with torch.no_grad():
            _, metrics = TM.forward_train(model, batch)
        routing = list(records)
    finally:
        restore()
    noted, exchange = {}, TS.exchange_grads

    def noting(grads, classes, layout):
        exchange(grads, classes, layout)
        noted.update({k: g.detach().float().cpu() for k, g in grads.items()})

    opt = AdamWConfig(lr=TT_LR)
    params = dict(model.named_parameters())
    state = init_opt_state(params, opt)
    TS.exchange_grads = noting
    try:
        _, state, m = TS.make_train_step(cfg, opt, schedule="constant")(
            model, state, batch)
    finally:
        TS.exchange_grads = exchange

    def host(tree):
        return {k: v.detach().float().cpu() for k, v in tree.items()}
    return dict(loss=float(metrics["loss"]), step_loss=float(m["loss"]),
                gnorm=float(m["grad_norm"]), routing=routing, grad=noted,
                param=host(params), mu=host(state.mu), nu=host(state.nu))


def tt_worker(args) -> None:
    """One rank of phase 16 (``--tt-dir``, started by
    ``launch.mesh.run_ranks``): each case of ``tt_cases`` on its slice
    (model=2) or its rows (data=2) of the same weights, then its stage of
    the pipelined forward; its results saved for the parent."""
    sys.path.insert(0, str(SRC))
    import dataclasses
    import torch.distributed as dist
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import (ProcessMesh, init_process_mesh,
                                         shutdown_process_mesh)
    from repro_torch.models.model import init_params, init_sharded
    from repro_torch.train.step import (make_pipelined_forward, stage_model,
                                        train_rows)
    work = Path(args.tt_dir)
    torch.backends.cuda.matmul.allow_tf32 = False
    pm = init_process_mesh(1, TT_RANKS, "gloo", "cuda",
                           timeout_s=TT_TIMEOUT_S)
    try:
        # the same ranks as a data=2 mesh: the world is its data group
        dm = ProcessMesh(TT_RANKS, 1, pm.rank, pm.device, pm.backend, None,
                         dist.group.WORLD)
        out = {}
        for name, cfg, arrays, split in tt_cases(args.seed):
            layout = (dm if split else pm).layout(cfg, TT_BATCH, "train")
            model = init_sharded(torch.Generator(device=pm.device)
                                 .manual_seed(args.seed), cfg, layout,
                                 pm.device)
            out[name] = tt_run(model, cfg, tt_batch(
                arrays, train_rows(layout, TT_BATCH), pm.device))
            out[name]["split"] = sorted(layout.split)
            del model
        periods, b, seq, micro = TT_PIPE
        cfg = dataclasses.replace(get_smoke_config("llama3-8b"),
                                  n_periods=periods, remat="none",
                                  dtype="float32", param_dtype="float32")
        whole = init_params(torch.Generator(device=pm.device).manual_seed(
            args.seed), cfg, device=pm.device)
        tokens = torch.from_numpy(np.random.default_rng(args.seed).integers(
            0, cfg.vocab, (b, seq)).astype(np.int32)).to(pm.device)
        out["pipeline"] = make_pipelined_forward(cfg, TT_RANKS)(
            stage_model(whole, TT_RANKS, pm.rank), {"tokens": tokens},
            micro).cpu()
        t0 = time.perf_counter()
        for arch in TT_PIPE_GRAD:
            cfg, tokens, ct = tt_pipe_case(arch, args.seed)
            stage = stage_model(init_params(torch.Generator(
                device=pm.device).manual_seed(args.seed), cfg,
                device=pm.device), TT_RANKS, pm.rank)
            stage.requires_grad_(True)
            logits = make_pipelined_forward(cfg, TT_RANKS)(
                stage, {"tokens": tokens.to(pm.device)}, micro)
            (logits * ct.to(pm.device)).sum().backward()
            out[f"pipe-grad {arch}"] = {
                k: (p.grad if p.grad is not None else torch.zeros_like(p))
                .cpu() for k, p in stage.named_parameters()}
        out["pipe-grad s"] = time.perf_counter() - t0
        torch.save(out, work / f"rank{pm.rank}.pt")
        print("RESULT " + json.dumps(dict(rank=pm.rank,
                                          device=str(pm.device),
                                          backend=pm.backend)), flush=True)
    finally:
        shutdown_process_mesh(pm)


def tt_join(cfg, parts, mesh, prefix):
    """Each parameter of the ranks' ``prefix`` arrays (a model group's:
    ``parts`` by model rank) joined whole: a cut one's runs put in place
    (a run held whole from the first rank), a whole one the first
    rank's."""
    from repro_torch.dist.plan import CUT, grad_classes, shard_layout
    from repro_torch.models.model import abstract_params
    out = {}
    models = [abstract_params(cfg, layout=shard_layout(
        cfg, mesh, r, TT_BATCH, "train")) for r in range(len(parts))]
    classes = [grad_classes(m) for m in models]
    for name, c0 in classes[0].items():
        if c0.kind != CUT:
            out[name] = parts[0][prefix][name]
            continue
        whole = torch.zeros(models[0].whole_shape(name))
        for r, part in enumerate(parts):
            c = classes[r][name]
            for (start, n), (at, _, held) in zip(c.cut.pieces, c.runs):
                if not held or r == 0:
                    whole.narrow(c.cut.dim, start, n).copy_(
                        part[prefix][name].narrow(c.cut.dim, at, n))
        out[name] = whole
    return out


def train_across_ranks(args, gpu) -> None:
    """Phase 16: each case of ``tt_cases`` unsplit on the card (one step,
    its results kept on the host), then by two processes on the card over
    gloo (``launch.mesh.run_ranks``; NCCL refuses two ranks on one card):
    16a over model=2, 16b over data=2, 16d the pipelined forward and
    backward over 2 stages; then 16c the launcher over model=2, resumed
    over data=2."""
    import dataclasses
    import shutil
    from repro_torch.configs import get_smoke_config
    from repro_torch.dist.plan import WHOLE, grad_classes, shard_layout
    from repro_torch.launch.mesh import ProcessMesh, run_ranks
    from repro_torch.models import model as TM
    from repro_torch.models.model import abstract_params, init_params
    from repro_torch.tools.tp_train import microbatch_logits
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    refs, cases = {}, tt_cases(args.seed)
    for name, cfg, arrays, _ in cases:
        model = init_params(torch.Generator(device=gpu).manual_seed(
            args.seed), cfg, device=gpu)
        refs[name] = tt_run(model, cfg, tt_batch(arrays, slice(None), gpu))
        del model
    periods, b, seq, micro = TT_PIPE
    pcfg = dataclasses.replace(get_smoke_config("llama3-8b"),
                               n_periods=periods, remat="none",
                               dtype="float32", param_dtype="float32")
    whole = init_params(torch.Generator(device=gpu).manual_seed(args.seed),
                        pcfg, device=gpu)
    tokens = torch.from_numpy(np.random.default_rng(args.seed).integers(
        0, pcfg.vocab, (b, seq)).astype(np.int32)).to(gpu)
    with torch.no_grad():
        h, _ = TM._run_stack(whole, TM._embed_inputs(whole, {
            "tokens": tokens}), torch.arange(seq, device=gpu)[None].expand(
            b, seq))
        plain = TM._logits(whole, h).cpu()
    del whole
    t_grad = time.perf_counter()
    pipe_refs = {}
    for arch in TT_PIPE_GRAD:
        gcfg, gtok, gct = tt_pipe_case(arch, args.seed)
        gw = init_params(torch.Generator(device=gpu).manual_seed(args.seed),
                         gcfg, device=gpu)
        gw.requires_grad_(True)
        (microbatch_logits(gw, gtok.to(gpu), micro) * gct.to(gpu)).sum(
            ).backward()
        pipe_refs[arch] = (gcfg, {
            k: (p.grad if p.grad is not None else torch.zeros_like(p)).cpu()
            for k, p in gw.named_parameters()})
        del gw
    t_grad = time.perf_counter() - t_grad
    with tempfile.TemporaryDirectory() as work:
        ranks = run_ranks([str(Path(__file__).resolve()), "--tt-dir", work,
                           "--seed", str(args.seed)], TT_RANKS, TT_TIMEOUT_S)
        for r, (rc, log) in enumerate(ranks):
            if rc != 0 or "RESULT " not in log:
                print(log[-4000:])
                fail(f"phase 16: rank {r} exited {rc}")
        got = [torch.load(Path(work) / f"rank{r}.pt")
               for r in range(TT_RANKS)]
    lines = {"16a": [], "16b": []}
    for name, cfg, _, split in cases:
        ref, parts = refs[name], [g[name] for g in got]
        what = f"phase 16 {name}"
        # the mesh's shape, as dist.plan reads it
        mesh = ProcessMesh(TT_RANKS, 1, 0, gpu) if split \
            else ProcessMesh(1, TT_RANKS, 0, gpu)
        limit = TT_NORM_LOOSE.get(name.split()[0], TT_NORM)
        n = TT_BATCH // TT_RANKS if split else TT_BATCH
        for r, part in enumerate(parts):
            lo = r * n if split else 0
            check(abs(part["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"])
                  and abs(part["step_loss"] - ref["step_loss"])
                  <= 1e-5 * abs(ref["loss"]),
                  f"{what}: rank {r} loss {part['loss']}, unsplit "
                  f"{ref['loss']}")
            check(abs(part["gnorm"] - ref["gnorm"]) <= limit * ref["gnorm"],
                  f"{what}: rank {r} grad norm {part['gnorm']}, unsplit "
                  f"{ref['gnorm']}")
            # each MoE layer call: this rank's tokens' experts, the
            # global batch's dropped_frac
            check(len(part["routing"]) == len(ref["routing"]) and all(
                torch.equal(got_idx, idx.reshape(TT_BATCH, -1, idx.shape[-1])
                            [lo:lo + n].reshape(got_idx.shape))
                and abs(got_drop - drop) <= 1e-7
                for (got_idx, got_drop), (idx, drop)
                in zip(part["routing"], ref["routing"])),
                f"{what}: rank {r} routes differently from the unsplit run")
        worst = {}
        joined = parts[0] if split else {
            p: tt_join(cfg, parts, mesh, p)
            for p in ("grad", "param", "mu", "nu")}
        for prefix, factor in (("grad", 1), ("mu", 2), ("nu", 4)):
            for k, exp in ref[prefix].items():
                den = float(torch.linalg.vector_norm(exp))
                gap = float(torch.linalg.vector_norm(joined[prefix][k] - exp)
                            ) / (den if den else 1.0)
                worst[prefix] = max(worst.get(prefix, 0.0), gap)
                check(gap <= factor * limit, f"{what}: {prefix} of {k} "
                      f"differs from the unsplit run's by {gap:.3g} "
                      f"normwise")
        step_gap = max(float((joined["param"][k] - v).abs().max())
                       for k, v in ref["param"].items())
        check(step_gap <= TRAIN_STEP_ATOL, f"{what}: a parameter after the "
              f"step differs by {step_gap}")
        # what the ranks hold whole is the same on both, bit for bit; over
        # data=2 every leaf is
        classes = grad_classes(abstract_params(cfg, layout=shard_layout(
            cfg, mesh, 0, TT_BATCH, "train")))
        for k, c in classes.items():
            for prefix in ("param", "mu", "nu", "grad"):
                if split or c.kind != "cut":
                    same = torch.equal(parts[0][prefix][k],
                                       parts[1][prefix][k])
                else:
                    same = all(torch.equal(
                        parts[0][prefix][k].narrow(c.cut.dim, at, n),
                        parts[1][prefix][k].narrow(c.cut.dim, at, n))
                        for at, n in c.whole_runs)
                check(same, f"{what}: the ranks' {prefix} of {k} differ")
        n_whole = sum(c.kind == WHOLE for c in classes.values())
        drops = max((d for _, d in ref["routing"]), default=0.0)
        lines["16b" if split else "16a"].append(
            f"{name} grad {worst['grad']:.2g} mu {worst['mu']:.2g} nu "
            f"{worst['nu']:.2g} (limit {limit:g}), params within "
            f"{step_gap:.2g}" + (f", max dropped_frac {drops:.3f}"
                                 if ref["routing"] else ""))
        if not split:
            check(n_whole < len(classes), f"{what}: nothing is cut")
    print(f"[tt] phase 16a: the ten archs' smoke configs in f32 over "
          f"model={TT_RANKS} (gloo on {gpu}), one train step against the "
          f"unsplit run on the card: losses within rtol 1e-5, grad norms, "
          f"routing equal, parts held whole bit-identical on both ranks; "
          f"largest normwise differences: " + "; ".join(lines["16a"]),
          flush=True)
    print(f"[tt] phase 16b: over data={TT_RANKS}, both replicas "
          f"bit-identical: " + "; ".join(lines["16b"]), flush=True)
    pipe = got[0]["pipeline"]
    top = float(plain.abs().max())
    gap = float((pipe - plain).abs().max())
    check(torch.equal(pipe, got[1]["pipeline"]) and gap <= TT_PIPE_TOL * top,
          f"phase 16d: the pipelined forward differs from the whole one by "
          f"{gap} (largest |logit| {top})")
    print(f"[tt] phase 16d: make_pipelined_forward over {TT_RANKS} stages "
          f"({periods} periods of llama3-8b's smoke config in f32, {b} rows "
          f"of {seq} in {micro} microbatches): both stages' logits equal, "
          f"within {gap:.3g} of the whole forward's (largest |logit| "
          f"{top:.4g}, limit {TT_PIPE_TOL} of it)", flush=True)
    notes = []
    for arch, (gcfg, want) in pipe_refs.items():
        parts = [g[f"pipe-grad {arch}"] for g in got]
        per = gcfg.n_periods // TT_RANKS * len(gcfg.pattern)
        worst, leaf = 0.0, None
        for r, part in enumerate(parts):
            for k, g in part.items():
                name = k
                if k.startswith("blocks."):
                    _, i, rest = k.split(".", 2)
                    name = f"blocks.{int(i) + r * per}.{rest}"
                elif r:
                    check(torch.equal(g, parts[0][k]), f"phase 16d {arch}: "
                          f"the stages' gradients of {k} differ")
                exp = want[name]
                scale = float(exp.abs().max()) or 1.0
                rel = float((g - exp).abs().max()) / scale
                check(torch.isfinite(g).all() and rel <= TT_PIPE_GRAD_TOL,
                      f"phase 16d {arch}: the pipeline's gradient of {k} "
                      f"(stage {r}) differs from the unsplit backward's by "
                      f"{rel:.3g} of its largest |value|")
                if rel >= worst:
                    worst, leaf = rel, k
        notes.append(f"{arch} {worst:.3g} ({leaf})")
    pipe_s = max(g["pipe-grad s"] for g in got)
    print(f"[tt] phase 16d: the pipeline's backward of sum(logits * ct) over "
          f"{TT_RANKS} stages (remat full, f32) against the unsplit "
          f"backward of the same microbatches on the card: the embedding, "
          f"head and final norm bit-identical on both stages, largest gap "
          f"of a leaf's largest |value| (limit {TT_PIPE_GRAD_TOL:g}): "
          + "; ".join(notes) + f"; the backward cases added "
          f"{t_grad + pipe_s:.1f} s ({t_grad:.1f} s unsplit, {pipe_s:.1f} "
          f"s over the stages)", flush=True)

    # 16c: the launcher as users run it
    env = dict(os.environ, PYTHONPATH=str(SRC))
    with tempfile.TemporaryDirectory() as ckpt:
        logs = []
        for mesh, extra in (("model=2", []),
                            ("data=2", ["--resume", "auto"])):
            if extra:
                shutil.rmtree(os.path.join(ckpt, "step_00000004"))
            ranks = run_ranks(TT_ARGV + ["--mesh", mesh, "--ckpt-dir", ckpt]
                              + extra, TT_RANKS, TT_TIMEOUT_S, env=env)
            for r, (rc, log) in enumerate(ranks):
                if rc != 0:
                    print(log[-4000:])
                    fail(f"phase 16c: rank {r} of --mesh {mesh} exited {rc}")
            logs.append(ranks[0][1])
            saved = sorted(os.listdir(ckpt))
    losses = []
    for log in logs:
        losses.append({int(ln.split()[1]): float(ln.split("loss=")[1]
                                                 .split()[0])
                       for ln in log.splitlines()
                       if ln.startswith("step ")})
    first, again = losses
    check(sorted(first) == [0, 1, 2, 3] and sorted(again) == [2, 3]
          and "resumed from step 2" in logs[1]
          and "split=['experts', 'heads', 'kv_heads', 'mlp', 'vocab']"
          in logs[0] and all(np.isfinite(v) for v in
                             list(first.values()) + list(again.values()))
          and all(abs(again[i] - first[i]) <= RESUME_RTOL * abs(first[i])
                  for i in again), f"phase 16c: losses {first} over "
          f"model=2, resumed over data=2 {again}")
    print(f"[tt] phase 16c: python {' '.join(TT_ARGV)} --mesh model=2 "
          f"(bf16 on {gpu}): losses {first}, checkpoints {saved}; resumed "
          f"from step 2 over --mesh data=2 (--resume auto): losses {again} "
          f"(within rtol {RESUME_RTOL})", flush=True)
    print(f"[tt] phase 16 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30)))
                      - 7)


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
    ap.add_argument("--mp-rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--mp-dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--tp-dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--tt-dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs on the card only")
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        fail(f"the repro_torch package is missing under {SRC}")
    if args.mp_rank is not None:
        process_worker(args)
        return
    if args.tp_dir is not None:
        tp_worker(args)
        return
    if args.tt_dir is not None:
        tt_worker(args)
        return
    sys.path.insert(0, str(SRC))

    from repro_torch import decode_batch
    from repro_torch.core import api
    from repro_torch.core import decode as D
    from repro_torch.core.bitstream import validate_blob
    from repro_torch.core.api import ParallelDecoder
    from repro_torch.data.jpeg_pipeline import JpegVisionPipeline
    from repro_torch.dist import plan as DP
    from repro_torch.core import sync as SY
    from repro_torch.core.state import DecodeState
    from repro_torch.core.sync import chain_entries, jacobi_sync
    from repro_torch.jpeg import codec_ref as cr
    from repro_torch.jpeg.encoder import (Dataset, DatasetSpec,
                                          build_dataset, synth_frame)
    from repro_torch.kernels import build
    from repro_torch.kernels.color import ops as CK
    from repro_torch.kernels.fused import pixels as FP
    from repro_torch.kernels.fused import store as FS
    from repro_torch.kernels.huffman import ops as HK
    from repro_torch.kernels.idct import ops as IK
    from repro_torch.serve import DecodeService, ServiceConfig, run_open_loop

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = torch.device("cuda")

    # -- 1. build ----------------------------------------------------------
    # the release libraries and the checked ones (phase 10), one nvcc a
    # source, all at once
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        jobs = [(kind, pool.submit(build.build_all, names, kind == "checked"))
                for kind, names in (("release", build.SOURCES),
                                    ("checked", build.CHECKED_SOURCES))]
        reports = [(kind, job.result()) for kind, job in jobs]
    for kind, report in reports:
        for name, (secs, log) in report.items():
            print(f"[build] {name}.cu ({kind}): {secs:.1f} s")
            for line in log.splitlines():
                if "registers" in line or "spill" in line \
                        or "smem" in line or "Compiling entry" in line:
                    print(f"[build]   {line.strip()}")
    for name in build.SOURCES:
        build.load(name)
    for name in build.CHECKED_SOURCES:
        build.load(name, checked=True)
    print(f"[build] all kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # -- the full-width batch -----------------------------------------------
    t0 = time.perf_counter()
    spec = DatasetSpec("newyork", args.distinct, args.width, args.height,
                       args.quality)
    dataset = build_dataset(spec, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    frames = [synth_frame(rng, args.width, args.height, t=0.13 * i)
              for i in range(args.distinct)]
    distinct = [cr.encode_baseline(f, quality=args.quality,
                                   subsampling="4:2:0").jpeg_bytes
                for f in frames]
    check(dataset.jpeg_bytes == distinct, "build_dataset's frames differ "
          "from the frames encoded here")
    blobs = [b for b in distinct for _ in range(args.repeat)]
    # two frames at 4:2:2 and at 4:4:4, for the fused pixel kernel's
    # layouts of their own besides 4:2:0
    layouts = {s: [cr.encode_baseline(f, quality=args.quality,
                                      subsampling=s).jpeg_bytes
                   for f in frames[:2]] for s in ("4:2:2", "4:4:4")}
    mb = sum(map(len, blobs)) / 1e6
    print(f"[data] {len(blobs)} frames {args.width}x{args.height} 4:2:0 "
          f"q{args.quality} ({args.distinct} distinct), {mb:.1f} MB "
          f"compressed, encoded in {time.perf_counter() - t0:.1f} s; "
          f"build_dataset({spec}) gives the same bytes", flush=True)
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
    # the stream kernel, its tables in shared memory and in global memory
    pos_p, val_p = HK.decode_streams_plain(dev, meta, entries, **kw)
    stream_err = 0
    for where, budget in (("global", 0), ("shared", HK.EXIT_SMEM_BUDGET)):
        pos, val = HK.run_stream_kernel(dev, meta, entries, **kw,
                                        smem_budget=budget)
        torch.cuda.synchronize()
        stream_err = max(stream_err, max_err((pos, val), (pos_p, val_p)))
        check(stream_err == 0, f"stream kernel ({where} tables) differs "
              f"from its plain version by {stream_err}")
    pos, val = HK.decode_streams(dev, meta, entries, **kw)
    torch.cuda.synchronize()
    check(torch.equal(pos, pos_p) and torch.equal(val, val_p),
          "stream kernel differs from its plain version")
    lane_steps = (pos >= 0).sum(0)  # symbol steps each lane's data needs
    steps = int(lane_steps.sum())
    del pos_p, val_p
    ms_global = cuda_ms(lambda: HK.run_stream_kernel(
        dev, meta, entries, **kw, smem_budget=0), args.reps)
    print(f"[parity] stream kernel: shared-memory and global tables "
          f"bit-identical to the plain version; global tables "
          f"{ms_global:.4f} ms", flush=True)
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
           nbytes(*exit_tables, *lane_in, pos, val),
           steps * OPS_PER_SYMBOL_STEP, INT_OPS_PER_S)
    # the scatter after the stream kernel (torch; not a kernel of the port):
    # its device time, on a line of its own
    coef_stream = HK.scatter_streams(pos, val, bases, write_max, n_coef)
    scatter_ms = cuda_ms(lambda: HK.scatter_streams(pos, val, bases,
                                                    write_max, n_coef),
                         args.reps)
    print(f"[scatter] scatter_streams after the stream kernel: "
          f"{scatter_ms:.4f} ms ({pos.numel()} stream entries, {steps} "
          f"recorded)", flush=True)
    del pos, val
    # the store kernel, its tables in shared memory and in global memory
    coef_p = FS.decode_coeffs_store_plain(dev, meta, entries, bases,
                                          write_max, n_coef, **kw)
    store_err = 0
    for where, coef in (
            ("global", FS.run_store_kernel(dev, meta, entries, bases,
                                           write_max, n_coef, **kw,
                                           smem_budget=0)),
            ("shared", FS.decode_coeffs_store(dev, meta, entries, bases,
                                              write_max, n_coef, **kw))):
        torch.cuda.synchronize()
        store_err = max(store_err, max_err((coef,), (coef_p,)))
        check(torch.equal(coef, coef_p), f"store kernel ({where} tables) "
              f"differs from its plain version by {store_err}")
    check(torch.equal(coef_stream, coef_p), "stream kernel + scatter "
          "differs from the plain write pass")
    check(torch.equal(coef_stream, coef), "stream kernel + scatter differs "
          "from the store kernel")
    del coef_stream, coef_p
    ms_global = cuda_ms(lambda: FS.run_store_kernel(
        dev, meta, entries, bases, write_max, n_coef, **kw, smem_budget=0),
        args.reps)
    # the same frames at 256-bit chunks: most units split between lanes
    dec256 = ParallelDecoder.from_bytes(blobs, chunk_bits=256, device=gpu)
    sh256, dev256 = dec256.shape, dec256.dev
    meta256 = D.chunk_meta(dev256)
    kw256 = dict(s_max=sh256.s_max, min_code_bits=sh256.min_code_bits)
    res256 = jacobi_sync(dev256, max_rounds=sh256.n_chunks + 2,
                         decode_exits=lambda d, e: HK.decode_exits(
                             d, meta256, e, **kw256),
                         permuted=sh256.permuted)
    check(res256.converged, "kernel Jacobi sync at 256-bit chunks did not "
          "converge")
    w256 = (dev256, meta256,
            chain_entries(dev256, res256.exits, sh256.permuted),
            D.chunk_write_bases(dev256, res256.exits.n,
                                permuted=sh256.permuted))
    seg_end256 = torch.cat([dev256["seg_coeff_base"][1:],
                            dev256["units_end"][None]])
    w256 += (seg_end256[dev256["chunk_seg"].to(torch.int64)] - 1,
             sh256.n_units * 64)
    coef256 = FS.decode_coeffs_store(*w256, **kw256)
    coef256_p = FS.decode_coeffs_store_plain(*w256, **kw256)
    torch.cuda.synchronize()
    store_err = max(store_err, max_err((coef256,), (coef256_p,)))
    check(torch.equal(coef256, coef256_p), f"store kernel at 256-bit chunks "
          f"differs from its plain version by {store_err}")
    ms256 = cuda_ms(lambda: FS.decode_coeffs_store(*w256, **kw256),
                    args.reps)
    print(f"[parity] store kernel: shared-memory and global tables "
          f"bit-identical to the plain version; global tables "
          f"{ms_global:.4f} ms; at 256-bit chunks ({dec256.plan.n_chunks} "
          f"lanes, {res256.rounds} rounds) bit-identical, {ms256:.4f} ms",
          flush=True)
    del dec256, dev256, meta256, res256, w256, coef256, coef256_p
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
    m_t = dev["m_matrices_t"]
    blk = FP.fused_pixels(units, m_t, mrow, **geo)
    blk_p = FP.fused_pixels_plain(units, m_t, mrow, **geo)
    torch.cuda.synchronize()
    err = max_err((blk,), (blk_p,))
    check(torch.equal(blk, blk_p), f"pixel kernel differs from its plain "
          f"version by {err}")
    del blk, blk_p
    # partial last tiles (the last 2 tiles + 5 MCUs, and 5 MCUs)
    upm = g.units_per_mcu
    n_tail = 2 * FP.tile_mcus(upm) + 5
    for n in (n_tail, 5):
        tail = (units[-n * upm:], m_t, mrow[-n * upm:])
        check(torch.equal(FP.fused_pixels(*tail, **geo),
                          FP.fused_pixels_plain(*tail, **geo)),
              f"pixel kernel differs from its plain version on {n} MCUs")
    # the other layouts with a kernel of their own
    other, color_cases = [], {}
    for name, lay_blobs in layouts.items():
        ldec = ParallelDecoder.from_bytes(lay_blobs,
                                          chunk_bits=args.chunk_bits,
                                          device=gpu)
        lg = ldec.plan.geometry
        lunits = ldec.coefficients().coeffs
        lrow = ldec.dev["unit_mrow"][:ldec.plan.total_units]
        lgeo = dict(comp_h=tuple(lg.comp_h), comp_v=tuple(lg.comp_v),
                    h_max=lg.h_max, v_max=lg.v_max, upm=lg.units_per_mcu)
        lm = ldec.dev["m_matrices_t"]
        check(torch.equal(FP.fused_pixels(lunits, lm, lrow, **lgeo),
                          FP.fused_pixels_plain(lunits, lm, lrow, **lgeo)),
              f"pixel kernel differs from its plain version at {name}")
        lms = cuda_ms(lambda: FP.fused_pixels(lunits, lm, lrow, **lgeo),
                      args.reps)
        other.append(f"{name} {lunits.shape[0] // lg.units_per_mcu} MCUs "
                     f"{lms:.4f} ms")
        # the color kernel's planes of this layout, for its check below
        lgrid = [(lg.mcus_y * v, lg.mcus_x * h)
                 for h, v in zip(lg.comp_h, lg.comp_v)]
        color_cases[name] = (D.assemble_planes(
            IK.idct_units(lunits, lm, lrow, lg.units_per_mcu),
            ldec.plan.n_images, ldec._comp_unit_idx, ldec._comp_block_idx,
            lgrid), (lg.comp_h, lg.comp_v, lg.h_max, lg.v_max, lg.height,
                     lg.width))
        del ldec, lunits, lrow, lm
    # the matrices read from global memory: six, more than the kernel
    # stages, as a batch of three qualities has them (image k takes pair
    # k % 3 of copies of the plan's matrices)
    n_img = dec.plan.n_images
    check(units.shape[0] % n_img == 0 and m_t.shape[0] == 2,
          "the full-width batch is not 2 matrices over whole images")
    m_t6 = m_t.repeat(3, 1, 1).contiguous()
    per_img = units.shape[0] // n_img
    img = torch.arange(units.shape[0], device=gpu) // per_img
    mrow6 = (mrow + 2 * (img % 3)).to(torch.int32)
    check(torch.equal(FP.fused_pixels(units, m_t6, mrow6, **geo),
                      FP.fused_pixels_plain(units, m_t6, mrow6, **geo)),
          "pixel kernel with six matrices differs from its plain version")
    ms6 = cuda_ms(lambda: FP.fused_pixels(units, m_t6, mrow6, **geo),
                  args.reps)
    other.append(f"with six matrices read from global memory {ms6:.4f} ms")
    del m_t6, per_img, img, mrow6
    ms = cuda_ms(lambda: FP.fused_pixels(units, m_t, mrow, **geo), args.reps)
    plain_ms = cuda_ms(lambda: FP.fused_pixels_plain(
        units, m_t, mrow, **geo), 1)
    # the floor of a bit-identical product, as for the IDCT kernel below
    floor_ms = 2 * units.shape[0] * 64 * 64 / INT_OPS_PER_S * 1e3
    print(f"[parity] pixel kernel: equal on {units.shape[0] // upm} MCUs, on "
          f"{n_tail} and 5 MCUs (partial last tiles) and at "
          f"{', '.join(other)}; bit-identical floor {floor_ms:.4f} ms",
          flush=True)
    blk = FP.fused_pixels(units, m_t, mrow, **geo)
    record("fused_pixels", "src/repro_torch/kernels/csrc/pixels.cu",
           "src/repro/kernels/fused/pixels.py:164", err, ms, plain_ms,
           nbytes(units, mrow, m_t, blk), 2 * units.shape[0] * 64 * 64,
           F32_FLOP_PER_S)
    del blk

    # the unfused chain: IDCT kernel, plane assembly, color kernel
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
    err = max_err((rgb,), (rgb_p,))
    check(torch.equal(rgb, rgb_p), f"color kernel differs from its plain "
          f"version by {err}")
    del rgb_p
    # a crop whose width is not a multiple of the kernel's run (rows of
    # 1918 x 3 bytes are not 16-byte aligned), and the other layouts
    color_cases["crop"] = (planes, cgeo[:4] + (g.height - 2, g.width - 2))
    other = []
    for name, (cplanes, ccgeo) in color_cases.items():
        got = CK.upsample_color(cplanes, *ccgeo)
        check(torch.equal(got, CK.upsample_color_plain(cplanes, *ccgeo)),
              f"color kernel differs from its plain version at {name}")
        cms = cuda_ms(lambda: CK.upsample_color(cplanes, *ccgeo), args.reps)
        other.append(f"{name} {ccgeo[5]}x{ccgeo[4]} {cms:.4f} ms")
    del color_cases, got
    print(f"[parity] color kernel: equal on {rgb.shape[0]} {g.width}x"
          f"{g.height} images and at {', '.join(other)}", flush=True)
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
    del units, pix, planes, rgb, dec, dev, meta, entries, res
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
    # the plain path on the card, per batch and schedule: what every path
    # must equal (sequential is one cold round, so it is held to 1 and to
    # the jacobi plain path's coefficients)
    plain = {}
    for gray, sync in ((False, "jacobi"), (False, "faithful"),
                       (False, "specmap"), (True, "jacobi")):
        plain[gray, sync] = decode_batch(
            batches[gray], chunk_bits=args.chunk_bits, sync=sync,
            backend="torch", device=gpu, emit="rgb" if sync == "jacobi"
            else "coeffs")
        check(plain[gray, sync].converged,
              f"the plain path ({sync}) did not converge")
    plain_rgb = {gray: plain[gray, "jacobi"].rgb for gray in batches}
    api.clear_decode_programs()
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
        ref = plain.get((gray, sync), plain[gray, "jacobi"])
        ref_rounds = 1 if sync == "sequential" else ref.sync_rounds
        check(out.converged, f"{label}: did not converge")
        check(out.sync_rounds == ref_rounds, f"{label}: sync_rounds "
              f"{out.sync_rounds} != the plain path's {ref_rounds}")
        check(torch.equal(out.coeffs, ref.coeffs),
              f"{label}: coefficients differ from the plain path")
        shape = (len(blobs), args.height, args.width) + (() if gray else (3,))
        check(tuple(out.rgb.shape) == shape,
              f"{label}: rgb shape {tuple(out.rgb.shape)}")
        d = (out.rgb.to(torch.int16) - plain_rgb[gray].to(torch.int16)).abs()
        check(int(d.max()) <= 1, f"{label}: RGB differs from the plain path "
              f"by {int(d.max())}")
        sync_stats[label] = (out.sync_rounds, checks)
        print(f"[main] {label}: coefficients equal the plain path; "
              f"{out.sync_rounds} sync rounds (plain {sync} {ref_rounds}), "
              f"{checks} host checks cold; RGB max diff {int(d.max())} "
              f"({int((d == 1).sum())} samples off by one)", flush=True)
        del out, d
    check(all(r["launches"] > 0 for r in kernels), "a kernel of the main "
          "path was never launched")
    plain_coeffs = plain[False, "jacobi"].coeffs
    del plain
    torch.cuda.empty_cache()

    planned_ms, warm_checks = {}, {}
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
        stats = dec.launch_stats()
        warm = warm_checks[label] = stats["host_checks"]
        del dec
        med = planned_ms[label] = statistics.median(device_ms[1:])
        mbx = sum(map(len, batch)) / 1e6
        rounds, cold = sync_stats[label]
        parent = PARENT_HOST_CHECKS.get(sync) if not gray else None
        line = (f"[main] {label}: warm decode of a planned batch "
                f"{med:.2f} ms median ({len(batch) / med * 1e3:.1f} images/s, "
                f"{mbx / med * 1e3:.1f} MB/s compressed), {rounds} sync "
                f"rounds, host checks {cold} cold / {warm} warm (parent "
                f"{parent if parent is not None else 'not recorded'}), "
                f"{stats['graph_replays']} CUDA graphs of 2 rounds")
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
    check(warm_checks["jacobi/post"] <= 4, f"a warm jacobi decode made "
          f"{warm_checks['jacobi/post']} host checks")

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
    stats = api.decode_program_stats()
    print(f"[cache] after phase 4: {stats['programs']} programs, "
          f"{stats['allocations']} allocations, "
          f"{stats['device_bytes'] / 1e9:.2f} GB on the card", flush=True)
    api.clear_decode_programs()

    # -- 5. the program cache: batches of one bucket, each its own frames ----
    n_img = len(blobs)
    per_frame = plain_coeffs.shape[0] // n_img
    pick = np.random.default_rng(args.seed)
    draws = [pick.permutation(n_img)[:8] for _ in range(8)]
    for fuse in ("post", "full"):
        decs = [ParallelDecoder.from_bytes([blobs[j] for j in idx],
                                           chunk_bits=args.chunk_bits,
                                           fuse=fuse) for idx in draws]
        warm_ms, checks = [], []
        for rep in range(2):
            for idx, dec in zip(draws, decs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = dec.decode()
                torch.cuda.synchronize()
                if rep:
                    warm_ms.append((time.perf_counter() - t0) * 1e3)
                    checks.append(dec.launch_stats()["host_checks"])
                exp = torch.cat([plain_coeffs[j * per_frame:
                                              (j + 1) * per_frame]
                                 for j in idx])
                check(torch.equal(out.coeffs, exp), f"phase 5 {fuse}: a "
                      f"batch's coefficients differ from its frames' plain "
                      f"decode")
                d = (out.rgb.to(torch.int16)
                     - plain_rgb[False][torch.as_tensor(idx, device=gpu)]
                     .to(torch.int16)).abs()
                check(int(d.max()) <= 1, f"phase 5 {fuse}: RGB differs "
                      f"from the plain path by {int(d.max())}")
                del out, exp, d
        progs = [p for p in api.decode_programs() if p.fuse == fuse]
        check(all(p.allocations == 1 for p in progs),
              f"phase 5 {fuse}: a program allocated more than once")
        check(sum(p.decodes for p in progs) == 2 * len(decs),
              f"phase 5 {fuse}: decodes went outside the cache")
        stats = api.decode_program_stats()
        print(f"[cache] jacobi/{fuse}: 8 batches of 8 frames in "
              f"{len(progs)} bucket(s), {sum(p.allocations for p in progs)} "
              f"allocation(s), {sum(p.uploads for p in progs)} uploads; each "
              f"batch equals its frames' plain decode; warm decode "
              f"{statistics.median(warm_ms):.2f} ms median (upload "
              f"included), host checks {min(checks)}-{max(checks)}; cache "
              f"{stats['device_bytes'] / 1e9:.3f} GB on the card",
              flush=True)
        del decs
    api.clear_decode_programs()

    # -- 6. the decode service -----------------------------------------------
    scan = distinct[0].index(b"\xff\xda")
    cut = distinct[0][:scan + (len(distinct[0]) - scan) // 2]
    flipped = bytearray(distinct[1 % len(distinct)])
    flipped[scan + (len(flipped) - scan) // 3] ^= 0x08
    dqt = bytearray(distinct[2 % len(distinct)])
    at = dqt.index(b"\xff\xdb")
    dqt[at + 2:at + 4] = (0).to_bytes(2, "big")
    junk = pick.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    damaged = [cut, bytes(flipped), bytes(dqt), junk]
    frame_of = {}
    requests = []
    for i, b in enumerate(distinct):
        requests += [b] * 8
        frame_of[b] = i
    requests += damaged
    order = pick.permutation(len(requests))
    requests = [requests[k] for k in order]
    cfg = ServiceConfig(batch_size=8, validate=True, fuse="post",
                        chunk_bits=args.chunk_bits, slo_ms=600_000.0,
                        max_form_ms=50.0, max_buckets=8)
    with DecodeService(cfg) as svc:
        svc.prewarm(distinct)
        svc.reset_stats()
        t0 = time.perf_counter()
        res = [f.result(timeout=600) for f in svc.submit_many(requests)]
        wall = time.perf_counter() - t0
        off, worst = 0, 0
        for b, r in zip(requests, res):
            if b in frame_of:
                check(r.status == 0, f"phase 6: a clean request got status "
                      f"{r.status}")
                ref = plain_rgb[False][frame_of[b] * args.repeat].cpu()
                d = (r.rgb.to(torch.int16) - ref.to(torch.int16)).abs()
                worst, off = max(worst, int(d.max())), off + int((d == 1)
                                                                  .sum())
            else:
                exp = validate_blob(b).status
                check(r.status == exp, f"phase 6: a damaged request got "
                      f"status {r.status}, validate_blob gives {exp}")
        check(worst <= 1, f"phase 6: RGB differs from the plain decode by "
              f"{worst}")
        names = ("cut scan", "flipped bit", "DQT length", "not a JPEG")
        print(f"[serve] {len(requests)} requests in {wall:.2f} s: "
              f"{len(requests) - len(damaged)} clean within {worst} of the "
              f"plain decode ({off} samples off by "
              f"one); damaged: " + ", ".join(
                  f"{n} status {validate_blob(b).status}"
                  for n, b in zip(names, damaged)), flush=True)
        rate = 0.0
        for _ in range(2):
            svc.reset_stats()
            load = run_open_loop(svc, distinct, n_requests=64,
                                 rate_ips=rate, seed=args.seed,
                                 timeout_s=600)
            st = svc.serve_stats()
            check(load["completed"] == 64 and not load["rejected"],
                  f"phase 6: {load['rejected']} rejected at "
                  f"{rate:.1f} images/s")
            print(f"[serve] offered {'all at once' if not rate else f'{rate:.1f} images/s'}: "
                  f"{load['ips']:.1f} images/s, p50 {load['p50_ms']:.1f} ms, "
                  f"p99 {load['p99_ms']:.1f} ms, occupancy "
                  f"{load['occupancy_mean']:.2f} of 8, {st['batches']} "
                  f"batches, device stage {st['warm_batch_ms']:.1f} ms a "
                  f"batch (decode and copy to the host), cache "
                  f"{st['programs']['programs']} programs "
                  f"{st['programs']['allocations']} allocations "
                  f"{st['programs']['device_bytes'] / 1e9:.3f} GB",
                  flush=True)
            rate = load["ips"] / 2
    api.clear_decode_programs()

    # -- 7. the VLM input pipeline over the dataset --------------------------
    # the 32 frames as a dataset (each distinct frame `repeat` times in a
    # row), through JpegVisionPipeline's defaults: 4 batches of 8, then one
    # batch of all 32; tokens from the RGB the decode made
    stream = Dataset(spec, blobs)
    pipe = JpegVisionPipeline(device=gpu, chunk_bits=args.chunk_bits,
                              sync_stats=True)
    embed = pipe.embed
    seen = []

    def seen_embed(rgb):
        """The pipeline's embedding, keeping the RGB it was given."""
        seen.append(rgb)
        return embed(rgb)

    pipe.embed = seen_embed
    p = pipe.patch
    n_patch = (args.height // p) * (args.width // p)
    api.clear_decode_programs()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    offs = worst = 0
    fresh_ms = []  # steps after the first: fresh batches in a warm bucket
    for k, (tokens, st) in enumerate(pipe.batches(stream, STREAM_BATCH)):
        rgb = seen.pop()
        if k:
            fresh_ms.append(st.decode_ms)
        ref = plain_rgb[False][STREAM_BATCH * k: STREAM_BATCH * (k + 1)]
        d = (rgb.to(torch.int16) - ref.to(torch.int16)).abs()
        worst, offs = max(worst, int(d.max())), offs + int((d == 1).sum())
        check(tuple(tokens.shape) == (len(ref), n_patch, pipe.embed_dim)
              and tokens.dtype == torch.bfloat16,
              f"phase 7: tokens of shape {tuple(tokens.shape)}")
        # rows of one product depend only on their own patch vectors, so
        # an image whose RGB equals the plain one has the plain tokens
        exp = embed(ref)
        same = [i for i in range(len(ref)) if torch.equal(rgb[i], ref[i])]
        check(all(torch.equal(tokens[i], exp[i]) for i in same),
              "phase 7: tokens differ from the embedding of the plain RGB")
        del tokens, rgb, exp, d
    torch.cuda.synchronize()
    counts = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    for rec in kernels:
        rec["launches"] += counts[rec["name"]]
    launched = {k for k, n in counts.items() if n > 0}
    check(launched == {exits, streams, "fused_pixels"}, f"phase 7: the "
          f"pipeline launched {sorted(launched)}")
    check(worst <= 1, f"phase 7: RGB differs from the plain path by {worst}")
    stats = pipe.decode_stats()
    progs = api.decode_programs()
    check(stats["batches"] == -(-len(blobs) // STREAM_BATCH)
          and all(q.allocations == 1 for q in progs)
          and stats["compile_count"] == len(progs),
          f"phase 7: {stats['compile_count']} allocations over "
          f"{len(progs)} bucket(s)")
    fresh = (f"; a fresh batch in the warm bucket (host parse and plan "
             f"included) {statistics.median(fresh_ms):.1f} ms median "
             f"({STREAM_BATCH / statistics.median(fresh_ms) * 1e3:.1f} "
             f"images/s)" if fresh_ms else "")
    print(f"[pipeline] {stats['batches']} batches of {STREAM_BATCH}: "
          f"launches " + ", ".join(
        f"{k} {n}" for k, n in counts.items() if n) + f"; RGB within "
          f"{worst} of the plain path ({offs} samples off by one), tokens "
          f"equal the plain RGB's embedding; {len(progs)} bucket(s), "
          f"{stats['compile_count']} allocation(s){fresh}", flush=True)
    # the patch vectors on the card equal the CPU's (bf16 division)
    eye = torch.eye(p * p * 3)
    cpu_pipe = JpegVisionPipeline(device="cpu", embed_dim=p * p * 3)
    cpu_pipe.load_embed(eye)
    card_pipe = JpegVisionPipeline(device=gpu, embed_dim=p * p * 3)
    card_pipe.load_embed(eye)
    sample = plain_rgb[False][:2]
    check(torch.equal(card_pipe.embed(sample).cpu(),
                      cpu_pipe.embed(sample.cpu())),
          "phase 7: patch vectors on the card differ from the CPU's")
    print("[pipeline] patch vectors (bf16 division by 255) on the card "
          "equal the CPU's", flush=True)
    del cpu_pipe, card_pipe, sample, eye
    # one batch of all 32, then warm repeats
    step_ms = []
    for rep in range(args.reps + 1):
        tokens, st = pipe.patches_for(blobs)
        rgb = seen.pop()
        if rep == 0:
            d = (rgb.to(torch.int16) - plain_rgb[False].to(torch.int16)).abs()
            check(int(d.max()) <= 1 and st.compiled == (
                len(blobs) > STREAM_BATCH), f"phase 7: the batch of "
                f"{len(blobs)} differs from the plain path or allocated "
                f"against its bucket")
            exp = embed(plain_rgb[False])
            same = [i for i in range(len(blobs))
                    if torch.equal(rgb[i], plain_rgb[False][i])]
            check(all(torch.equal(tokens[i], exp[i]) for i in same),
                  "phase 7: tokens of 32 differ from the plain embedding")
            del d, exp
        else:
            step_ms.append(st.decode_ms)
        del tokens, rgb
    med = statistics.median(step_ms)
    dec32 = pipe._decoder(blobs)
    rgb32 = dec32.decode().rgb
    torch.cuda.synchronize()

    def busy_ms(fn, top=0):
        """Device busy ms of one call of ``fn`` from the profiler's kernel
        rows (None when it saw no device time), printing the ``top``
        largest rows."""
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = sorted(((device_us(e) / 1e3, e.count, e.key)
                       for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA),
                      reverse=True)
        for ms, n, key in rows[:top]:
            print(f"[pipeline]   {ms:9.3f} ms {n:5d}x  {key[:100]}")
        total = sum(r[0] for r in rows)
        return total if total else None

    both = busy_ms(lambda: pipe.patches_for(blobs))
    seen.clear()
    dec_busy = busy_ms(lambda: dec32.decode())
    print("[pipeline] patchify + embed of the batch, by kernel:")
    emb_busy = busy_ms(lambda: embed(rgb32), top=6)
    emb_ms = cuda_ms(lambda: embed(rgb32), args.reps)
    key_ms = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        pipe._batch_key(blobs)
        key_ms.append((time.perf_counter() - t0) * 1e3)
    n_tok = len(blobs) * n_patch
    split = ("not measured" if None in (both, dec_busy, emb_busy) else
             f"device busy {both:.2f} ms of {med:.2f} ms wall (idle share "
             f"{max(0.0, 1 - both / med):.3f}): decode {dec_busy:.2f} ms, "
             f"patchify + embed {emb_busy:.2f} ms")
    print(f"[pipeline] batch of {len(blobs)} warm: {med:.2f} ms median "
          f"({len(blobs) / med * 1e3:.1f} images/s, "
          f"{n_tok / med * 1e3:.0f} tokens/s); {split}; patchify + embed "
          f"alone {emb_ms:.3f} ms by events; the handle's content key "
          f"(blake2b of {mb:.1f} MB) {statistics.median(key_ms):.1f} ms of "
          f"host time", flush=True)
    pinned = sum(nbytes(*d._host.values()) for d in pipe._decoders.values())
    print(f"[pipeline] decode_stats {json.dumps(pipe.decode_stats())}; "
          f"handle LRU {len(pipe._decoders)} handles, "
          f"{pinned / 1e6:.1f} MB pinned host memory", flush=True)
    del pipe, dec32, rgb32, seen
    api.clear_decode_programs()

    # -- 8. balanced lanes on the 32 frames ----------------------------------
    for fuse in ("post", "full"):
        ident = decode_batch(blobs, chunk_bits=args.chunk_bits, fuse=fuse)
        check(torch.equal(ident.coeffs, plain_coeffs),
              f"phase 8: the identity plan ({fuse}) differs")
        for balance in ("lpt", "roundrobin"):
            dec = ParallelDecoder.from_bytes(blobs,
                                             chunk_bits=args.chunk_bits,
                                             fuse=fuse, balance=balance,
                                             lanes=4)
            for fn, attr in counters.values():
                setattr(fn, attr, 0)
            outs = [dec.decode() for _ in range(2)]
            torch.cuda.synchronize()
            launched = {k for k, (fn, attr) in counters.items()
                        if getattr(fn, attr) > 0}
            want = {exits, streams if fuse == "post" else store,
                    "fused_pixels"}
            check(launched == want, f"phase 8: {balance}/{fuse} launched "
                  f"{sorted(launched)}")
            for out in outs:
                check(torch.equal(out.coeffs, ident.coeffs)
                      and torch.equal(out.rgb, ident.rgb)
                      and out.sync_rounds == ident.sync_rounds,
                      f"phase 8: {balance}/{fuse} differs from the "
                      f"identity plan")
            loads = DP.plan_lane_loads(dec.plan, 4)
            print(f"[balance] {balance}/{fuse}: coefficients and RGB equal "
                  f"the identity plan's (eager, then "
                  f"{dec.launch_stats()['graph_replays']} graph replays); "
                  f"{dec.plan.n_chunks} lanes in 4 blocks, real chunks per "
                  f"block {loads.tolist()} (identity "
                  f"{DP.lane_loads(ident.plan, 4, 'none').tolist()})",
                  flush=True)
            del dec, outs
        del ident
        api.clear_decode_programs()

    # -- 8b. the decode over a mesh -----------------------------------------
    mesh_decodes(args, blobs, gpu, counters, kernels)

    # -- 9. two processes on the card ----------------------------------------
    run_processes(args, blobs, plain_coeffs, plain_rgb[False])
    api.clear_decode_programs()

    # -- 10. the kernel verifier ------------------------------------------------
    kernels += verify_kernels(args, blobs, layouts, gpu)
    api.clear_decode_programs()

    # -- 10b. the traced-program checker ------------------------------------------
    check_traces(blobs, gpu)
    api.clear_decode_programs()

    # -- 11. the launch autotuner -----------------------------------------------
    tune_launch(args, blobs, gpu)
    api.clear_decode_programs()

    # -- 12. LM/VLM serving -------------------------------------------------------
    serve_lm(args, gpu, card, counters, kernels)
    api.clear_decode_programs()

    # -- 13. MoE, MLA, SSD and encoder-decoder serving ----------------------------
    serve_families(args, gpu, card)

    # -- 14. training --------------------------------------------------------------
    vlm_step = train_families(args, gpu, card, counters, kernels)

    # -- 15. serving across ranks ---------------------------------------------
    serve_across_ranks(args, gpu)

    # -- 16. training across ranks ---------------------------------------------
    train_across_ranks(args, gpu)

    # -- 17. the dry run against phase 14c's measured step ------------------------
    dry_run_step(card, vlm_step)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
