"""Training across the cards of one host, measured (ROADMAP A15c).

Run from the root of a checkout on a machine with four cards::

    PYTHONPATH=src python3 -m repro_torch.tools.tp_train \\
        --out tp_train.json [--quick] [--only a,b]

Each run starts its ranks, one process a card, through
``launch.mesh.run_ranks`` (torchrun's environment; NCCL):

* ``nemotron-m4``: nemotron-4-15b whole (15.6 B parameters) over
  ``model=4``, bf16 weights drawn from seed 0 on each card
  (``init_sharded``), AdamW with bf16 moments, lr 1e-4, a constant
  schedule, remat ``full``; a global batch of 4 sequences of 4,096
  positions (``SyntheticTokens``); steps 1-3 on fresh batches, step 4 on
  step 3's batch again, whose loss must fall. No card holds this model's
  training state alone (about 125 GB).
* ``llava-d2m2``: llava-next-mistral-7b over ``(data, model)`` = ``(2,
  2)``, each data rank decoding 2 of its own 1920x384 q95 frames a step
  on its card (``JpegVisionPipeline``: B1, B2, B4 launched on every rank)
  into 2,880 patch tokens each, with 64 text tokens a request; otherwise
  as ``nemotron-m4``.
* ``nemo1f-m4``, ``nemo1f-d2m2``, ``dsv2-2f-d2m2``: the split's agreement
  at published widths in f32 (TF32 off): nemotron-4-15b with one layer
  over ``model=4`` and ``(2, 2)``, deepseek-v2-236b with two (its dense
  prefix layer and one MoE layer) over ``(2, 2)``; a global batch of 2 x
  128 positions. Each rank first runs the whole model on its own card
  (the one-card reference: its loss, every gradient, its MoE routing),
  then its slice; the loss, every gradient (after the step's exchange)
  and each MoE layer call's routing and ``dropped_frac`` are held against
  the one card's. ``dsv2-2f-d2m2-drop`` repeats deepseek-v2's at 2 x
  1,024 positions with capacity factor 0.5, so that experts overflow.
* ``llama4f-p4``: ``make_pipelined_forward`` over 4 stages, llama3-8b
  with 4 layers in f32, 8 rows of 256 positions in 4 microbatches, its
  logits held against the whole model's forward of each microbatch on
  one card (and compared with its forward of the whole batch), then its
  backward of ``sum(logits * ct)`` (``ct`` drawn from seed 0): every
  gradient held against the one card's backward of the same
  microbatches (``microbatch_logits``; compared with its backward of the
  whole batch), the embedding, head and final norm bit-identical on
  every stage.
* ``nemotron-p4``, ``jamba-p4``: nemotron-4-15b and jamba-v0.1-52b whole
  over 4 pipeline stages (8 periods, and one period of 8 layers, a
  stage), bf16 weights drawn from seed 0 (each stage draws its own
  stage's model: the same draw on every stage), ``remat="full"``, 4 rows
  of 4,096 positions (halved while the reckoning says so) in 4
  microbatches (``SyntheticTokens``), forward and backward of the
  ``_lm_loss`` form of the logits (f32 logsumexp and gold) on every
  stage, with no optimizer. No two cards hold jamba's weights and
  gradients. ``nemotron-m4-2k`` is ``nemotron-m4`` at the positions the
  pipeline's reckoning leaves it, for the two splits side by side.

Before a training run each rank reckons its memory from the shapes on
the ``meta`` device (``reckon``); a batch that would go over
``MEMORY_LIMIT_GB`` a card is halved until it does not, and the run says
so; a pipeline run reckons its stage the same way (``reckon_stage``)
and halves its positions. A training run reports per rank: the memory
reckoned and the peak, each step's wall ms and its split by CUDA events
(forward + backward, the gradient exchange, the optimizer), the profiled
warm step's device busy time, its NCCL share and the idle share against
the warm step's wall, positions/s, and the bound (the step's bf16 products over 989
TFLOP/s and its f32 attention over 67 TFLOP/s, a card). A pipeline run
reports per stage: the memory reckoned and the peak, the warm forward
and backward wall ms by CUDA events, the profiled warm pass's busy,
NCCL and idle shares (GPipe's fill and drain leave a stage idle 3 of 7
ticks), positions/s, and the bound (the stage's bf16 products, the head
on every stage, over 989 TFLOP/s and its f32 attention over 67
TFLOP/s). ``--quick`` cuts the layers and positions (a check of the
path, not a measurement).
Every number names the cards and their power limits (``nvidia-smi``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..launch.mesh import run_ranks
from .mesh_decode import card_lines, union_ms

BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12
MEMORY_LIMIT_GB = 72.0
LR = 1e-4
STEPS = 4            # steps 1-3 fresh batches, step 4 step 3's again
VLM_FRAME = (1920, 384)
VLM_TEXT = 64
# the split's agreement in f32 (TF32 off) against one card: the loss, and
# each gradient within 1e-3 of its leaf's largest |value| (the limit
# against repro) and normwise within AGREE_NORM. A first run on four H100
# 80GB HBM3 (700 W) measured nemotron's one layer at 1.4e-4-4.0e-4
# normwise (its embedding's gradient the worst: it sums every position's)
# and deepseek-v2's two layers at 1.5e-5; random weights at published
# widths make attention near one-hot (PERF.md section 6), which the
# split's other order of sums perturbs
AGREE_LOSS_RTOL = 1e-5
AGREE_NORM = 1e-3
AGREE_GRAD = 1e-3
# the pipeline's logits against the whole model's forward of each
# microbatch on one card (the same products on the same shapes): within
# this share of the largest |logit| (the stack's output is not normed, as
# the JAX pipeline computes it). Against the forward of the whole batch
# at once they differ more: cuBLAS picks other kernels for other row
# counts, and near one-hot attention turns a last-bit difference into
# another key (reported, not held)
PIPE_TOL = 1e-5
# the pipeline's gradients against the one card's backward of the same
# microbatches in the pipeline's order of sums (microbatch_logits): each
# leaf within this share of its largest |value|. A first run on four H100
# 80GB HBM3 (700 W) against each microbatch's backward summed first to
# last measured 8.7e-6-1.17e-5 (the periods' sums in the other order; the
# largest logit near 1,500 at these random weights)
PIPE_GRAD_TOL = 1e-5
PIPE_MICRO = 4


@dataclasses.dataclass(frozen=True)
class Run:
    name: str
    kind: str                   # "train", "agree", "pipe", "pipe_train"
    arch: str
    mesh: tuple                 # (data, model); (1, stages) for "pipe"
    n_periods: Optional[int] = None   # None: the whole model
    batch: int = 4
    seq: int = 4096
    moe: tuple = ()             # MoE config fields replaced


RUNS = (
    Run("nemo1f-m4", "agree", "nemotron-4-15b", (1, 4), 1, 2, 128),
    Run("nemo1f-d2m2", "agree", "nemotron-4-15b", (2, 2), 1, 2, 128),
    Run("dsv2-2f-d2m2", "agree", "deepseek-v2-236b", (2, 2), 1, 2, 128),
    # an expert takes at least 32 slots: 2 x 128 tokens of 6 of 160
    # experts fill none (9.6 slots an expert on average), so capacity over
    # the data group is held with drops at 2 x 1,024 and capacity 0.5
    Run("dsv2-2f-d2m2-drop", "agree", "deepseek-v2-236b", (2, 2), 1, 2,
        1024, (("capacity_factor", 0.5),)),
    Run("llama4f-p4", "pipe", "llama3-8b", (1, 4), 4, 8, 256),
    Run("nemotron-p4", "pipe_train", "nemotron-4-15b", (1, 4), None, 4,
        4096),
    # model=4 on the batch the pipeline's reckoning leaves it (4 x 2,048)
    Run("nemotron-m4-2k", "train", "nemotron-4-15b", (1, 4), None, 4, 2048),
    Run("jamba-p4", "pipe_train", "jamba-v0.1-52b", (1, 4), None, 4, 4096),
    Run("nemotron-m4", "train", "nemotron-4-15b", (1, 4), None, 4, 4096),
    Run("llava-d2m2", "train", "llava-next-mistral-7b", (2, 2), None, 4),
)
# --quick: two periods (one for the agreement runs), 256 positions
QUICK_PERIODS, QUICK_SEQ = 2, 256


def _config(spec: dict, dtype: str):
    from ..configs import get_config
    cfg = dataclasses.replace(get_config(spec["arch"]), dtype=dtype,
                              param_dtype=dtype)
    if spec["n_periods"]:
        cfg = dataclasses.replace(cfg, n_periods=spec["n_periods"])
    if spec["moe"]:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, **dict(spec["moe"])))
    return cfg


def _mesh(spec: dict):
    from ..launch.mesh import init_process_mesh
    data, model = spec["mesh"]
    return init_process_mesh(data, model, "nccl", "cuda", timeout_s=900)


def _seq_len(cfg, spec: dict) -> int:
    """Positions a sequence: the VLM's patches and its text."""
    return cfg.n_patches + VLM_TEXT if cfg.frontend == "vision" \
        else spec["seq"]


def reckon(cfg, layout, batch: int, seq: int, moment_bytes: int) -> Dict:
    """Bytes one rank holds at a train step's peak, reckoned from its
    shapes on the ``meta`` device (``chip_smoke.train_memory`` a rank):
    its parameters, gradients and moments, the block inputs remat keeps
    for its rows, one layer's recompute (three f32 score blocks a pair of
    query and key chunks, over its heads) and its f32 logits over its
    vocabulary with the loss and its gradient."""
    from ..models.model import abstract_params
    model = abstract_params(cfg, layout=layout)
    numel = sum(p.numel() for p in model.parameters())
    n = sum(p.numel() * p.element_size() for p in model.parameters())
    rows = layout.rows(batch)
    b = rows.stop - rows.start
    heads = layout.local("heads", cfg.n_heads)
    vocab = layout.local("vocab", cfg.vocab)
    qc, kc = cfg.attn_chunk // 2, cfg.attn_chunk
    pairs = -(-seq // qc) * -(-seq // kc)
    block = b * qc * (heads.stop - heads.start) * kc * 4
    return {"parameters": n, "gradients": n,
            "moments": 2 * moment_bytes * numel,
            "block inputs": cfg.n_layers * b * seq * cfg.d_model * 2,
            "one layer's recompute": 3 * block * pairs,
            "logits": 3 * b * seq * (vocab.stop - vocab.start) * 4}


def step_flops(model, cfg, layout, batch: int, seq: int):
    """(bf16, f32) FLOP of one rank's train step: its blocks' products 2 x
    parameters a position forward, again for the remat forward and 4 x
    backward (8 x); its head's and the projector's 6 x; the attention's
    f32 scores and values over every pair of query and key chunks, padded,
    of its heads (forward, recompute and backward, 2 x)."""
    rows = layout.rows(batch)
    b = rows.stop - rows.start
    blk = sum(p.numel() for p in model.blocks.parameters())
    head = (model.embed if cfg.tie_embeddings else model.lm_head).numel()
    t = b * seq
    bf16 = 8 * blk * t + 6 * head * t
    if model.vis_proj1 is not None:
        bf16 += 6 * (model.vis_proj1.numel() + model.vis_proj2.numel()) \
            * b * cfg.n_patches
    heads = layout.local("heads", cfg.n_heads)
    qc, kc = cfg.attn_chunk // 2, cfg.attn_chunk
    sq, sk = -(-seq // qc) * qc, -(-seq // kc) * kc
    f32 = 4 * (2 * 2 * b * sq * (heads.stop - heads.start) * sk
               * cfg.head_dim) * cfg.n_layers
    return bf16, f32


def period_saved_bytes(scfg, rows: int, seq: int) -> int:
    """Bytes autograd saves for one period of ``scfg`` over ``rows`` x
    ``seq`` positions (what remat's recompute holds in a microbatch's
    backward), counted by running the period on the ``meta`` device: each
    saved tensor that is not a parameter or a view of one, a
    data-dependent shape (``nonzero``'s) taken at its largest."""
    import torch.fx.experimental._config as fx_config
    from ..models.model import _run_stack, abstract_params, torch_dtype
    model = abstract_params(dataclasses.replace(scfg, n_periods=1,
                                                remat="none"))
    model.requires_grad_(True)
    params = {id(p) for p in model.parameters()}
    saved = {}

    def pack(t):
        if id(t if t._base is None else t._base) not in params:
            saved[id(t)] = t.numel() * t.element_size()
        return t

    x = torch.empty((rows, seq, scfg.d_model), device="meta",
                    dtype=torch_dtype(scfg.dtype), requires_grad=True)
    pos = torch.arange(seq, device="meta")[None].expand(rows, seq)
    was = fx_config.meta_nonzero_assume_all_nonzero
    fx_config.meta_nonzero_assume_all_nonzero = True
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            _run_stack(model, x, pos)
    finally:
        fx_config.meta_nonzero_assume_all_nonzero = was
    return sum(saved.values())


def reckon_stage(cfg, n_stages: int, batch: int, seq: int) -> Dict:
    """Bytes one stage holds at the peak of a pipelined forward and
    backward, reckoned from its shapes on the ``meta`` device: its
    parameters and gradients, the inputs remat keeps (each microbatch's
    at each period, and each tick's received tensor), one period's
    recompute for a microbatch (:func:`period_saved_bytes`), the batch's
    outputs, and the whole batch's logits on every stage (bf16, then f32
    with the loss's gradient and one f32 temporary)."""
    from ..models.model import abstract_params
    from ..train.step import stage_config
    scfg = stage_config(cfg, n_stages)
    n = sum(p.numel() * p.element_size()
            for p in abstract_params(scfg).parameters())
    act = batch * seq * cfg.d_model * 2
    ticks = PIPE_MICRO + n_stages - 1
    return {"parameters": n, "gradients": n,
            "block inputs": scfg.n_periods * act
            + ticks * act // PIPE_MICRO,
            "one period's recompute": period_saved_bytes(
                scfg, batch // PIPE_MICRO, seq),
            "outputs": act,
            "logits": batch * seq * cfg.vocab * (2 + 3 * 4)}


def stage_flops(stage, scfg, batch: int, seq: int):
    """(bf16, f32) FLOP of one stage's pipelined forward and backward: its
    blocks' products 2 x parameters a position forward, again for the
    remat forward and 4 x backward (8 x; of an expert's, the share
    ``top_k / n_experts`` a position reaches); the head's 6 x, on every
    stage (the reference computes the logits on each); the attention's
    f32 scores and values over every pair of query and key chunks,
    padded, of its attention layers (forward, recompute and backward)."""
    moe = scfg.moe.top_k / scfg.moe.n_experts if scfg.moe else 1.0
    blk = sum(p.numel() * (moe if p.dim() == 3 and ".ffn.w_" in n else 1)
              for n, p in stage.blocks.named_parameters())
    head = (stage.embed if scfg.tie_embeddings else stage.lm_head).numel()
    t = batch * seq
    qc, kc = scfg.attn_chunk // 2, scfg.attn_chunk
    sq, sk = -(-seq // qc) * qc, -(-seq // kc) * kc
    n_attn = sum(m == "attn" for m, _ in scfg.layer_specs)
    f32 = 4 * (2 * 2 * batch * sq * scfg.n_heads * sk * scfg.head_dim) \
        * n_attn
    return 8 * blk * t + 6 * head * t, f32


class _Marks:
    """While installed, CUDA events around the train step's gradient
    exchange and optimizer (``train.step``'s globals), and of the first
    step's exchanged gradients this rank's norm and its largest leaves
    (the f32 sum of squares that AdamW's global norm takes can
    overflow)."""

    def __init__(self):
        from ..train import step as TS
        self.ts, self.marks, self.grads = TS, {}, None

    def _wrap(self, name):
        fn = getattr(self.ts, name)

        def timed(*a, **k):
            e0, e1 = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            e0.record()
            out = fn(*a, **k)
            e1.record()
            self.marks[name] = (e0, e1)
            if name == "exchange_grads" and self.grads is None:
                self.grads = _grad_sizes(a[0])
            return out
        return fn, timed

    def __enter__(self):
        self.saved = {}
        for name in ("exchange_grads", "adamw_update"):
            self.saved[name], timed = self._wrap(name)
            setattr(self.ts, name, timed)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.ts, name, fn)


def _grad_sizes(grads) -> Dict:
    """This rank's gradients: their norm (each leaf's largest |value| times
    the f32 norm of the leaf over it, so that no square overflows; joined
    on the host), whether all are finite, and the four leaves of largest
    norm with their largest |value|."""
    tops = {k: float(g.abs().max()) for k, g in grads.items()}
    norms = {k: t * float(torch.linalg.vector_norm(grads[k].float() / t))
             if t else 0.0 for k, t in tops.items()}
    top = sorted(norms, key=norms.get, reverse=True)[:4]
    return {"norm": sum(n * n for n in norms.values()) ** 0.5,
            "finite": all(bool(torch.isfinite(g).all())
                          for g in grads.values()),
            "top": [(k, norms[k], tops[k]) for k in top]}


def _profile(fn, dev):
    """(busy ms, NCCL ms, wall ms) of one call of ``fn`` under the
    profiler."""
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        wall = (time.perf_counter() - t0) * 1e3

    def union(pick):
        return union_ms([(e.time_range.start, e.time_range.end)
                         for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA
                         and pick(e.name)])
    return union(lambda n: True), union(lambda n: "nccl" in n.lower()), wall


def _kernel_counters():
    from ..kernels.fused import pixels as FP
    from ..kernels.huffman import ops as HK
    return {"huffman_exits": (HK.decode_exits, "launches"),
            "huffman_streams": (HK.decode_streams, "launches"),
            "fused_pixels": (FP.fused_pixels, "launches")}


def train_worker(spec: dict, out: Path) -> None:
    """One rank of a training run."""
    from ..data.tokens import SyntheticTokens
    from ..launch.mesh import shutdown_process_mesh
    from ..models.model import init_sharded
    from ..train import step as TS
    from ..train.optimizer import AdamWConfig, init_opt_state

    cfg = _config(spec, "bfloat16")
    pm = _mesh(spec)
    dev = pm.device
    try:
        seq = _seq_len(cfg, spec)
        batch = spec["batch"]
        notes = []
        while True:
            layout = pm.layout(cfg, batch, "train")
            mem = reckon(cfg, layout, batch, seq, moment_bytes=2)
            if sum(mem.values()) / 1e9 <= MEMORY_LIMIT_GB or batch <= \
                    pm.data:
                break
            notes.append(f"batch {batch} reckoned at "
                         f"{sum(mem.values()) / 1e9:.1f} GB a card: halved")
            batch //= 2
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        model = init_sharded(torch.Generator(device=dev).manual_seed(0), cfg,
                             layout, dev)
        torch.cuda.synchronize(dev)
        init_s = time.perf_counter() - t0
        opt = AdamWConfig(lr=LR, moment_dtype="bfloat16")
        params = dict(model.named_parameters())
        state = init_opt_state(params, opt)
        step_fn = TS.make_train_step(cfg, opt, schedule="constant")
        rows = TS.train_rows(layout, batch)
        texts = SyntheticTokens(cfg.vocab, seq if cfg.frontend != "vision"
                                else VLM_TEXT, batch, seed=0)
        pipe = blobs = counters = None
        if cfg.frontend == "vision":
            from ..data.jpeg_pipeline import JpegVisionPipeline
            from ..jpeg.encoder import DatasetSpec, build_dataset
            n = len(rows)
            w, h = VLM_FRAME
            # this data rank's own frames, drawn from its rank
            blobs = build_dataset(DatasetSpec(
                f"llava-train-d{layout.data_rank}", n * (STEPS - 1), w, h,
                95), seed=layout.data_rank).jpeg_bytes
            pipe = JpegVisionPipeline(patch=16, embed_dim=1024, device=dev)
            counters = _kernel_counters()

        def batch_of(j):
            b = {k: torch.from_numpy(v[rows]).to(dev)
                 for k, v in texts.batch_at(j).items()}
            dec = {}
            if pipe is not None:
                for fn, attr in counters.values():
                    setattr(fn, attr, 0)
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                n = len(rows)
                b["patches"], _ = pipe.patches_for(blobs[j * n:(j + 1) * n])
                torch.cuda.synchronize(dev)
                dec = {"decode_ms": (time.perf_counter() - t0) * 1e3,
                       "launches": {k: getattr(fn, attr) for k, (fn, attr)
                                    in counters.items()}}
            return b, dec

        steps = []
        with _Marks() as marks:
            for i in range(STEPS):
                j = min(i, STEPS - 2)
                b, dec = batch_of(j)
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                e0.record()
                _, state, m = step_fn(model, state, b)
                e1.record()
                torch.cuda.synchronize(dev)
                wall = (time.perf_counter() - t0) * 1e3
                x0, x1 = marks.marks["exchange_grads"]
                o0, o1 = marks.marks["adamw_update"]
                steps.append(dict(
                    dec, loss=float(m["loss"]),
                    grad_norm=float(m["grad_norm"]), wall_ms=wall,
                    forward_backward_ms=e0.elapsed_time(x0),
                    exchange_ms=x0.elapsed_time(x1),
                    optimizer_ms=o0.elapsed_time(o1),
                    step_ms=e0.elapsed_time(e1)))
                del b, m
            peak = torch.cuda.max_memory_allocated(dev) / 1e9
            b, _ = batch_of(STEPS - 2)
            busy, nccl, prof_wall = _profile(
                lambda: step_fn(model, state, b), dev)
        warm = steps[STEPS - 2]
        bf16, f32 = step_flops(model, cfg, layout, batch, seq)
        res = dict(
            rank=pm.rank, coords=list(pm.coords), device=str(dev),
            backend=pm.backend, layout=layout.report(), batch=batch,
            seq=seq, notes=notes, rows=rows.tolist(),
            params=sum(p.numel() for p in model.parameters()),
            reckoned_gb={k: v / 1e9 for k, v in mem.items()},
            reckoned_total_gb=sum(mem.values()) / 1e9, peak_gb=peak,
            init_s=init_s, steps=steps,
            loss_falls=steps[-1]["loss"] < steps[-2]["loss"],
            profile_busy_ms=busy, profile_wall_ms=prof_wall, nccl_ms=nccl,
            nccl_share=nccl / busy if busy else None,
            idle_share=max(0.0, 1 - busy / warm["wall_ms"]) if busy
            else None,
            positions_per_s=batch * seq / warm["wall_ms"] * 1e3,
            bound_ms=(bf16 / BF16_FLOP_PER_S + f32 / F32_FLOP_PER_S) * 1e3,
            bf16_tflop=bf16 / 1e12, f32_tflop=f32 / 1e12,
            first_grads=marks.grads)
        (out / f"{spec['name']}-rank{pm.rank}.json").write_text(
            json.dumps(res))
    finally:
        shutdown_process_mesh(pm)


def _loss_and_grads(model, batch):
    from ..models import model as TM
    model.requires_grad_(True)
    model.zero_grad(set_to_none=True)
    loss, metrics = TM.forward_train(model, batch)
    loss.backward()
    grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
             for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(metrics["loss"]), grads


class _Routing:
    """While installed, each MoE layer call's experts and
    ``dropped_frac``."""

    def __enter__(self):
        from ..models import model as TM
        self.tm, self.moe, self.calls = TM, TM.moe_ffn, []

        def noted(*a, **k):
            y, aux = self.moe(*a, **k)
            self.calls.append((aux["idx"], float(aux["dropped_frac"])))
            return y, aux
        TM.moe_ffn = noted
        return self

    def __exit__(self, *exc):
        self.tm.moe_ffn = self.moe


def agree_worker(spec: dict, out: Path) -> None:
    """One rank of an agreement run: the whole model on this card, then
    this rank's slice, held against it."""
    from ..data.tokens import SyntheticTokens
    from ..dist.plan import grad_classes
    from ..launch.mesh import shutdown_process_mesh
    from ..models.model import init_params, init_sharded
    from ..train import step as TS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _config(spec, "float32")
    pm = _mesh(spec)
    dev = pm.device
    try:
        batch, seq = spec["batch"], spec["seq"]
        layout = pm.layout(cfg, batch, "train")
        rows = TS.train_rows(layout, batch)
        arrays = SyntheticTokens(cfg.vocab, seq, batch, seed=0).batch_at(0)
        arrays["labels"][0, :3] = -100
        whole_batch = {k: torch.from_numpy(v).to(dev)
                       for k, v in arrays.items()}
        t0 = time.perf_counter()
        whole = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                            device=dev)
        with _Routing() as routing:
            loss_w, grads = _loss_and_grads(whole, whole_batch)
        route_w = routing.calls
        model = init_sharded(torch.Generator(device=dev).manual_seed(0), cfg,
                             layout, dev)
        want = {}
        for k, g in grads.items():
            cut = model.cut_of(k)
            want[k] = (g if cut is None else cut.take(g)).clone()
        del whole, grads
        torch.cuda.empty_cache()
        whole_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        local = {k: torch.from_numpy(v[rows]).to(dev)
                 for k, v in arrays.items()}
        with _Routing() as routing:
            loss_s, got = _loss_and_grads(model, local)
        TS.exchange_grads(got, grad_classes(model), layout)
        torch.cuda.synchronize(dev)
        split_s = time.perf_counter() - t0
        worst_norm, worst_max = {}, {}
        for k, g in got.items():
            exp = want[k].float()
            den = float(torch.linalg.vector_norm(exp))
            worst_norm[k] = float(torch.linalg.vector_norm(g.float() - exp)
                                  ) / (den if den else 1.0)
            top = float(exp.abs().max())
            worst_max[k] = float((g.float() - exp).abs().max()) / (
                top if top else 1.0)
        n = len(rows)
        per = [idx.shape[0] // batch for idx, _ in route_w]
        same_route = all(
            torch.equal(gi, wi[rows[0] * p:(rows[0] + n) * p])
            for (gi, _), (wi, _), p in zip(routing.calls, route_w, per)) \
            and len(routing.calls) == len(route_w)
        drops = [(d, dw) for (_, d), (_, dw) in zip(routing.calls, route_w)]
        kn = max(worst_norm, key=worst_norm.get)
        km = max(worst_max, key=worst_max.get)
        res = dict(
            rank=pm.rank, coords=list(pm.coords), device=str(dev),
            layout=layout.report(), loss=loss_s, loss_one_card=loss_w,
            loss_rel=abs(loss_s - loss_w) / abs(loss_w),
            grad_normwise_max=worst_norm[kn], grad_normwise_leaf=kn,
            grad_max_rel=worst_max[km], grad_max_leaf=km,
            routing_equal=same_route,
            dropped_frac=[d for d, _ in drops],
            dropped_equal=all(abs(a - b) <= 1e-7 for a, b in drops),
            one_card_s=whole_s, split_s=split_s,
            peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
            ok=bool(abs(loss_s - loss_w) <= AGREE_LOSS_RTOL * abs(loss_w)
                    and worst_norm[kn] <= AGREE_NORM
                    and worst_max[km] <= AGREE_GRAD and same_route
                    and all(abs(a - b) <= 1e-7 for a, b in drops)))
        (out / f"{spec['name']}-rank{pm.rank}.json").write_text(
            json.dumps(res))
    finally:
        shutdown_process_mesh(pm)


def microbatch_logits(model, tokens, n_microbatches: int):
    """What ``make_pipelined_forward`` computes, by the whole ``model`` on
    one process and in the pipeline's order of sums: the batch embedded at
    once, each microbatch run through every period, the outputs' logits
    taken at once (under autograd each period's gradient then sums the
    microbatches last first, as the stages' backward does)."""
    from ..models import model as TM
    x = TM._embed_inputs(model, {"tokens": tokens})
    b, s, d = x.shape
    n = b // n_microbatches
    pos = torch.arange(s, device=x.device)[None].expand(n, s)
    outs = torch.stack([TM._run_stack(model, m, pos)[0]
                        for m in x.reshape(n_microbatches, n, s, d).unbind(0)])
    return TM._logits(model, outs.reshape(b, s, d))


def pipe_worker(spec: dict, out: Path) -> None:
    """One stage of the pipeline's agreement run: its forward, then its
    backward, against the whole model on this card."""
    from ..launch.mesh import shutdown_process_mesh
    from ..models import model as TM
    from ..train.step import make_pipelined_forward, stage_model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(_config(spec, "float32"), remat="none")
    pm = _mesh(spec)
    dev = pm.device
    try:
        n_stages = pm.model
        batch, seq = spec["batch"], spec["seq"]
        model = TM.init_params(torch.Generator(device=dev).manual_seed(0),
                               cfg, device=dev)
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab, (batch, seq)).astype(np.int32)).to(dev)
        micro = PIPE_MICRO

        def plain_of(rows):
            x = TM._embed_inputs(model, {"tokens": rows})
            h, _ = TM._run_stack(model, x, torch.arange(
                seq, device=dev)[None].expand(rows.shape[0], seq))
            return TM._logits(model, h)

        with torch.no_grad():
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            whole = plain_of(tokens)
            torch.cuda.synchronize(dev)
            plain_ms = (time.perf_counter() - t0) * 1e3
            plain = torch.cat([plain_of(t) for t in tokens.chunk(micro)])
        pipe = make_pipelined_forward(cfg, n_stages)
        stage = stage_model(model, n_stages, pm.rank)
        times = []
        for _ in range(2):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            logits = pipe(stage, {"tokens": tokens}, micro)
            torch.cuda.synchronize(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        top = float(plain.abs().max())
        gap = float((logits - plain).abs().max())
        norm = float(torch.linalg.vector_norm(logits - plain)
                     / torch.linalg.vector_norm(plain))
        whole_gap = float((logits - whole).abs().max())
        whole_norm = float(torch.linalg.vector_norm(logits - whole)
                           / torch.linalg.vector_norm(whole))
        del whole

        # the backward of sum(logits * ct): one card's of the microbatches
        # (microbatch_logits), and of the whole batch; then the pipeline's
        ct = torch.randn(plain.shape, generator=torch.Generator(
            device=dev).manual_seed(0), device=dev)
        del plain, logits
        model.requires_grad_(True)

        def grads_of(m):
            out = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                   for k, p in m.named_parameters()}
            m.zero_grad(set_to_none=True)
            return out

        (microbatch_logits(model, tokens, micro) * ct).sum().backward()
        want = grads_of(model)
        (plain_of(tokens) * ct).sum().backward()
        whole_batch = grads_of(model)
        model.requires_grad_(False)
        stage.requires_grad_(True)
        grad_ms = []
        for _ in range(2):
            stage.zero_grad(set_to_none=True)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            (pipe(stage, {"tokens": tokens}, micro) * ct).sum().backward()
            torch.cuda.synchronize(dev)
            grad_ms.append((time.perf_counter() - t0) * 1e3)
        per = len(stage.blocks)
        grad_gap, batch_norm = {}, {}
        for k, p in stage.named_parameters():
            name = k
            if k.startswith("blocks."):
                _, i, rest = k.split(".", 2)
                name = f"blocks.{int(i) + pm.rank * per}.{rest}"
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            exp, other = want[name], whole_batch[name]
            scale = float(exp.abs().max())
            grad_gap[k] = float((g - exp).abs().max()) / (scale or 1.0)
            den = float(torch.linalg.vector_norm(other))
            batch_norm[k] = float(torch.linalg.vector_norm(g - other)) / (
                den or 1.0)
        same = _whole_leaves_equal(stage)
        kg = max(grad_gap, key=grad_gap.get)
        kb = max(batch_norm, key=batch_norm.get)
        res = dict(rank=pm.rank, device=str(dev),
                   periods=len(stage.blocks), largest_logit=top,
                   max_abs=gap, max_rel=gap / top, normwise=norm,
                   whole_batch_max_rel=whole_gap / top,
                   whole_batch_normwise=whole_norm,
                   plain_ms=plain_ms, pipeline_cold_ms=times[0],
                   pipeline_ms=times[1], grad_max_rel=grad_gap[kg],
                   grad_max_leaf=kg, grad_bit_identical=all(
                       v == 0 for v in grad_gap.values()),
                   whole_batch_grad_normwise=batch_norm[kb],
                   whole_batch_grad_leaf=kb, whole_leaves_equal=same,
                   pipeline_grad_cold_ms=grad_ms[0],
                   pipeline_grad_ms=grad_ms[1],
                   ok=gap <= PIPE_TOL * top
                   and grad_gap[kg] <= PIPE_GRAD_TOL and same,
                   peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
        (out / f"{spec['name']}-rank{pm.rank}.json").write_text(
            json.dumps(res))
    finally:
        shutdown_process_mesh(pm)


def _whole_leaves_equal(stage) -> bool:
    """Whether this stage's gradients of the embedding, head and final
    norm are stage 0's, bit for bit (each broadcast from it; a NaN equal
    to the same NaN)."""
    import torch.distributed as dist
    same = True
    for name, p in stage.named_parameters():
        if name.startswith("blocks."):
            continue
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        ref = g.clone()
        dist.broadcast(ref, 0)
        same = same and torch.equal(ref.view(torch.uint8),
                                    g.contiguous().view(torch.uint8))
    return bool(same)


def _nonfinite(stage) -> Dict:
    """Of this stage's gradients: the count of elements that are not
    finite, the leaves holding them, and the largest finite |value| of
    each leaf in the stage's order (the embedding first, the periods by
    layer, the head last)."""
    out = {"count": 0, "leaves": [], "largest_finite": {}}
    for name, p in stage.named_parameters():
        if p.grad is None:
            continue
        bad = p.grad.numel() - int(torch.isfinite(p.grad).sum())
        if bad:
            out["count"] += bad
            out["leaves"].append(name)
        out["largest_finite"][name] = float(p.grad.abs().nan_to_num_(
            nan=0.0, posinf=0.0).max().float())
    return out


def _loss_of(logits, labels):
    """``models.model._lm_loss``'s form of the logits: the mean over the
    labels >= 0 of the f32 logsumexp less the gold logit."""
    lg = logits.float()
    mask = labels >= 0
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, torch.clamp_min(labels, 0).long()[..., None]
                        )[..., 0]
    return ((logz - gold) * mask).sum() / torch.clamp_min(mask.sum(), 1)


def pipe_train_worker(spec: dict, out: Path) -> None:
    """One stage of a pipelined forward and backward at full width."""
    from ..data.tokens import SyntheticTokens
    from ..launch.mesh import shutdown_process_mesh
    from ..models.model import init_params
    from ..train.step import make_pipelined_forward, stage_config

    cfg = dataclasses.replace(_config(spec, "bfloat16"), remat="full")
    pm = _mesh(spec)
    dev = pm.device
    try:
        n_stages = pm.model
        scfg = stage_config(cfg, n_stages)
        batch, seq = spec["batch"], spec["seq"]
        notes = []
        while True:
            mem = reckon_stage(cfg, n_stages, batch, seq)
            if sum(mem.values()) / 1e9 <= MEMORY_LIMIT_GB or seq <= 256:
                break
            notes.append(f"{seq} positions reckoned at "
                         f"{sum(mem.values()) / 1e9:.1f} GB a card: halved")
            seq //= 2
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        stage = init_params(torch.Generator(device=dev).manual_seed(0),
                            scfg, device=dev)
        stage.requires_grad_(True)
        torch.cuda.synchronize(dev)
        init_s = time.perf_counter() - t0
        arrays = SyntheticTokens(cfg.vocab, seq, batch, seed=0).batch_at(0)
        tokens = torch.from_numpy(arrays["tokens"]).to(dev)
        labels = torch.from_numpy(arrays["labels"]).to(dev)
        pipe = make_pipelined_forward(cfg, n_stages)
        marks = []

        def step():
            stage.zero_grad(set_to_none=True)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            loss = _loss_of(pipe(stage, {"tokens": tokens}, PIPE_MICRO),
                            labels)
            ev[1].record()
            loss.backward()
            ev[2].record()
            marks.append((loss.detach(), ev))

        passes = []
        for _ in range(3):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize(dev)
            wall = (time.perf_counter() - t0) * 1e3
            loss, ev = marks[-1]
            passes.append(dict(loss=float(loss), wall_ms=wall,
                               forward_ms=ev[0].elapsed_time(ev[1]),
                               backward_ms=ev[1].elapsed_time(ev[2])))
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        busy, nccl, prof_wall = _profile(step, dev)
        same = _whole_leaves_equal(stage)
        nonfinite = _nonfinite(stage)
        bf16, f32 = stage_flops(stage, scfg, batch, seq)
        warm = passes[-1]
        res = dict(
            rank=pm.rank, device=str(dev), backend=pm.backend,
            periods=scfg.n_periods, layers=len(stage.blocks), batch=batch,
            seq=seq, notes=notes,
            params=sum(p.numel() for p in stage.parameters()),
            reckoned_gb={k: v / 1e9 for k, v in mem.items()},
            reckoned_total_gb=sum(mem.values()) / 1e9, peak_gb=peak,
            init_s=init_s, passes=passes, whole_leaves_equal=same,
            grads_finite=not nonfinite["count"], nonfinite=nonfinite,
            profile_busy_ms=busy,
            profile_wall_ms=prof_wall, nccl_ms=nccl,
            busy_share=busy / prof_wall if busy else None,
            nccl_share=nccl / busy if busy else None,
            idle_share=max(0.0, 1 - busy / prof_wall) if busy else None,
            positions_per_s=batch * seq / warm["wall_ms"] * 1e3,
            bound_ms=(bf16 / BF16_FLOP_PER_S + f32 / F32_FLOP_PER_S) * 1e3,
            bf16_tflop=bf16 / 1e12, f32_tflop=f32 / 1e12)
        (out / f"{spec['name']}-rank{pm.rank}.json").write_text(
            json.dumps(res))
    finally:
        shutdown_process_mesh(pm)


WORKERS = {"train": train_worker, "agree": agree_worker, "pipe": pipe_worker,
           "pipe_train": pipe_train_worker}


def _ok(run: Run, ranks: List[Dict]) -> bool:
    if run.kind == "train":
        losses = {json.dumps([s["loss"] for s in r["steps"]])
                  for r in ranks}
        return all(r["loss_falls"] and all(np.isfinite(s["loss"])
                                           for s in r["steps"])
                   for r in ranks) and len(losses) == 1
    if run.kind == "pipe_train":
        losses = {json.dumps([p["loss"] for p in r["passes"]])
                  for r in ranks}
        return all(r["whole_leaves_equal"] and r["grads_finite"]
                   and all(np.isfinite(p["loss"]) for p in r["passes"])
                   for r in ranks) and len(losses) == 1
    return all(r["ok"] for r in ranks)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the results as JSON")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", default=None,
                    help="comma-separated run names (default: all)")
    ap.add_argument("--timeout", type=float, default=1200,
                    help="seconds a run's ranks may take")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        spec = json.loads(args.worker)
        WORKERS[spec["kind"]](spec, Path(args.dir))
        return 0
    if not torch.cuda.is_available():
        print("tp_train: no CUDA device", file=sys.stderr)
        return 2
    cards = card_lines()
    print("cards:", "; ".join(cards), flush=True)
    wanted = set(args.only.split(",")) if args.only else None
    result: Dict = {"cards": cards, "runs": {}}
    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        for run in RUNS:
            world = run.mesh[0] * run.mesh[1]
            if (wanted and run.name not in wanted) or world > len(cards):
                continue
            spec = dict(dataclasses.asdict(run), mesh=list(run.mesh))
            if args.quick:
                spec.update(n_periods=1 if run.kind == "agree"
                            else QUICK_PERIODS if run.kind == "train"
                            else run.mesh[1] if run.kind == "pipe_train"
                            else run.n_periods,
                            seq=min(run.seq, QUICK_SEQ))
            t0 = time.perf_counter()
            ranks = run_ranks(
                ["-m", "repro_torch.tools.tp_train", "--worker",
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
                row["ok"] = _ok(run, row["ranks"])
                if not row["ok"]:
                    failed.append(run.name)
            result["runs"][run.name] = row
            print(json.dumps(row), flush=True)
            if args.out:
                Path(args.out).parent.mkdir(parents=True, exist_ok=True)
                Path(args.out).write_text(json.dumps(result, indent=1))
    print(f"[tp] failed: {failed}" if failed else "[tp] every run held",
          flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
