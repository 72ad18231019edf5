"""The dry run: every (architecture x input shape x mesh) cell reckoned for
one card of the mesh, with no card.

The port of the JAX package's ``launch/dryrun.py``. That one lowers and
compiles each cell's step for a TPU pod on the host and reads XLA's
memory and cost analyses. Here each cell runs the port's own step (the
train step: forward, backward, gradient exchange and AdamW; the prefill
step; or a decode step at ``pos = seq - 1``) on the ``meta`` device,
which holds shapes and dtypes and no data, over a ``torch.distributed``
process group of the mesh's size whose backend ("fake") moves nothing
(:func:`fake_mesh`). No card is needed and no kernel is launched: that
is the module's purpose, as the JAX package's needs no TPU. This
process is rank 0 of the mesh and stands for it: the layout cuts every
split axis evenly, so every rank holds the same shapes and runs the same
products, but for a part held whole and run by one rank (the shared
experts of an MoE whose ``mlp`` the audit demotes), which rank 0 runs:
its counts bound the others'.

A :class:`StepCounter` (a ``TorchDispatchMode``) counts, op by op, as
the step runs:

* **FLOPs split by the product's dtype**: ``torch.utils.flop_counter``'s
  formulas (matrix products, convolutions, attention kernels), put under
  the dtype of the product's first operand: the bf16 products run at the
  tensor cores' rate, the f32 ones (the attention's score and value
  blocks, TF32 off) at the f32 rate. Elementwise work is not counted.
* **Bytes accessed**: eager PyTorch reads and writes HBM op by op, so
  each op that is not a view or a collective counts the bytes of each
  tensor it takes and each it returns; a gather (``embedding``,
  ``index``, ``index_select``, ``gather``) reads what it returns and its
  indices, not its whole table; a copy or fill writes its destination
  without reading it; an allocation alone (``empty``) accesses nothing.
* **Peak live bytes**: the storages live when the step starts
  (parameters, optimizer state, caches, inputs), plus each storage an op
  makes, less each as it is freed, each rounded up to the CUDA caching
  allocator's 512-byte blocks, so that the peak reads as
  ``torch.cuda.max_memory_allocated`` would. Not seen: a kernel's own
  workspace (cuBLAS's, a sort's), allocated below the dispatcher.
* **Collective bytes by group** (``dist.collectives.CollectiveCounter``):
  the model group and the data group, made with ``dist.new_group`` on
  the fake group.

On ``meta``, ``nonzero`` assumes every element is set (the MoE dispatch
keeps every slot); the capacity buffers' products do not depend on it.
A train cell runs one microbatch's forward and backward, counted
``microbatches`` times, then the gradient exchange and the optimizer
once: microbatches have equal shapes, so the counts are exact. The
later microbatches are not run (their peak is the first's, with the f32
gradient sums held as the step holds them): the first's gradients stand
in for theirs.

:func:`lower_cell` returns the JAX package's keys, so that one
``launch.report.render`` reads both files. Their meanings here:
``compile_s`` is the meta pass's seconds (nothing is compiled);
``flops``, ``hbm_bytes_accessed``, ``collective_bytes`` and
``collective_kinds`` are a card's, for the whole step, and the
``_model`` keys are the same numbers (eager code runs every layer, so
nothing is extrapolated: the JAX package's unrolled variants and its
affine fit have no counterpart); ``argument_bytes`` is what a card
holds as the step starts, ``output_bytes`` what the step made that
outlives it, ``temp_bytes`` the peak above the arguments,
``generated_code_bytes`` 0. ``per_card`` marks bytes as a card's (the
JAX package's report reads its bytes as the whole mesh's). The keys the
JAX package has not: ``flops_bf16``, ``flops_f32``, ``peak_bytes``,
``param_bytes``, ``opt_bytes``, ``cache_bytes``, ``input_bytes``,
``collective_groups``.

:func:`roofline` divides by :data:`launch.mesh.H100`'s datasheet peaks.
It deducts no score bytes, as the JAX package's does for its single-block
variants: the port writes its f32 score blocks to HBM. Each group's
collective bytes go over NVLink when the group lies within one node of 8
cards, over the network otherwise.

Usage (the CPU alone; no card)::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun
  PYTHONPATH=src python -m repro_torch.launch.report results/dryrun/dryrun.json
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref
from collections import defaultdict
from typing import Any, Dict, Iterator, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..configs import (ARCH_IDS, SHAPES, cell_is_applicable, get_config,
                       input_specs, shape_overrides)
from ..dist.collectives import CollectiveCounter, by_group, summarize
from ..models.config import ModelConfig
from ..models.model import (abstract_params, init_caches, init_sharded)
from ..serve.step import make_decode_step, make_prefill_step
from ..train.optimizer import (AdamWConfig, abstract_opt_state,
                               init_opt_state)
from .mesh import H100, MeshShape, ProcessMesh, make_production_mesh

# the CUDA caching allocator's block: every allocation is rounded up to it
ALLOC_BLOCK = 512

_aten = torch.ops.aten
# ops that read of their first input only what they return
_GATHERS = {_aten.embedding, _aten.index, _aten.index_select, _aten.gather}
# ops that write their first input without reading it
_WRITES = {_aten.copy_, _aten.fill_, _aten.zero_}
# ops that allocate and access nothing
_ALLOCS = {_aten.empty, _aten.empty_like, _aten.empty_strided,
           _aten.new_empty, _aten.new_empty_strided}


def opt_config_for(cfg: ModelConfig) -> AdamWConfig:
    # giant configs: bf16 moments, no master copy (the JAX package's)
    giant = cfg.param_count() > 60e9
    return AdamWConfig(moment_dtype="bfloat16" if giant else "float32",
                       master_weights=False)


def default_microbatches(arch: str, shape: str) -> int:
    if shape != "train_4k":
        return 1
    return {
        "deepseek-v3-671b": 8,
        "deepseek-v2-236b": 8,
        "command-r-plus-104b": 4,
        "jamba-v0.1-52b": 4,
    }.get(arch, 2)


# ---------------------------------------------------------------------------
# The counter
# ---------------------------------------------------------------------------

def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _block(n: int) -> int:
    return -(-n // ALLOC_BLOCK) * ALLOC_BLOCK


class StepCounter(CollectiveCounter):
    """While active, counts each op's FLOPs by dtype (``flops``), its
    bytes accessed (``bytes``), the live bytes and their peak (``live``,
    ``peak``) and, as :class:`~repro_torch.dist.collectives.
    CollectiveCounter`, its collectives (the module docstring). Storages
    made before it starts count as live once :meth:`adopt` is given
    them."""

    def __init__(self, groups: Optional[Dict[str, object]] = None):
        super().__init__(groups)
        self.flops: Dict[str, float] = defaultdict(float)
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.start = 0
        self._tracked: Dict[int, weakref.finalize] = {}

    def _track(self, st) -> None:
        key = id(st)
        if key in self._tracked:
            return
        n = _block(st.nbytes())
        self._tracked[key] = weakref.finalize(st, self._free, key, n)
        self.live += n
        self.peak = max(self.peak, self.live)

    def _free(self, key: int, n: int) -> None:
        self._tracked.pop(key, None)
        self.live -= n

    def adopt(self, tensors) -> None:
        """Count the storages of ``tensors`` (a tree) as live."""
        for t in tree_leaves(tensors):
            if isinstance(t, torch.Tensor):
                self._track(t.untyped_storage())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.record(func, args):
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if packet in flop_registry:
            a = next(t for t in tree_leaves(args)
                     if isinstance(t, torch.Tensor))
            name = {torch.bfloat16: "bf16", torch.float16: "bf16",
                    torch.float32: "f32"}.get(a.dtype, str(a.dtype))
            self.flops[name] += self.repeat * flop_registry[packet](
                *args, **kwargs, out_val=out)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not outs or func.is_view:
            return out
        if not any(r.alias_info for r in func._schema.returns):
            for t in outs:
                self._track(t.untyped_storage())
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        if packet in _ALLOCS or not func._schema.is_mutable and all(
                any(t.untyped_storage() is i.untyped_storage() for i in ins)
                for t in outs):
            # an allocation, or a view its schema does not call one
            # (``_unsafe_view``): nothing read or written
            return out
        n = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        if packet in _GATHERS:
            n += sum(_nbytes(t) for t in outs) - _nbytes(ins[0])
        elif packet in _WRITES:
            n -= _nbytes(ins[0])
        self.bytes += self.repeat * n
        return out


# ---------------------------------------------------------------------------
# A mesh of one process over a process group that moves nothing
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_mesh(data: int, model: int) -> Iterator[ProcessMesh]:
    """Rank 0 of a ``(data, model)`` :class:`~repro_torch.launch.mesh.
    ProcessMesh` on the ``meta`` device, over a "fake" process group of
    ``data * model`` ranks (``torch.testing``'s, whose collectives return
    at once) with its model and data groups; ``nonzero`` on ``meta``
    assumes every element is set. Both are undone on leaving. A mesh of
    one rank starts no group; a larger one raises where a process group
    already runs in this process."""
    import torch.fx.experimental._config as fx_config
    world = data * model
    if world > 1 and dist.is_initialized():
        raise RuntimeError("a process group already runs in this process; "
                           "the dry run starts its own")
    was = fx_config.meta_nonzero_assume_all_nonzero
    fx_config.meta_nonzero_assume_all_nonzero = True
    try:
        if world == 1:
            yield ProcessMesh(1, 1, 0, torch.device("meta"))
            return
        # importing it registers the "fake" backend
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
        try:
            yield ProcessMesh(
                data, model, 0, torch.device("meta"), "fake",
                dist.new_group(list(range(model))),
                dist.new_group(list(range(0, world, model))))
        finally:
            dist.destroy_process_group()
    finally:
        fx_config.meta_nonzero_assume_all_nonzero = was


def group_ranks(mesh, group: str) -> range:
    """Rank 0's ``"model"`` or ``"data"`` group on ``mesh``."""
    data, model = mesh.shape["data"], mesh.shape["model"]
    return range(model) if group == "model" \
        else range(0, data * model, model)


def link_bw(ranks) -> float:
    """Bytes/s a card over a group of ``ranks``: NVLink within one node of
    ``H100["node_cards"]``, the network across nodes."""
    nodes = {r // H100["node_cards"] for r in ranks}
    return H100["nvlink_bw"] if len(nodes) <= 1 else H100["net_bw"]


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------

class Cell(NamedTuple):
    """One rank's model, optimizer state (train), caches (serving) and
    rows of the inputs."""
    cfg: ModelConfig
    kind: str
    seq: int
    model: torch.nn.Module
    opt_state: Any
    opt_cfg: Optional[AdamWConfig]
    caches: Any
    inputs: Dict[str, torch.Tensor]


def _draw(inputs: Dict[str, torch.Tensor], cfg: ModelConfig) -> None:
    """Fill real inputs in place: token ids from the vocabulary, floats
    from a normal; drawn from seed 0."""
    g = torch.Generator().manual_seed(0)
    for t in inputs.values():
        src = torch.randint(0, cfg.vocab, t.shape, generator=g) \
            if not t.is_floating_point() else torch.randn(t.shape,
                                                          generator=g)
        t.copy_(src)


def build_cell(cfg: ModelConfig, shape: str, layout, *, batch: int,
               seq: int, opt_cfg: Optional[AdamWConfig] = None,
               device="meta") -> Cell:
    """The :class:`Cell` of rank ``layout`` for ``cfg`` (its shape's
    overrides applied) on ``device``: ``meta`` holds shapes alone;
    elsewhere the weights and inputs are drawn from seed 0. A train
    cell's optimizer state follows ``opt_cfg`` (default
    :func:`opt_config_for`); a prefill's caches hold ``seq + 8``
    positions, a decode's ``seq``, as the JAX package's dry run sizes
    them."""
    kind = SHAPES[shape][2]
    meta = torch.device(device).type == "meta"
    maxpos = seq + 8 if cfg.norm == "layernorm" else 0
    model = abstract_params(cfg, maxpos, layout) if meta else init_sharded(
        torch.Generator(device=device).manual_seed(0), cfg, layout,
        device, maxpos)
    inputs = layout.batch(input_specs(cfg, shape, batch, device, seq))
    if not meta:
        _draw(inputs, cfg)
    opt_state = caches = None
    if kind == "train":
        opt_cfg = opt_cfg or opt_config_for(cfg)
        params = dict(model.named_parameters())
        opt_state = abstract_opt_state(params, opt_cfg) if meta \
            else init_opt_state(params, opt_cfg)
    else:
        opt_cfg = None
        caches = init_caches(cfg, batch, seq + 8 if kind == "prefill"
                             else seq, device, layout)
        if kind == "decode" and cfg.is_encdec:
            rows = layout.rows(batch)
            caches.enc_out = torch.zeros(
                (rows.stop - rows.start, cfg.enc_seq, cfg.d_model),
                dtype=torch.bfloat16, device=device)
    return Cell(cfg, kind, seq, model, opt_state, opt_cfg, caches, inputs)


def tensor_bytes(tree) -> int:
    """Bytes of every tensor in ``tree`` (each storage once)."""
    seen = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[id(st)] = st.nbytes()
    return sum(seen.values())


def cell_bytes(cell: Cell) -> Dict[str, int]:
    """A rank's parameter, optimizer-state, cache and input bytes."""
    caches = None if cell.caches is None else (
        list(cell.caches), getattr(cell.caches, "enc_out", None))
    return {"param_bytes": tensor_bytes(list(cell.model.parameters())),
            "opt_bytes": tensor_bytes(None if cell.opt_state is None
                                      else tuple(cell.opt_state)),
            "cache_bytes": tensor_bytes(caches),
            "input_bytes": tensor_bytes(cell.inputs)}


@contextlib.contextmanager
def _first_microbatch(counter: StepCounter, microbatches: int
                      ) -> Iterator[None]:
    """While the train step of ``microbatches`` runs, its first
    microbatch's forward and backward counted ``microbatches`` times and
    the later ones not run: each leaves the first's gradients in
    ``.grad`` (held until the last) and returns its metrics."""
    from ..train import step as TS
    real = TS._backward
    first: Dict[str, Any] = {}
    calls = [0]

    def backward(model, batch):
        i = calls[0]
        calls[0] += 1
        if i == 0:
            with counter.repeating(microbatches):
                first["metrics"] = real(model, batch)
            first["grads"] = {k: p.grad
                              for k, p in model.named_parameters()}
            return first["metrics"]
        for k, p in model.named_parameters():
            p.grad = first["grads"][k]
        metrics = first["metrics"]
        if i == microbatches - 1:
            first.clear()
        return metrics

    TS._backward = backward
    try:
        yield
    finally:
        TS._backward = real


def run_cell(cell: Cell, counter: StepCounter, microbatches: int = 1):
    """Run ``cell``'s step under ``counter``, its arguments adopted as
    live and their bytes kept as ``counter.start``; returns the step's
    outputs."""
    from ..train.step import make_train_step
    counter.adopt((list(cell.model.parameters()),
                   list(cell.model.buffers()), cell.inputs,
                   None if cell.opt_state is None else tuple(cell.opt_state),
                   None if cell.caches is None else (
                       list(cell.caches),
                       getattr(cell.caches, "enc_out", None))))
    counter.start = counter.live
    if cell.kind == "train":
        step = make_train_step(cell.cfg, cell.opt_cfg,
                               microbatches=microbatches)
        with counter, _first_microbatch(counter, microbatches) \
                if microbatches > 1 else contextlib.nullcontext():
            return step(cell.model, cell.opt_state, cell.inputs)
    with torch.no_grad(), counter:
        if cell.kind == "prefill":
            return make_prefill_step(cell.cfg)(cell.model, cell.inputs,
                                               cell.caches)
        return make_decode_step(cell.cfg)(cell.model, cell.inputs["token"],
                                          cell.seq - 1, cell.caches)


def lower_cell(arch: str, shape: str, mesh, *,
               n_periods: Optional[int] = None,
               batch: Optional[int] = None,
               microbatches: Optional[int] = None,
               seq: Optional[int] = None,
               opt_cfg: Optional[AdamWConfig] = None,
               cfg: Optional[ModelConfig] = None,
               device="meta") -> Dict[str, Any]:
    """Reckon one cell for rank 0 of ``mesh`` (anything with a ``("data",
    "model")`` shape): its step run once under a :class:`StepCounter`
    over :func:`fake_mesh`. ``cfg`` replaces ``arch``'s config (a smoke
    config), ``seq`` the shape's positions, ``opt_cfg`` the optimizer of
    :func:`opt_config_for`; ``device="cpu"`` runs the same step on real
    tensors drawn from seed 0 (the counts are the same: tests hold them
    so). Returns the module docstring's keys."""
    cfg = shape_overrides(cfg or get_config(arch), shape)
    shape_seq, gbatch, kind = SHAPES[shape]
    seq = seq or shape_seq
    b = batch or gbatch
    if n_periods is not None:
        cfg = dataclasses.replace(cfg, n_periods=n_periods)
    mb = microbatches if microbatches is not None \
        else default_microbatches(arch, shape)
    data, model = mesh.shape["data"], mesh.shape["model"]
    with fake_mesh(data, model) as pm:
        cell = build_cell(cfg, shape, pm.layout(cfg, b, kind), batch=b,
                          seq=seq, opt_cfg=opt_cfg, device=device)
        counter = StepCounter({"model": pm.model_group,
                               "data": pm.data_group})
        sizes = cell_bytes(cell)
        t0 = time.time()
        out = run_cell(cell, counter, mb if kind == "train" else 1)
        pass_s = time.time() - t0
        live_end = counter.live
        del out, cell
    coll_total, coll_kinds = summarize(counter)
    flops = sum(counter.flops.values())
    stats = {
        "arch": arch, "shape": shape,
        "mesh": f"{data}x{model}", "n_chips": data * model,
        "n_periods": cfg.n_periods, "batch": b, "seq": seq,
        "compile_s": round(pass_s, 1),
        "flops": flops,
        "flops_bf16": counter.flops.get("bf16", 0.0),
        "flops_f32": counter.flops.get("f32", 0.0),
        "hbm_bytes_accessed": float(counter.bytes),
        "collective_bytes": float(coll_total),
        "collective_kinds": coll_kinds,
        "collective_groups": by_group(counter),
        "argument_bytes": counter.start,
        "output_bytes": max(0, live_end - counter.start),
        "temp_bytes": counter.peak - counter.start,
        "peak_bytes": counter.peak,
        "generated_code_bytes": 0,
        "per_card": True,
        **sizes,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "microbatches": mb,
    }
    for field in ("flops", "hbm_bytes_accessed", "collective_bytes"):
        stats[f"{field}_model"] = stats[field]
    return stats


def cell_stats(arch: str, shape: str, mesh, **kw) -> Dict[str, Any]:
    """:func:`lower_cell` (``kw`` its keywords) with its roofline,
    ``model_flops`` and ``useful_flop_frac``: the JAX package's
    extrapolation from unrolled variants has no counterpart (module
    docstring)."""
    st = lower_cell(arch, shape, mesh, **kw)
    st["roofline"] = roofline(st)
    st["model_flops"] = model_flops(arch, shape)
    st["useful_flop_frac"] = (st["model_flops"]
                              / (st["flops_model"] * st["n_chips"])
                              if st["flops_model"] else 0.0)
    return st


def _mesh_of(stats: Dict[str, Any]) -> MeshShape:
    data, model = (int(x) for x in stats["mesh"].split("x")[-2:])
    return MeshShape(data, model)


def roofline(stats: Dict[str, Any]) -> Dict[str, Any]:
    """Three roofline terms in seconds, a card's counts over
    :data:`~repro_torch.launch.mesh.H100`'s peaks: compute (bf16 FLOPs
    over the tensor cores' rate plus f32 FLOPs over the f32 rate), memory
    (bytes accessed over HBM's rate) and collective (each group's bytes
    over its link: :func:`link_bw`). A row of the JAX package's dry run
    (no dtype split, no groups) takes all its FLOPs as bf16 and its
    collectives over the network."""
    hw = H100
    bf16 = stats.get("flops_bf16", stats["flops_model"])
    compute_s = bf16 / hw["peak_flops_bf16"] \
        + stats.get("flops_f32", 0.0) / hw["peak_flops_f32"]
    memory_s = stats["hbm_bytes_accessed_model"] / hw["hbm_bw"]
    groups = stats.get("collective_groups")
    if groups is None:
        coll_s = stats["collective_bytes_model"] / hw["net_bw"]
    else:
        mesh = _mesh_of(stats)
        coll_s = sum(n / link_bw(group_ranks(mesh, g)
                                 if g in ("model", "data") else range(
                                     mesh.size))
                     for g, n in groups.items())
    dom = max(("compute", compute_s), ("memory", memory_s),
              ("collective", coll_s), key=lambda kv: kv[1])
    return {"compute_s": compute_s, "memory_s": memory_s,
            "collective_s": coll_s, "dominant": dom[0], "bound_s": dom[1]}


def model_flops(arch: str, shape: str) -> float:
    cfg = get_config(arch)
    seq, gbatch, kind = SHAPES[shape]
    n_active = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n_active * seq * gbatch
    if kind == "prefill":
        return 2.0 * n_active * seq * gbatch
    return 2.0 * n_active * 1 * gbatch  # one token per request


def parse_meshes(text: str):
    """``--mesh``: ``single``, ``multi``, ``both`` or ``DxM`` -> [(name,
    MeshShape)]."""
    if text in ("single", "multi", "both"):
        out = []
        if text in ("single", "both"):
            out.append(("pod256", make_production_mesh(multi_pod=False)))
        if text in ("multi", "both"):
            out.append(("pods512", make_production_mesh(multi_pod=True)))
        return out
    data, _, model = text.partition("x")
    if not (data.isdigit() and model.isdigit()):
        raise argparse.ArgumentTypeError(
            f"--mesh {text!r}: single, multi, both or DxM")
    return [(text, MeshShape(int(data), int(model)))]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", type=parse_meshes, default="single",
                    help="single (16x16), multi (32x16: the two pods), "
                         "both, or DxM")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None,
                    help="the global batch (default: the shape's)")
    ap.add_argument("--seq", type=int, default=None,
                    help="positions a row (default: the shape's)")
    ap.add_argument("--moment-dtype", choices=("float32", "bfloat16"),
                    default=None, help="AdamW's moments (default: "
                    "bfloat16 over 60 B parameters, else float32)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)
    meshes = args.mesh
    opt = None if args.moment_dtype is None else AdamWConfig(
        moment_dtype=args.moment_dtype)
    if not args.all and not (args.arch and args.shape):
        ap.error("name --arch and --shape, or --all")

    # cheap shapes first so partial sweeps maximize table coverage
    shape_order = ["decode_32k", "long_500k", "prefill_32k", "train_4k"]
    cells = ([(a, s) for s in shape_order for a in ARCH_IDS]
             if args.all else [(args.arch, args.shape)])

    os.makedirs(args.out, exist_ok=True)
    results = []
    done = set()
    out_path = os.path.join(args.out, "dryrun.json")
    if args.resume and os.path.exists(out_path):
        with open(out_path) as f:
            results = json.load(f)
        done = {(r.get("arch"), r.get("shape"), r.get("mesh"))
                for r in results if "error" not in r}
        done |= {(r.get("arch"), r.get("shape"), None)
                 for r in results if "skipped" in r}
        print(f"resuming: {len(done)} cells already recorded")
    t_all = time.time()
    for arch, shape in cells:
        ok, reason = cell_is_applicable(arch, shape)
        if not ok:
            if (arch, shape, None) not in done:
                print(f"SKIP {arch} {shape}: {reason}", flush=True)
                results.append({"arch": arch, "shape": shape,
                                "skipped": reason})
            continue
        for mesh_name, mesh in meshes:
            tag = f"{arch}|{shape}|{mesh_name}"
            if (arch, shape, mesh.tag()) in done:
                continue
            try:
                st = cell_stats(arch, shape, mesh,
                                microbatches=args.microbatches,
                                batch=args.batch, seq=args.seq, opt_cfg=opt)
                results.append(st)
                r = st["roofline"]
                over = " OVER 80 GB" if st["peak_bytes"] > H100["hbm_bytes"] \
                    else ""
                print(f"OK   {tag}: pass={st['compile_s']}s "
                      f"dom={r['dominant']} bound={r['bound_s']*1e3:.2f}ms "
                      f"peak/card={st['peak_bytes']/1e9:.2f}GB{over}",
                      flush=True)
            # the sweep's boundary: a failed cell is recorded with its
            # traceback, counted, and the exit code says so; the other
            # cells still run
            except Exception as e:  # repro: allow[swallowed-format-error]
                print(f"FAIL {tag}: {e}", flush=True)
                traceback.print_exc()
                results.append({"arch": arch, "shape": shape,
                                "mesh": mesh.tag(), "error": str(e)[:500]})
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1)
    n_ok = sum(1 for r in results if "flops" in r)
    n_fail = sum(1 for r in results if "error" in r)
    n_skip = sum(1 for r in results if "skipped" in r)
    print(f"\n=== dry-run: {n_ok} ok, {n_fail} failed, {n_skip} skipped "
          f"in {time.time() - t_all:.1f} s ===")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
