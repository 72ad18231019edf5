"""The train and eval steps: grad accumulation (microbatching), remat
(``cfg.remat``, in :func:`repro_torch.models.model._run_stack`), mixed
precision, and the GPipe forward over a stage group.

The port of the JAX package's ``train/step.py``. A step takes the model
(an ``nn.Module``), the optimizer state and a batch of tensors on the
model's device, and returns them: the parameters and the state are
updated in place (:func:`repro_torch.train.optimizer.adamw_update`).

Across cards the model is one rank's slice (``model.layout``, a
``dist.plan.ShardLayout`` of a ``(data, model)`` process mesh) and the
batch its rows of the global batch (:func:`train_rows`). The step is
the same: the forward and backward run over the model group
(``models.model.forward_train``), then :func:`exchange_grads` sums each
gradient over the data group once (after the last microbatch) and the
partial ones over the model group (``dist.plan.grad_classes``), and
AdamW updates each rank's slices with the norm and compression scales
taken over the group. The JAX package gets the same from XLA's
partitioner under its training rules.

:func:`make_pipelined_forward` is the JAX package's GPipe forward over
ranks of a stage group, with the gradient ``jax.grad`` takes through it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..dist import tensor_parallel as TP
from ..dist.plan import CUT, PARTIAL, grad_classes
from ..models.config import ModelConfig
from ..models.model import (Model, _embed_inputs, _logits, _run_stack,
                            abstract_params, forward_train)
from .optimizer import AdamWConfig, OptState, adamw_update
from .schedule import SCHEDULES


def train_rows(layout, batch: int, microbatches: int = 1) -> np.ndarray:
    """This rank's rows of a global batch of ``batch`` for a step of
    ``microbatches``: of each microbatch's run of rows (the JAX step's
    split of the global batch), its data rank's share, so that its
    microbatch ``i`` holds its part of the global microbatch ``i``. All
    rows without a data split."""
    rows = np.arange(batch)
    if not TP.data_split(layout):
        return rows
    if batch % (microbatches * layout.data):
        raise ValueError(f"a batch of {batch} does not split into "
                         f"{microbatches} microbatches over {layout.data} "
                         f"data ranks")
    n = batch // (microbatches * layout.data)
    return rows.reshape(microbatches, layout.data, n)[
        :, layout.data_rank].reshape(-1)


def exchange_grads(grads: Dict[str, torch.Tensor], classes, layout) -> None:
    """Complete each rank's gradients in place: each summed over the data
    group where the data ranks hold different rows, then each
    :data:`~repro_torch.dist.plan.PARTIAL` one (and the runs of a cut one
    held whole) summed over the model group."""
    if layout is None:
        return
    for k, g in grads.items():
        TP.data_sum(g, layout)
        c = classes[k]
        if c.kind == PARTIAL:
            TP.all_reduce_sum(g, layout)
        elif c.kind == CUT:
            for start, n in c.whole_runs:
                part = g.narrow(c.cut.dim, start, n)
                part.copy_(TP.all_reduce_sum(part.contiguous(), layout))


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    *,
    schedule: str = "cosine",
    microbatches: int = 1,
    schedule_kwargs: Optional[Dict] = None,
) -> Callable:
    """The train step (loss forward and backward, then AdamW):
    ``step(model, opt_state, batch) -> (model, opt_state, metrics)``.

    It switches gradients on for the model it trains and drops each
    step's ``.grad`` (``set_to_none``). ``microbatches > 1`` splits the
    batch's leading axis and, as the JAX package does, takes each
    microbatch's gradients on their own (in the parameters' dtype), adds
    them into f32 sums, and divides by ``microbatches``; its metrics are
    then the mean ``loss`` alone, beside the optimizer's. The LR scale is
    the schedule at ``opt_state.step``, before the update counts it.
    Over a layout (``model.layout``; ``batch`` the rank's rows,
    :func:`train_rows`) the gradients are exchanged
    (:func:`exchange_grads`) before the update.
    """
    sched_kwargs = schedule_kwargs or {}
    sched = SCHEDULES[schedule]

    def grads_of(params):
        return {k: p.grad if p.grad is not None else torch.zeros_like(p)
                for k, p in params.items()}

    def train_step(model: Model, opt_state: OptState, batch: Dict):
        model.requires_grad_(True)
        model.zero_grad(set_to_none=True)
        params = dict(model.named_parameters())
        if microbatches <= 1:
            metrics = _backward(model, batch)
            grads = grads_of(params)
        else:
            def split(x, i):
                b = x.shape[0]
                assert b % microbatches == 0, (b, microbatches)
                n = b // microbatches
                return x[i * n: (i + 1) * n]

            gsum = {k: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                    for k, p in params.items()}
            lsum = torch.zeros((), dtype=torch.float32,
                               device=opt_state.step.device)
            for i in range(microbatches):
                mb = _backward(
                    model, {k: split(v, i) for k, v in batch.items()})
                for k, p in params.items():
                    if p.grad is not None:
                        gsum[k].add_(p.grad)
                model.zero_grad(set_to_none=True)
                lsum = lsum + mb["loss"].detach()
            grads = {k: g / microbatches for k, g in gsum.items()}
            del gsum
            metrics = {"loss": lsum / microbatches}

        layout = model.layout
        classes = grad_classes(model) if layout is not None else None
        exchange_grads(grads, classes, layout)
        lr_scale = sched(opt_state.step, **sched_kwargs)
        _, opt_state, opt_metrics = adamw_update(params, grads, opt_state,
                                                 opt_cfg, lr_scale, classes,
                                                 layout)
        del grads
        model.zero_grad(set_to_none=True)
        metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                   for k, v in metrics.items()}
        metrics.update(opt_metrics)
        return model, opt_state, metrics

    return train_step


def _backward(model: Model, batch: Dict) -> Dict:
    """:func:`forward_train`'s metrics, its loss's gradients left in
    ``.grad``."""
    loss, metrics = forward_train(model, batch)
    loss.backward()
    return metrics


def make_eval_step(cfg: ModelConfig) -> Callable:
    """``eval_step(model, batch) -> metrics``: :func:`forward_train`
    without gradients."""

    def eval_step(model: Model, batch: Dict):
        with torch.no_grad():
            _, metrics = forward_train(model, batch)
        return metrics

    return eval_step


# ---------------------------------------------------------------------------
# Pipeline parallelism (GPipe) over a stage group
# ---------------------------------------------------------------------------

def stage_config(cfg: ModelConfig, n_stages: int) -> ModelConfig:
    """The config of one of ``n_stages`` pipeline stages: ``n_periods //
    n_stages`` periods of the pattern. Raises ``ValueError`` where the
    periods do not divide, and for a config with prefix layers or an
    encoder: the JAX package's stages drop them (``prefix_layers=()``,
    no encoder output), which computes another model."""
    if cfg.prefix_layers:
        raise ValueError(f"{cfg.name}: a pipeline stage holds periods of "
                         f"the pattern; the {len(cfg.prefix_layers)} "
                         f"prefix layers would be dropped")
    if cfg.is_encdec:
        raise ValueError(f"{cfg.name}: a pipeline stage runs no encoder")
    if cfg.n_periods % n_stages:
        raise ValueError(f"{cfg.name}: {cfg.n_periods} periods do not "
                         f"split into {n_stages} stages")
    return dataclasses.replace(cfg, n_periods=cfg.n_periods // n_stages)


def stage_model(model: Model, n_stages: int, stage: int) -> Model:
    """Stage ``stage`` of a whole ``model``: its run of periods (the
    blocks of ``stage_config``), and the embedding, final norm and head,
    sharing ``model``'s tensors."""
    cfg = stage_config(model.cfg, n_stages)
    maxpos = 0 if model.dec_pos is None else model.dec_pos.shape[0]
    out = abstract_params(cfg, maxpos)
    n = len(out.blocks)
    state = {}
    for name, t in model.state_dict().items():
        if name.startswith("blocks."):
            _, i, rest = name.split(".", 2)
            i = int(i) - stage * n
            if not 0 <= i < n:
                continue
            name = f"blocks.{i}.{rest}"
        state[name] = t
    out.load_state_dict(state, assign=True)
    return out


def _exchange(x: torch.Tensor, to: int, frm: int, group) -> torch.Tensor:
    """``x`` sent to global rank ``to`` while a tensor like it comes from
    ``frm``, in one ``batch_isend_irecv`` (through the host where the
    group's backend is gloo and ``x`` is on a card); the received one."""
    host = TP.through_host(x, group)
    send = x.cpu() if host else x.contiguous()
    recv = torch.empty_like(send)
    for req in dist.batch_isend_irecv(
            [dist.P2POp(dist.isend, send, to, group),
             dist.P2POp(dist.irecv, recv, frm, group)]):
        req.wait()
    return recv.to(x.device) if host else recv


def _broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """Global rank ``src``'s ``x`` on every rank of ``group``: ``x`` itself
    there, a new tensor like it elsewhere (through the host where the
    group's backend is gloo and ``x`` is on a card)."""
    mine = dist.get_rank() == src
    host = TP.through_host(x, group)
    buf = x.cpu() if host and mine else x if mine else torch.empty_like(
        x, device="cpu" if host else x.device)
    dist.broadcast(buf, src, group=group)
    return x if mine else buf.to(x.device)


class _Enter(torch.autograd.Function):
    """The embedded batch as it is, and the first link of the chain that
    orders the ring's backward (:class:`_Ring`). Backward: the first
    stage's gradient of the batch, broadcast to every stage, so that each
    stage's embedding gets the whole gradient of the lookup that fed the
    ring."""

    @staticmethod
    def forward(ctx, x, link, src, group):
        ctx.src, ctx.group = src, group
        return x.view_as(x), link.new_empty(0)

    @staticmethod
    def backward(ctx, g, _):
        return _broadcast(g.contiguous(), ctx.src, ctx.group), None, None, \
            None


class _Ring(torch.autograd.Function):
    """One tick's exchange: ``y`` to the next stage, what the previous
    one sent in return, and the next link of the chain. Backward the
    reverse exchange: the gradient of what came in goes back to the
    previous stage, ``y``'s comes from the next one.

    Each tick takes the previous tick's link, so every stage's ticks form
    one chain in the autograd graph, which autograd runs last to first:
    every stage makes the same exchanges in the same order, the ticks
    where it ran no microbatch (and sent zeros) included."""

    @staticmethod
    def forward(ctx, y, link, nxt, prv, group):
        ctx.peers = nxt, prv, group
        return _exchange(y, nxt, prv, group), link.new_empty(0)

    @staticmethod
    def backward(ctx, g, _):
        nxt, prv, group = ctx.peers
        return _exchange(g, prv, nxt, group), None, None, None, None


class _Exit(torch.autograd.Function):
    """The last stage's outputs on every stage, after the chain's last
    link (the JAX package sums them with the other stages' zeros).
    Backward: every stage takes the same loss of the same logits, so the
    last stage's own gradient is the whole one; the others pass none."""

    @staticmethod
    def forward(ctx, outs, link, src, group):
        ctx.mine = dist.get_rank() == src
        out = _broadcast(outs, src, group)
        return out.view_as(out) if ctx.mine else out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.mine else None), None, None, None


def make_pipelined_forward(cfg: ModelConfig, n_stages: int, group=None
                           ) -> Callable:
    """The JAX package's ``make_pipelined_forward``: the periods split over
    ``n_stages`` ranks of ``group`` (the default group when None), and
    microbatches passed round a ring of them (GPipe fill and drain).
    Returns ``pipeline(stage, batch, n_microbatches) -> logits``, where
    ``stage`` is this rank's :func:`stage_model` (the stage of its rank
    in ``group``).

    Every stage embeds the batch (the first stage's input) and splits it
    into ``n_microbatches``; over ``n_microbatches + n_stages - 1`` ticks
    the first stage takes microbatch ``t`` (the others what the ring
    brought), each stage runs its periods (``_run_stack``) where its
    microbatch is a real one, and sends its output to the next stage
    (``batch_isend_irecv``); the last stage keeps microbatch ``t -
    n_stages + 1``. Its outputs are broadcast to every stage, where the
    JAX package sums (``psum``) them with the others' zeros, and every
    stage returns the logits of them, as the JAX function does without
    the final norm.

    Under autograd the logits carry the gradient ``jax.grad`` takes
    through the JAX function: each stage's periods get their share, and
    the embedding, head and final norm the whole gradient, the same on
    every stage (the first stage's gradient of the embedded batch is
    broadcast to all). Every stage must take the same loss of its logits
    and run its backward: the backward makes each tick's exchange in
    reverse, last tick first, on every stage, and a stage that does not
    leaves its neighbours waiting. With ``cfg.remat`` each stage
    recomputes a microbatch's periods in that microbatch's backward.
    Raises for the configs :func:`stage_config` refuses."""
    stage_config(cfg, n_stages)
    size = dist.get_world_size(group)
    if size != n_stages:
        raise ValueError(f"{n_stages} stages over a group of {size} ranks")
    me = dist.get_rank(group)
    peer = [dist.get_global_rank(group, i) if group is not None else i
            for i in range(n_stages)]
    nxt, prv = peer[(me + 1) % n_stages], peer[(me - 1) % n_stages]
    last = n_stages - 1

    def recorded(stage: Model, batch: Dict) -> bool:
        """Whether the stages record the forward for a backward: grad mode
        on, and a parameter or input of some stage needing a gradient.
        Then the chain's first link needs one on every stage, so that
        every stage's ticks are in the graph, whatever else is."""
        if not torch.is_grad_enabled():
            return False
        mine = any(p.requires_grad for p in stage.parameters()) or any(
            torch.is_tensor(v) and v.requires_grad for v in batch.values())
        flag = torch.ones(1) if mine else torch.zeros(1)
        if dist.get_backend(group) != dist.Backend.GLOO:
            flag = flag.to(stage.embed.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
        return bool(flag.item())

    def pipeline(stage: Model, batch: Dict, n_microbatches: int
                 ) -> torch.Tensor:
        x = _embed_inputs(stage, batch)
        b, s, d = x.shape
        if b % n_microbatches:
            raise ValueError(f"a batch of {b} does not split into "
                             f"{n_microbatches} microbatches")
        link = x.new_empty(0, requires_grad=recorded(stage, batch))
        x, link = _Enter.apply(x, link, peer[0], group)
        mb = x.reshape(n_microbatches, b // n_microbatches, s, d)
        ins = mb.unbind(0) if me == 0 else None
        positions = torch.arange(s, device=x.device)[None].expand(
            b // n_microbatches, s)
        recv, ys = None, []
        for t in range(n_microbatches + n_stages - 1):
            if 0 <= t - me < n_microbatches:
                y, _ = _run_stack(stage, ins[t] if me == 0 else recv,
                                  positions)
            else:
                y = x.new_zeros(mb.shape[1:])
            recv, link = _Ring.apply(y, link, nxt, prv, group)
            if me == last and t >= last:
                ys.append(y)
        outs = torch.stack(ys) if me == last else x.new_empty(mb.shape)
        outs = _Exit.apply(outs, link, peer[last], group)
        return _logits(stage, outs.reshape(b, s, d))

    return pipeline
