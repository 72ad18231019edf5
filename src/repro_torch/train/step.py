"""The train and eval steps: grad accumulation (microbatching), remat
(``cfg.remat``, in :func:`repro_torch.models.model._run_stack`) and mixed
precision.

The port of the JAX package's ``train/step.py``. A step takes the model
(an ``nn.Module``), the optimizer state and a batch of tensors on the
model's device, and returns them: the parameters and the state are
updated in place (:func:`repro_torch.train.optimizer.adamw_update`).
The JAX package's pipeline-parallel forward (``make_pipelined_forward``)
and training across cards are not ported yet (ROADMAP A15c): serving
splits a model over a model group (``dist.tensor_parallel``), training
runs on one card.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..models.config import ModelConfig
from ..models.model import Model, forward_train
from .optimizer import AdamWConfig, OptState, adamw_update
from .schedule import SCHEDULES


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
            loss, metrics = forward_train(model, batch)
            loss.backward()
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
                loss, _ = forward_train(
                    model, {k: split(v, i) for k, v in batch.items()})
                loss.backward()
                for k, p in params.items():
                    if p.grad is not None:
                        gsum[k].add_(p.grad)
                model.zero_grad(set_to_none=True)
                lsum = lsum + loss.detach()
            grads = {k: g / microbatches for k, g in gsum.items()}
            del gsum
            metrics = {"loss": lsum / microbatches}

        lr_scale = sched(opt_state.step, **sched_kwargs)
        _, opt_state, opt_metrics = adamw_update(params, grads, opt_state,
                                                 opt_cfg, lr_scale)
        del grads
        model.zero_grad(set_to_none=True)
        metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                   for k, v in metrics.items()}
        metrics.update(opt_metrics)
        return model, opt_state, metrics

    return train_step


def make_eval_step(cfg: ModelConfig) -> Callable:
    """``eval_step(model, batch) -> metrics``: :func:`forward_train`
    without gradients."""

    def eval_step(model: Model, batch: Dict):
        with torch.no_grad():
            _, metrics = forward_train(model, batch)
        return metrics

    return eval_step
