"""In-house AdamW: configurable moment dtypes (bf16 moments halve the
optimizer state of a large config), global-norm clipping, an optional f32
master copy of bf16 parameters, and optional int8 error-feedback gradient
compression.

The port of the JAX package's ``train/optimizer.py``. Parameters,
gradients and each state tree are dicts keyed by the model's parameter
names (``dict(model.named_parameters())``). :func:`adamw_update` runs one
parameter at a time and writes the new values into the parameters and
the state's tensors in place, the counterpart of the JAX launcher's
donated buffers: the f32 temporaries of one parameter are alive at a
time, so a full-width model's update needs no second copy of its
parameters or moments.

Over a model group (``layout``, a ``dist.plan.ShardLayout``, with the
parameters' ``dist.plan.grad_classes``) each rank updates its own slices
of the parameters and of the state, cut as the parameters are; the
gradients given are whole (the train step has summed them over the data
group and the partial ones over the model group). What is not elementwise
spans the group: the global norm sums the squares of the cut parts over
the group and counts each part held whole once, and a compressed leaf's
int8 scale is the largest ``|g|`` over the group, so that every rank
scales, clips and dequantizes as the unsplit model does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..dist import tensor_parallel as TP
from ..dist.plan import CUT

Tree = Dict[str, torch.Tensor]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"      # "bfloat16" for the large configs
    master_weights: bool = False       # fp32 master copy of bf16 params
    compress_grads: bool = False       # int8 error-feedback compression


class OptState(NamedTuple):
    step: torch.Tensor       # () int32
    mu: Tree
    nu: Tree
    master: Optional[Tree]
    error: Optional[Tree]    # error-feedback residual (compression)


def _state(params: Tree, cfg: AdamWConfig, meta: bool) -> OptState:
    mdt = _DTYPES[cfg.moment_dtype]

    def zeros(p, dt):
        return torch.zeros(p.shape, dtype=dt,
                           device="meta" if meta else p.device)

    def master(p):
        return zeros(p, torch.float32) if meta \
            else p.detach().to(torch.float32, copy=True)

    step_dev = "meta" if meta else (
        next(iter(params.values())).device if params else "cpu")
    return OptState(
        torch.zeros((), dtype=torch.int32, device=step_dev),
        {k: zeros(p, mdt) for k, p in params.items()},
        {k: zeros(p, mdt) for k, p in params.items()},
        ({k: master(p) for k, p in params.items()}
         if cfg.master_weights else None),
        ({k: zeros(p, torch.bfloat16) for k, p in params.items()}
         if cfg.compress_grads else None))


def init_opt_state(params: Tree, cfg: AdamWConfig) -> OptState:
    """Zero moments in ``cfg.moment_dtype`` (and the f32 master copy, the
    bf16 residual), each on its parameter's device."""
    return _state(params, cfg, meta=False)


def abstract_opt_state(params: Tree, cfg: AdamWConfig) -> OptState:
    """Shape-only optimizer state on the ``meta`` device (memory
    accounting, a checkpoint's restore target)."""
    return _state(params, cfg, meta=True)


def _compress_int8(g: torch.Tensor, err: torch.Tensor,
                   amax: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 compression: (the dequantised gradient, the
    residual carried to the next step), both bf16. ``torch.round`` rounds
    half to even, as ``jnp.round`` does. ``amax``: the largest ``|g +
    err|`` of the whole leaf where this is a rank's part of it."""
    g = g.float() + err.float()
    if amax is None:
        amax = torch.amax(torch.abs(g))
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127)
    deq = q * scale
    return deq.to(torch.bfloat16), (g - deq).to(torch.bfloat16)


def _split(layout) -> bool:
    return layout is not None and layout.model > 1


def global_norm(tree: Tree, classes=None, layout=None) -> torch.Tensor:
    """The norm of every leaf together. Over a model group (``classes``,
    ``layout``): the squares of the cut parts summed over the group (one
    ``all_reduce``), the parts held whole counted once; the same on
    every rank."""
    if not _split(layout):
        return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                              for x in tree.values()))
    x0 = next(iter(tree.values()))
    cut = torch.zeros((), dtype=torch.float32, device=x0.device)
    whole = torch.zeros_like(cut)
    for k, x in tree.items():
        c = classes[k]
        if c.kind != CUT:
            whole = whole + torch.sum(torch.square(x.float()))
        elif not c.whole_runs:
            cut = cut + torch.sum(torch.square(x.float()))
        else:
            for start, n, held in c.runs:
                sq = torch.sum(torch.square(
                    x.narrow(c.cut.dim, start, n).float()))
                if held:
                    whole = whole + sq
                else:
                    cut = cut + sq
    return torch.sqrt(TP.all_reduce_sum(cut, layout) + whole)


def _amax_over_group(grads: Tree, err: Tree, layout) -> Dict:
    """Each leaf's largest ``|g + err|`` over the model group (one
    ``all_reduce`` of their vector)."""
    keys = list(grads)
    amax = torch.stack([torch.amax(torch.abs(grads[k].float()
                                             + err[k].float()))
                        for k in keys])
    return dict(zip(keys, TP.all_reduce_max(amax, layout)))


@torch.no_grad()
def adamw_update(params: Tree, grads: Tree, state: OptState,
                 cfg: AdamWConfig, lr_scale: torch.Tensor, classes=None,
                 layout=None
                 ) -> Tuple[Tree, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step; returns (params, state, metrics), the parameters and
    the state's moments, master copy and residual updated in place (the
    module docstring) and the state's ``step`` a new tensor. ``metrics``:
    the raw gradient norm and the LR, tensors on the device. The order of
    operations is the JAX package's: the clip scale from the raw norm,
    ``step + 1`` before the bias corrections, the update from the master
    copy when there is one, the moments cast back to their dtype. Over a
    model group (``classes`` from ``dist.plan.grad_classes``, ``layout``)
    the norm and the compression scales span the group (the module
    docstring)."""
    if cfg.compress_grads:
        amax = _amax_over_group(grads, state.error, layout) \
            if _split(layout) else {}
        out = {}
        for k, g in grads.items():
            out[k], err = _compress_int8(g, state.error[k], amax.get(k))
            state.error[k].copy_(err)
        grads = out

    gnorm = global_norm(grads, classes, layout)
    # a tensor numerator: torch takes ``scalar / t`` as ``t.reciprocal() *
    # scalar``, an ulp off the division
    scale = torch.clamp_max(
        gnorm.new_tensor(cfg.clip_norm) / torch.clamp_min(gnorm, 1e-12), 1.0)
    step = state.step + 1
    t = step.float()
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t
    lr = cfg.lr * lr_scale

    for k, p in params.items():
        g = grads[k].float() * scale
        m, v = state.mu[k], state.nu[k]
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        mh = m32 / bc1
        vh = v32 / bc2
        base = state.master[k] if cfg.master_weights else p
        w = base.float()
        w = w - lr * (mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * w)
        m.copy_(m32)
        v.copy_(v32)
        if cfg.master_weights:
            state.master[k].copy_(w)
        p.copy_(w)
    return params, state._replace(step=step), {"grad_norm": gnorm, "lr": lr}
