"""Weights carried across from the JAX package's models.

The JAX package's ``init_params(...).params`` is a dict whose ``pattern``
entry holds the periodic layers' parameters stacked over periods. Here it
travels flat, as ``dict[str, np.ndarray]``: each top-level name as it is
(the encoder's ``enc.{i}.*``, ``enc_norm``, the frontends' ``aud_proj``,
``enc_pos``, ``vis_proj*`` and ``dec_pos``, the MTP head's ``mtp.*``: the
port's model has the same names), ``prefix.{i}.*`` as ``blocks.{i}.*``,
and each pattern leaf as ``pattern.<name>`` with its leading period axis,
every value an f32 array (``np.asarray(x.astype(jnp.float32))``: bf16 ->
f32 -> bf16 is lossless). With a ``layout`` each value is cut to one
rank's slice on the host, before it reaches the device.
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from ..core.api import resolve_device
from .config import ModelConfig
from .model import Model, abstract_params, torch_dtype

_PREFIX = re.compile(r"prefix\.(\d+)\.(.+)")
_PATTERN = re.compile(r"pattern\.slot(\d+)\.(.+)")


def params_from_jax(flat: Dict[str, np.ndarray], cfg: ModelConfig,
                    max_positions: int = 0, device="cuda",
                    layout=None) -> Model:
    """A model holding the JAX package's weights, in ``cfg.param_dtype``,
    on ``device`` (the card unless the caller passes ``device="cpu"``);
    with a ``layout`` (a ``dist.plan.ShardLayout``), one rank's slice of
    them.

    Refuses a name the port's model does not have, a shape other than
    its own, and a model parameter the dict leaves out.
    """
    device = resolve_device(device)
    model = abstract_params(cfg, max_positions, layout)
    whole = abstract_params(cfg, max_positions)
    want = {k: tuple(v.shape) for k, v in whole.state_dict().items()}
    n_pre, n_pat = len(cfg.prefix_layers), len(cfg.pattern)
    dt = torch_dtype(cfg.param_dtype)
    state = {}
    for name, value in flat.items():
        value = np.asarray(value)
        m = _PATTERN.fullmatch(name)
        if m:
            slot, rest = int(m.group(1)), m.group(2)
            if slot >= n_pat or value.ndim == 0 \
                    or value.shape[0] != cfg.n_periods:
                raise ValueError(f"{name}: no slot {slot} of {n_pat} over "
                                 f"{cfg.n_periods} periods (shape "
                                 f"{value.shape})")
            items = [(f"blocks.{n_pre + p * n_pat + slot}.{rest}", value[p])
                     for p in range(cfg.n_periods)]
        else:
            m = _PREFIX.fullmatch(name)
            items = [(f"blocks.{m.group(1)}.{m.group(2)}" if m else name,
                      value)]
        for key, v in items:
            if key not in want:
                raise ValueError(f"{name}: the port's {cfg.name} model has "
                                 f"no parameter {key!r}")
            if v.shape != want[key]:
                raise ValueError(f"{name}: shape {v.shape}, the port's "
                                 f"{key!r} is {want[key]}")
            cut = model.param_cut(key, v.shape, layout) if layout \
                else None
            if cut is not None:
                v = cut.take(v)
            state[key] = torch.from_numpy(
                np.array(v, dtype=np.float32)).to(dt).to(device)
    missing = sorted(set(want) - set(state))
    if missing:
        raise ValueError(f"no value for {len(missing)} parameters: "
                         f"{missing[:5]}")
    model.load_state_dict(state, assign=True)
    return model

