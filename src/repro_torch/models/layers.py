"""Shared layers: norms, rotary embeddings, activations, param building.

The port of the JAX package's ``models/layers.py``. The same functions on
torch tensors; :class:`ParamBuilder` draws from an explicit
``torch.Generator`` on a device, and the ``meta`` device takes the place
of the JAX ``ParamBuilder``'s ``abstract=True``. Each parameter carries
the JAX ``ParamBuilder``'s logical axes, and a ``ParamBuilder`` given a
:class:`~repro_torch.dist.plan.ShardLayout` keeps only one rank's slice.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.api import resolve_device


def resolve_model_device(device) -> torch.device:
    """``device`` as :func:`repro_torch.core.api.resolve_device` resolves it
    (the card, which must be there, or the CPU when asked for), or the
    ``meta`` device, which allocates nothing."""
    dev = torch.device(device)
    return dev if dev.type == "meta" else resolve_device(dev)


# ---------------------------------------------------------------------------
# Param construction
# ---------------------------------------------------------------------------

class ParamBuilder:
    """Makes a model's parameters, one :meth:`add` a tensor, in order.

    Normal tensors are drawn in f32 from ``generator`` on ``device``, scaled
    (by ``1/sqrt(fan_in)`` unless ``scale`` is given, fan-in being
    ``shape[-2]`` for a tensor of rank 2 or more) and cast to ``dtype``.
    On the ``meta`` device nothing is drawn or allocated: the shapes and
    dtypes of a full-width model, as the JAX builder's ``abstract=True``.

    Every :meth:`add` names the tensor's logical axes, as the JAX
    ``ParamBuilder.add(name, shape, logical)``; :meth:`axes_of` gives them
    back, and :meth:`segments_of` the ``dist.plan.Segments`` of a tensor
    whose split dimension joins unlike runs (SSD's). With a ``layout``, a
    tensor split over its model axis is drawn whole, in the same order,
    and only the rank's part is kept
    (:meth:`~repro_torch.dist.plan.ShardLayout.param_cut`): a sharded
    model is then the exact slice of the whole one drawn from the same
    generator.
    """

    def __init__(self, generator: Optional[torch.Generator],
                 dtype: torch.dtype = torch.bfloat16, device="cuda",
                 layout=None):
        self.device = resolve_model_device(device)
        if self.device.type != "meta" and generator is None:
            raise ValueError("a ParamBuilder off the meta device draws from "
                             "an explicit torch.Generator")
        self.generator = generator
        self.dtype = dtype
        self.layout = layout
        self._axes: Dict[int, Tuple[Optional[str], ...]] = {}
        self._shapes: Dict[int, Tuple[int, ...]] = {}
        self._segments: Dict[int, object] = {}

    def add(self, shape: Sequence[int], axes: Sequence[Optional[str]],
            scale: Optional[float] = None, init: str = "normal",
            segments=None) -> nn.Parameter:
        shape, axes = tuple(shape), tuple(axes)
        if len(shape) != len(axes):
            raise ValueError(f"shape {shape} needs one logical axis a "
                             f"dimension, got {axes}")
        cut = self.layout.param_cut(shape, axes, segments) \
            if self.layout else None
        local = list(shape)
        if cut is not None:
            local[cut.dim] = cut.length
        if self.device.type == "meta":
            t = torch.empty(local, dtype=self.dtype, device="meta")
        elif init == "zeros":
            t = torch.zeros(local, dtype=self.dtype, device=self.device)
        elif init == "ones":
            t = torch.ones(local, dtype=self.dtype, device=self.device)
        else:
            if scale is None:
                fan_in = shape[-2] if len(shape) > 1 else shape[-1]
                scale = 1.0 / np.sqrt(max(1, fan_in))
            t = torch.randn(shape, generator=self.generator,
                            dtype=torch.float32, device=self.device)
            t = t.mul_(float(scale))
            if cut is not None:
                # a copy of the part alone, so that the whole draw is freed
                t = cut.take(t).to(self.dtype, copy=True,
                                   memory_format=torch.contiguous_format)
            else:
                t = t.to(self.dtype)
        p = nn.Parameter(t, requires_grad=False)
        self._axes[id(p)] = axes
        self._shapes[id(p)] = shape
        if segments is not None:
            self._segments[id(p)] = segments
        return p

    def axes_of(self, p: nn.Parameter) -> Tuple[Optional[str], ...]:
        """The logical axes :meth:`add` gave ``p``."""
        return self._axes[id(p)]

    def shape_of(self, p: nn.Parameter) -> Tuple[int, ...]:
        """The whole shape of ``p``, of which a layout may keep a part."""
        return self._shapes[id(p)]

    def segments_of(self, p: nn.Parameter):
        """The ``Segments`` :meth:`add` gave ``p``, or None."""
        return self._segments.get(id(p))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + weight.float())).to(dt)


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(dt)


class Norm(nn.Module):
    """RMSNorm (``w`` zero-initialised, applied as ``1 + w``) or LayerNorm
    (``w`` ones, ``b`` zeros), as the config's ``norm`` says."""

    def __init__(self, b: ParamBuilder, d: int, kind: str):
        super().__init__()
        self.kind = kind
        if kind == "rmsnorm":
            self.w = b.add((d,), (None,), init="zeros")
        else:
            self.w = b.add((d,), (None,), init="ones")
            self.b = b.add((d,), (None,), init="zeros")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "rmsnorm":
            return rmsnorm(x, self.w)
        return layernorm(x, self.w, self.b)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., S, H, Dh) with positions (..., S); rotates the split halves
    of Dh (not interleaved pairs), in f32."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)              # (Dh/2,)
    ang = positions[..., None].float() * freqs           # (..., S, Dh/2)
    cos = torch.cos(ang)[..., None, :]  # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------
# Each is written as the JAX function's own sequence of operations, with
# its Python constants rounded to the input's dtype as ``jnp`` rounds a
# weak scalar: on a bf16 tensor every step then rounds where JAX's does,
# and the results are bit-identical to ``jax.nn``'s on the CPU
# (``F.gelu(approximate="tanh")`` and ``F.silu`` round once, in f32, and
# differ from JAX's bf16 results by an ulp in about 40% of elements).

@functools.lru_cache(maxsize=None)
def weak_scalar(c: float, dtype: torch.dtype) -> float:
    """``c`` rounded to ``dtype``, as ``jnp`` takes a Python scalar in an
    operation with an array of that dtype (torch would keep its f32
    value for a bf16 tensor)."""
    return torch.tensor(c, dtype=dtype).item()


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA computes it: ``1 / (1 + exp(-x))``."""
    return 1 / (1 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    c = functools.partial(weak_scalar, dtype=x.dtype)
    cdf = c(0.5) * (1 + torch.tanh(
        c(float(np.sqrt(2 / np.pi))) * (x + c(0.044715) * (x ** 3))))
    return x * cdf


def activation_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    return {
        "gelu": gelu,
        "silu": silu,
        "relu": F.relu,
        "sqrelu": lambda x: torch.square(F.relu(x)),
    }[name]


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the two operands' promoted dtype, as ``jnp`` promotes a
    bf16 operand against an f32 one (torch refuses mixed dtypes)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)
