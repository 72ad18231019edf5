"""The exit and stream-write kernels: wrappers, plain versions, scatter.

:func:`decode_exits` is the sync-phase decode (one call per sync round,
over every lane or, for faithful sync's chains, a gathered subset) and
:func:`decode_streams` the write pass of ``fuse="post"``: per lane and
per symbol step, the local zig-zag offset and the coefficient, which
:func:`scatter_streams` places. The kernels are
``csrc/huffman.cu``; each wrapper takes its plain version only for
tensors on the CPU and otherwise launches the kernel or raises.

Operands: ``dev`` holds ``words`` (int32 bits of the uint32 words),
``luts`` and ``unit_lut_row``; ``meta`` is ``core.decode.chunk_meta(dev)``
(per-lane ``word_base``, ``limit``, ``ts``, ``upm``); ``entry`` is the
lanes' entry state.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from ...core import decode as D
from ...core.state import DecodeState
from .. import build as B

Dev = Dict[str, torch.Tensor]
_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_LANE_ARGS = [_VP, _I, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP]
_SIGNATURES = {
    "rt_decode_exits": _LANE_ARGS + [_VP] * 4 + [_I, _I, _I, _VP],
    "rt_decode_streams": _LANE_ARGS + [_VP] * 2 + [_I, _I, _I, _VP],
    "rt_decode_store": _LANE_ARGS + [_VP] * 3 + [_LL, _I, _I, _I, _VP],
}


def kernel_fn(name: str):
    """The C entry point ``name`` of ``csrc/huffman.cu``, typed."""
    return B.entry("huffman", name, _SIGNATURES[name])


def lane_args(dev: Dev, meta: Dev, entry: DecodeState) -> list:
    """Check the kernel operands and return them as C arguments."""
    words = dev["words"]
    c = entry.p.shape[0]
    lane = [meta["word_base"], meta["ts"], meta["limit"], meta["upm"],
            entry.p, entry.u, entry.z]
    tables = [words, dev["luts"], dev["unit_lut_row"]]
    for t in tables + lane:
        if t.device != words.device or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError(
                f"kernel operands must be contiguous int32 tensors on "
                f"{words.device}; got {t.dtype} on {t.device}")
    if any(t.shape != (c,) for t in lane):
        raise ValueError(f"per-lane operands must all have shape ({c},)")
    if dev["luts"].shape[1:] != (1 << 16,) or \
            dev["unit_lut_row"].shape[1:] != (6, 2):
        raise ValueError("luts must be (L, 65536) and unit_lut_row (TS, 6, 2)")
    return [B.ptr(words), int(words.shape[0]), B.ptr(dev["luts"]),
            B.ptr(dev["unit_lut_row"])] + [B.ptr(t) for t in lane]


# ---------------------------------------------------------------------------
# Exit decode (sync phase)
# ---------------------------------------------------------------------------

def lane_subset(meta: Dev, idx: Optional[torch.Tensor]) -> Dev:
    """``meta`` gathered at the lanes ``idx`` (all lanes for ``None``):
    the same values as ``core.decode.chunk_meta(dev, idx)``."""
    if idx is None:
        return meta
    idx = idx.to(torch.int64)
    return {k: v[idx] for k, v in meta.items()}


def decode_exits_plain(dev: Dev, meta: Dev, entry: DecodeState,
                       idx: Optional[torch.Tensor] = None, *, s_max: int,
                       min_code_bits: int) -> DecodeState:
    """Exit (p, u, z, n) of every lane, or of the lanes ``idx`` (one per
    entry, repeats allowed): ``core.decode.decode_span``."""
    m = lane_subset(meta, idx)
    st, _ = D.decode_span(dev, entry, m["word_base"], m["limit"], m["ts"],
                          m["upm"], s_max=s_max, min_code_bits=min_code_bits)
    return st


def decode_exits(dev: Dev, meta: Dev, entry: DecodeState,
                 idx: Optional[torch.Tensor] = None, *, s_max: int,
                 min_code_bits: int) -> DecodeState:
    """:func:`decode_exits_plain`, by the exit kernel on the card.

    The ``idx`` form (faithful sync's ``decode_at``) runs the same kernel
    over ``len(idx)`` lanes whose metadata is gathered at ``idx``, as the
    JAX wrapper's ``_lane_meta`` does. ``launches`` counts the full-lane
    form and ``subset_launches`` the ``idx`` form, each only its own.
    """
    if dev["words"].device.type == "cpu":
        return decode_exits_plain(dev, meta, entry, idx, s_max=s_max,
                                  min_code_bits=min_code_bits)
    args = lane_args(dev, lane_subset(meta, idx), entry)
    c = entry.p.shape[0]
    out = DecodeState(*(torch.empty_like(entry.p) for _ in range(4)))
    B.check(kernel_fn("rt_decode_exits")(
        *args, *(B.ptr(t) for t in out), c, s_max, min_code_bits,
        B.stream_of(entry.p)), "rt_decode_exits")
    if idx is None:
        decode_exits.launches += 1
    else:
        decode_exits.subset_launches += 1
    return out


decode_exits.launches = 0
decode_exits.subset_launches = 0


# ---------------------------------------------------------------------------
# Write pass, stream form: (pos, val) per step, then a scatter
# ---------------------------------------------------------------------------

def decode_streams_plain(dev: Dev, meta: Dev, entry: DecodeState, *,
                         s_max: int, min_code_bits: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(pos, val)``, each (s_max, C) int32: step ``i`` of a lane wrote
    ``val[i]`` at local offset ``pos[i]``, or nothing where ``pos`` is -1
    (then ``val`` is 0)."""
    words64 = D.widen_words(dev["words"])
    st = DecodeState(entry.p, entry.u, entry.z, torch.zeros_like(entry.p))
    pos, val = [], []
    for _ in range(s_max):
        o = D.decode_symbol(words64, dev["luts"], dev["unit_lut_row"], st,
                            meta["word_base"], meta["limit"], meta["ts"],
                            meta["upm"], min_code_bits)
        rec = o.active & ~o.invalid
        pos.append(torch.where(rec, st.n + o.run, -1))
        val.append(torch.where(rec, o.coef, 0))
        st = o.state
    return torch.stack(pos), torch.stack(val)


def decode_streams(dev: Dev, meta: Dev, entry: DecodeState, *, s_max: int,
                   min_code_bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`decode_streams_plain`, by the stream kernel on the card."""
    if dev["words"].device.type == "cpu":
        return decode_streams_plain(dev, meta, entry, s_max=s_max,
                                    min_code_bits=min_code_bits)
    args = lane_args(dev, meta, entry)
    c = entry.p.shape[0]
    pos = torch.empty((s_max, c), dtype=torch.int32, device=entry.p.device)
    val = torch.empty_like(pos)
    B.check(kernel_fn("rt_decode_streams")(
        *args, B.ptr(pos), B.ptr(val), c, s_max, min_code_bits,
        B.stream_of(pos)), "rt_decode_streams")
    decode_streams.launches += 1
    return pos, val


decode_streams.launches = 0


def scatter_streams(pos: torch.Tensor, val: torch.Tensor,
                    write_base: torch.Tensor, write_max: torch.Tensor,
                    n_coef: int) -> torch.Tensor:
    """Place the streams: ``out[write_base + pos] = val`` where ``pos >= 0``
    and the target is within the lane's clamp ``write_max``.

    Targets are unique by construction (positions strictly increase within
    a lane; lanes own disjoint ranges), and every dropped write goes to one
    sentinel slot past the end that is sliced off.
    """
    tgt = write_base[None, :].to(torch.int64) + pos
    ok = (pos >= 0) & (tgt <= write_max[None, :])
    tgt = torch.where(ok, tgt, n_coef)
    out = torch.zeros(n_coef + 1, dtype=torch.int32, device=pos.device)
    out[tgt.reshape(-1)] = val.reshape(-1)
    return out[:n_coef]


def decode_coeffs(dev: Dev, meta: Dev, entry: DecodeState,
                  write_base: torch.Tensor, write_max: torch.Tensor,
                  n_coef: int, *, s_max: int,
                  min_code_bits: int) -> torch.Tensor:
    """The ``fuse="post"`` write pass: streams, then the scatter."""
    pos, val = decode_streams(dev, meta, entry, s_max=s_max,
                              min_code_bits=min_code_bits)
    return scatter_streams(pos, val, write_base, write_max, n_coef)
