"""Decoder synchronization — the Jacobi schedule of the paper's Algorithm 3.

A port of ``chain_entries`` and ``jacobi_sync`` from the JAX package's
``core/sync.py``: iterate ``exit[i] <- decode(i, entry=exit[chunk_prev[i]])``
over *all* chunks in parallel until a fixed point. Self-synchronization
bounds the number of rounds by the longest sync distance in chunks;
convergence is checked on the full state, so the result is the exact
sequential parse by construction.

The schedule takes its decode primitive as a ``decode_exits(dev, entry)``
callable, so the plain decoder and the exit kernel
(``repro_torch.kernels.huffman.ops``) plug in alike. The loop is a Python
loop with one host check per round.

Padded lanes: inert lanes (start == limit, chunk_first, self-chained)
decode nothing and are a fixed point from round zero, so the round bound
may be a *capacity* rather than an actual count.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch

from .state import DecodeState

# fn(dev, entry) -> exit DecodeState for every lane
DecodeExitsFn = Callable[[Dict[str, torch.Tensor], DecodeState], DecodeState]


class SyncResult(NamedTuple):
    exits: DecodeState     # fixed-point exit state of every chunk
    rounds: int            # number of full decode rounds executed
    converged: bool


def _shift_one(a: torch.Tensor) -> torch.Tensor:
    return torch.cat([a[:1], a[:-1]])


def chain_entries(dev: Dict[str, torch.Tensor], exits: DecodeState,
                  permuted: bool = True) -> DecodeState:
    """entry[i] = exit[chunk_prev[i]]; segment-first chunks get the cold state.

    Chain adjacency is the explicit ``chunk_prev`` lane graph, not
    positional order (inert padding lanes are their own predecessor and
    marked ``chunk_first``, so they stay cold). ``permuted=False`` is the
    form for identity plans, where the predecessor gather is a shift.
    """
    if permuted:
        prev_idx = dev["chunk_prev"].to(torch.int64)
        prev = DecodeState(*(f[prev_idx] for f in exits))
    else:
        prev = DecodeState(*(_shift_one(f) for f in exits))
    cold = DecodeState.cold(dev["chunk_start"])
    return cold.select(dev["chunk_first"], prev)


def states_equal(a: DecodeState, b: DecodeState) -> bool:
    """Whether two lane states agree everywhere (one host sync)."""
    return bool(torch.all(a.puz_equal(b) & (a.n == b.n)))


def jacobi_sync(dev: Dict[str, torch.Tensor], *, max_rounds: int,
                decode_exits: DecodeExitsFn,
                permuted: bool = True) -> SyncResult:
    """The cold speculative pass, then Jacobi rounds to the fixed point.

    ``rounds`` counts the cold pass as round 1, and the loop stops at
    ``max_rounds`` whether or not it converged, as in the JAX package.
    """
    exits = decode_exits(dev, DecodeState.cold(dev["chunk_start"]))
    rounds, done = 1, False
    while not done and rounds < max_rounds:
        new = decode_exits(dev, chain_entries(dev, exits, permuted))
        done = states_equal(new, exits)
        exits, rounds = new, rounds + 1
    return SyncResult(exits, rounds, done)
