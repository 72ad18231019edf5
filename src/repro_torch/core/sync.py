"""Decoder synchronization: the paper's Algorithm 3 and two variants.

A port of the JAX package's ``core/sync.py``. Three schedules run over
the same decode primitive:

* :func:`jacobi_sync`: iterate
  ``exit[i] <- decode(i, entry=exit[chunk_prev[i]])`` over *all* chunks
  in parallel until a fixed point. Self-synchronization
  bounds the number of rounds by the longest sync distance in chunks;
  convergence is checked on the full state, so the result is the exact
  sequential parse by construction.
* :func:`faithful_sync`: the paper's own two-level schedule. A cold
  speculative decode of every chunk, then intra-sequence chains (one per
  chunk, bounded by the sequence extent), then inter-sequence chains (one
  per sequence boundary) repeated by an outer loop until every boundary
  is synced, then (``verify=True``) Jacobi rounds to the true fixed point.
* :func:`specmap_sync`: decode every chunk once per MCU-phase hypothesis,
  compose the per-chunk phase maps with a prefix scan, and verify with
  Jacobi rounds.

All three return bit-identical exit states, and the same ``rounds`` as the
JAX package. Each takes its decode primitive as a
``decode_exits(dev, entry, idx=None)`` callable (``idx``: decode only the
lanes ``idx``, one per entry), so the plain decoder and the exit kernel
(``repro_torch.kernels.huffman.ops``) plug in alike.

The loops are Python loops; each loop test that reads the device is one
host check, counted in :func:`host_check`. Three details differ from
JAX: masked scatters write their dropped lanes to one sentinel slot past
the end (torch has no ``mode="drop"``), the phase-map prefix is a
log-step doubling scan (torch has no ``associative_scan``), and loop
counters are Python ints.

Padded lanes: inert lanes (start == limit, chunk_first, chunk_seq == -1,
self-chained) decode nothing and are a fixed point from round zero, and
pad sequence slots point at a segment's final chunk, which never needs
syncing, so every loop bound may be a *capacity* rather than an actual
count.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch

from .decode import chunk_meta
from .state import DecodeState

Dev = Dict[str, torch.Tensor]
# fn(dev, entry, idx=None) -> exit DecodeState for every lane (or idx subset)
DecodeExitsFn = Callable[..., DecodeState]


class SyncResult(NamedTuple):
    exits: DecodeState     # fixed-point exit state of every chunk
    rounds: int            # number of full decode rounds executed
    converged: bool


def host_check(flag: torch.Tensor) -> bool:
    """The value of a one-element bool tensor on the host: one device sync,
    counted in ``host_check.count``."""
    host_check.count += 1
    return bool(flag)


host_check.count = 0


def _shift_one(a: torch.Tensor) -> torch.Tensor:
    return torch.cat([a[:1], a[:-1]])


def _gather(st: DecodeState, idx: torch.Tensor) -> DecodeState:
    return DecodeState(*(f[idx] for f in st))


def _scatter_where(st: DecodeState, idx: torch.Tensor, new: DecodeState,
                   ok: torch.Tensor) -> DecodeState:
    """``st`` with ``st[idx[i]] = new[i]`` where ``ok[i]``.

    The masked lanes write to one sentinel slot past the end (never -1:
    negative indices wrap), which is sliced off. The unmasked targets are
    unique (``chunk_next`` is injective except on its self-loops, which
    the callers mask), so only the sentinel takes repeated writes.
    """
    c = st.p.shape[0]
    tgt = torch.where(ok, idx, c)
    out = []
    for f, v in zip(st, new):
        buf = torch.cat([f, f.new_zeros(1)])
        buf[tgt] = v
        out.append(buf[:c])
    return DecodeState(*out)


def chain_entries(dev: Dev, exits: DecodeState,
                  permuted: bool = True) -> DecodeState:
    """entry[i] = exit[chunk_prev[i]]; segment-first chunks get the cold state.

    Chain adjacency is the explicit ``chunk_prev`` lane graph, not
    positional order (inert padding lanes are their own predecessor and
    marked ``chunk_first``, so they stay cold). ``permuted=False`` is the
    form for identity plans, where the predecessor gather is a shift.
    """
    if permuted:
        prev = _gather(exits, dev["chunk_prev"].to(torch.int64))
    else:
        prev = DecodeState(*(_shift_one(f) for f in exits))
    cold = DecodeState.cold(dev["chunk_start"])
    return cold.select(dev["chunk_first"], prev)


def states_equal(a: DecodeState, b: DecodeState) -> bool:
    """Whether two lane states agree everywhere (one host check)."""
    return host_check(torch.all(a.puz_equal(b) & (a.n == b.n)))


def _verify(dev: Dev, exits: DecodeState, rounds: int, max_rounds: int,
            decode_exits: DecodeExitsFn, permuted: bool) -> SyncResult:
    """Jacobi rounds from ``exits`` to the fixed point, while
    ``rounds < max_rounds``; each round counts."""
    done = False
    while not done and rounds < max_rounds:
        new = decode_exits(dev, chain_entries(dev, exits, permuted))
        done = states_equal(new, exits)
        exits, rounds = new, rounds + 1
    return SyncResult(exits, rounds, done)


# ---------------------------------------------------------------------------
# Jacobi (bulk-synchronous) schedule
# ---------------------------------------------------------------------------

def jacobi_sync(dev: Dev, *, max_rounds: int, decode_exits: DecodeExitsFn,
                permuted: bool = True) -> SyncResult:
    """The cold speculative pass, then Jacobi rounds to the fixed point.

    ``rounds`` counts the cold pass as round 1, and the loop stops at
    ``max_rounds`` whether or not it converged, as in the JAX package.
    """
    exits = decode_exits(dev, DecodeState.cold(dev["chunk_start"]))
    return _verify(dev, exits, 1, max_rounds, decode_exits, permuted)


# ---------------------------------------------------------------------------
# Beyond-paper: phase-speculative map composition ("specmap")
# ---------------------------------------------------------------------------
#
# Round counts of Jacobi and faithful on high-quality images are dominated
# by MCU-phase desynchronization: the bit position and zig-zag index
# self-synchronize within one chunk, but the unit index u a cold start
# guesses (0) is off by a constant, and the truth propagates one chunk per
# round. specmap decodes every chunk once per phase hypothesis u0, so each
# chunk is summarized by a map u_entry -> u_exit; the maps compose
# associatively, and a prefix scan resolves every entry phase at once.
# Verification rounds repair the rare chunks whose hypotheses did not
# collapse in (p, z) and certify the exact sequential parse.

def compose_prefix(maps: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix of phase maps along the chunk axis.

    ``maps`` is (H, C) int64, column ``i`` the map ``h -> maps[h, i]`` of
    chunk ``i``; column ``i`` of the result is ``m_i o ... o m_0``. A
    log-step (Hillis-Steele) doubling scan: at distance ``d`` each column
    ``i >= d`` becomes ``prev[:, i][prev[:, i - d]]``, a gather along the
    hypothesis axis. Composition is associative and exact, so this equals
    JAX's ``associative_scan`` bit for bit.
    """
    out, d = maps, 1
    while d < out.shape[1]:
        nxt = out.clone()
        nxt[:, d:] = torch.gather(out[:, d:], 0, out[:, :-d])
        out, d = nxt, 2 * d
    return out


def specmap_sync(dev: Dev, *, max_upm: int, max_verify: int,
                 decode_exits: DecodeExitsFn,
                 permuted: bool = True) -> SyncResult:
    """Hypothesis decodes, phase-map prefix, then verification rounds.

    The ``max_upm`` hypothesis decodes count as rounds, so verification
    starts at round ``max_upm`` and ``max_verify`` bounds the total.
    """
    upm = chunk_meta(dev)["upm"]
    zero = torch.zeros_like(dev["chunk_start"])
    hyp = [decode_exits(dev, DecodeState(dev["chunk_start"],
                                         (upm - 1).clamp(max=u0), zero, zero))
           for u0 in range(max_upm)]
    ep, eu, ez, en = (torch.stack(f) for f in zip(*hyp))  # (H, C) each

    # segment-first chunks re-anchor: their entry phase is 0 whatever the
    # prefix, so their map is the constant exit-u of hypothesis 0
    first = dev["chunk_first"]
    maps = torch.where(first[None, :], eu[:1].expand_as(eu), eu)
    # the scan runs in bitstream chunk order; inert padding chunks order
    # after every real chunk and are segment-firsts (constant maps)
    if permuted:
        order = dev["chunk_order"].to(torch.int64)
        first_o, maps_o = first[order], maps[:, order]
    else:
        first_o, maps_o = first, maps
    prefix = compose_prefix(maps_o.to(torch.int64))
    # entry phase of chunk i: the composed map of chunks before it, at 0
    entry_o = torch.cat([prefix.new_zeros(1), prefix[0, :-1]])
    entry_o = torch.where(first_o, 0, entry_o)
    entry_u = entry_o[dev["lane_perm"].to(torch.int64)] if permuted \
        else entry_o

    def sel(arr):
        return torch.gather(arr, 0, entry_u[None, :])[0]

    exits = DecodeState(sel(ep), sel(eu), sel(ez), sel(en))
    return _verify(dev, exits, max_upm, max_verify, decode_exits, permuted)


# ---------------------------------------------------------------------------
# Paper-faithful two-level schedule (Algorithm 3)
# ---------------------------------------------------------------------------

def faithful_sync(dev: Dev, *, seq_chunks: int, max_outer: int,
                  decode_exits: DecodeExitsFn, verify: bool = True,
                  permuted: bool = True) -> SyncResult:
    """Paper Algorithm 3, plus an optional verification fixed-point pass.

    The paper's schedule can stop with stale exits when a chain dies on a
    spurious match (two desynchronized parses that agree at a chunk end);
    ``verify=True`` appends Jacobi rounds, one in the common case, which
    guarantee the exact sequential parse. ``verify=False`` runs the
    paper's raw schedule, and ``converged`` then says whether every
    sequence boundary was synced.
    """
    c = dev["chunk_seg"].shape[0]
    nxt_of = dev["chunk_next"].to(torch.int64)
    chunk_seq = dev["chunk_seq"]

    def step(tgt):
        """Advance chain targets one chunk along the segment chain; a lane
        with no successor maps to itself, which the mask marks dead."""
        nxt = nxt_of[tgt]
        return nxt, nxt != tgt

    # ---- Phase 0: speculative cold decode of every chunk ------------------
    s_info = decode_exits(dev, DecodeState.cold(dev["chunk_start"]))
    rounds = 1

    # ---- Phase 1: intra-sequence chains (lockstep rounds) -----------------
    chain = s_info
    alive = torch.ones(c, dtype=torch.bool, device=chunk_seq.device)
    tgt = torch.arange(c, device=chunk_seq.device)
    t = 1
    while t < seq_chunks and host_check(alive.any()):
        tgt, has = step(tgt)
        valid = alive & has & (chunk_seq[tgt] == chunk_seq)  # same sequence
        new = decode_exits(dev, chain, tgt)
        synced = new.puz_equal(_gather(s_info, tgt))
        s_info = _scatter_where(s_info, tgt, new, valid)
        chain, alive = new, valid & ~synced
        t, rounds = t + 1, rounds + 1

    # ---- Phase 2: inter-sequence chains, outer loop ------------------------
    roots = dev["seq_last_chunk"].to(torch.int64)
    root_seq = chunk_seq[roots]
    # a boundary needs syncing only if the next chunk continues the same
    # segment (chunk_next never crosses a segment boundary)
    seq_synced = nxt_of[roots] == roots
    outer = 0
    while outer < max_outer and host_check(~seq_synced.all()):
        chain = _gather(s_info, roots)
        alive, found = ~seq_synced, torch.zeros_like(seq_synced)
        tgt, t = roots, 1
        while t <= seq_chunks and host_check(alive.any()):
            tgt, has = step(tgt)
            valid = alive & has & (chunk_seq[tgt] == root_seq + 1)
            new = decode_exits(dev, chain, tgt)
            synced = new.puz_equal(_gather(s_info, tgt))
            s_info = _scatter_where(s_info, tgt, new, valid)
            found = found | (valid & synced)
            chain, alive = new, valid & ~synced
            t, rounds = t + 1, rounds + 1
        # only boundaries whose chain found a sync point are done; the
        # others retry in the next outer round with the corrected s_info
        seq_synced = seq_synced | found
        outer += 1
    if not verify:
        return SyncResult(s_info, rounds, host_check(seq_synced.all()))

    # ---- Verification: the chain recurrence to its true fixed point -------
    return _verify(dev, s_info, rounds, rounds + c + 2, decode_exits,
                   permuted)
