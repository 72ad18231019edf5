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
lanes ``idx``, one per entry; ``out=``, a state to write the exits
into, when the caller passes ``bufs``), so the plain decoder and the exit
kernel (``repro_torch.kernels.huffman.ops``) plug in alike.

JAX runs each loop as one ``lax.while_loop`` on the device. Here a loop
launches its iterations in blocks (:class:`RoundBlocks`), with no host
read inside a block: the loop's condition and its round counter stay on
the device (an iteration adds 1 to the counter only while the condition
held when it started), and one host check (:func:`host_check`) after each
block reads them. An iteration launched after the condition failed
changes nothing: past the fixed point a round reproduces the same exits,
and a chain step with no lane alive scatters nothing. The host counts the
iterations it launched and never passes the JAX package's bound, so the
exits, ``rounds`` and ``converged`` are the JAX package's, also for a
batch that does not converge. A loop's first block takes the iterations
that loop needed in the previous decode of the same program (the
``hints`` that ``core.api.DecodeProgram`` keeps), later blocks
``BLOCK_ROUNDS``; a warm decode then makes one host check a loop. On the
card the Jacobi rounds (jacobi's loop and every schedule's verification)
can replay as CUDA graphs of two rounds over a program's buffers
(``RoundBlocks.graphs``), so that the card does not wait for the host to
enqueue each round's small ops.

Two more details differ from JAX: masked scatters write their dropped
lanes to one sentinel slot past the end (torch has no ``mode="drop"``),
and the phase-map prefix is a log-step doubling scan (torch has no
``associative_scan``).

Padded lanes: inert lanes (start == limit, chunk_first, chunk_seq == -1,
self-chained) decode nothing and are a fixed point from round zero, and
pad sequence slots point at a segment's final chunk, which never needs
syncing, so every loop bound may be a *capacity* rather than an actual
count.
"""
from __future__ import annotations

from typing import (Callable, Dict, List, NamedTuple, Optional, Protocol,
                    Tuple)

import torch

from .bitstream import MAX_UPM
from .decode import chunk_meta
from .state import DecodeState

Dev = Dict[str, torch.Tensor]
# fn(dev, entry, idx=None) -> exit DecodeState for every lane (or idx subset)
DecodeExitsFn = Callable[..., DecodeState]
# two exit states the full-lane rounds write in turn (core.api.DecodeProgram)
ExitBuffers = Optional[Tuple[DecodeState, DecodeState]]
# the verify loop's device scalars: done (bool) and its round count (int32)
Flags = Optional[Tuple[torch.Tensor, torch.Tensor]]

# iterations a loop launches between two host checks, after its first block
BLOCK_ROUNDS = 4


class SyncResult(NamedTuple):
    exits: DecodeState     # fixed-point exit state of every chunk
    rounds: int            # number of full decode rounds executed
    converged: bool


def host_check(*values: torch.Tensor) -> List[int]:
    """The values of one-element tensors on the host, as ints: one device
    sync (one per device the values lie on, for a mesh decode's blocks),
    counted once in ``host_check.count``."""
    host_check.count += 1
    out: List[int] = [0] * len(values)
    by_device: Dict[torch.device, List[int]] = {}
    for i, v in enumerate(values):
        by_device.setdefault(v.device, []).append(i)
    for idx in by_device.values():
        got = torch.stack([values[i].reshape(()).to(torch.int64)
                           for i in idx]).tolist()
        for i, x in zip(idx, got):
            out[i] = x
    return out


host_check.count = 0


class RoundBlocks:
    """How a schedule's loops launch their iterations: in blocks, with one
    host check after each.

    A loop's first block takes ``hints[name]`` iterations, what that loop
    needed in the previous decode that shared ``hints`` (``size`` without
    one); later blocks take ``size``. Each loop writes its count back.
    ``checks`` counts this decode's host checks. ``size=1`` with no hints
    is the per-round form: a check after every iteration. ``graphs``, a
    program's cache of CUDA graphs, lets the Jacobi rounds replay two at
    a time (:func:`_verify`). ``audit`` (None but in the traced-program
    checker, ``analysis/trace_check.py``) is told of each graph captured
    and each replay, and may refuse a replay by raising
    (:func:`_graph_pairs`).
    """

    def __init__(self, size: int = BLOCK_ROUNDS,
                 hints: Optional[Dict[str, int]] = None,
                 graphs: Optional[Dict[Tuple, object]] = None,
                 audit: Optional["GraphAudit"] = None):
        if size < 1:
            raise ValueError(f"block size must be at least 1, got {size}")
        self.size = size
        self.hints = {} if hints is None else hints
        self.graphs = graphs
        self.audit = audit
        self.checks = 0
        self.replays = 0

    def read(self, *values: torch.Tensor) -> List[int]:
        self.checks += 1
        return host_check(*values)

    def loop(self, name: str, body: Callable[[], None],
             read: Callable[[], Tuple[torch.Tensor, ...]], limit: int,
             run: Optional[Callable[[int], None]] = None,
             combine: Optional[Callable[[List[int], int], Tuple]] = None
             ) -> List[int]:
        """Launch ``body()`` at most ``limit`` times, in blocks.

        ``body`` is one iteration, written so that an iteration launched
        after the loop's condition failed changes nothing and counts
        nothing. ``read()`` gives device scalars: the loop's count of
        iterations, whether it goes on, then any others the caller needs.
        After each block one host check reads them; the loop ends when its
        condition failed or ``limit`` iterations were launched. Returns
        the last values read (one read and no iteration when ``limit`` is
        0). ``run(n)``, where given, launches ``n`` iterations in place of
        ``n`` calls of ``body``. ``combine(values, launched)``, where
        given, turns the values read into those (a mesh decode reads each
        block's scalars at one check and combines them on the host).
        """
        launched, n = 0, self.hints.get(name, self.size)
        while True:
            n = max(0, min(max(n, 1), limit - launched))
            if run is not None:
                run(n)
            else:
                for _ in range(n):
                    body()
            launched += n
            vals = self.read(*read())
            if combine is not None:
                vals = combine(vals, launched)
            if not vals[1] or launched >= limit:
                break
            n = self.size
        self.hints[name] = vals[0]
        return vals


class SyncLimits(NamedTuple):
    """The bounds the JAX package gives the schedules' loops. Every bound
    is a capacity: inert lanes are stable from round 0."""
    jacobi: int      # rounds, the cold pass counted as round 1
    specmap: int     # rounds, the hypothesis decodes counted as rounds
    verify: int      # faithful's verification rounds past its chains
    outer: int       # faithful's outer rounds
    intra: int       # faithful's intra-sequence chain rounds
    inter: int       # the inter-sequence chain rounds of an outer round


def sync_limits(shape) -> SyncLimits:
    """The loop bounds of a padded plan's ``PlanShape``: specmap's verify
    budget adds its hypothesis decodes to the longest truth-propagation
    chain."""
    c = shape.n_chunks
    return SyncLimits(jacobi=c + 2, specmap=c + MAX_UPM + 2, verify=c + 2,
                      outer=shape.n_sequences + 2,
                      intra=shape.seq_chunks - 1, inter=shape.seq_chunks)


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


def states_equal(a: DecodeState, b: DecodeState) -> torch.Tensor:
    """Whether two lane states agree everywhere, as a device bool."""
    return torch.all(a.puz_equal(b) & (a.n == b.n))


def _full_decode(decode_exits: DecodeExitsFn, dev: Dev, entry: DecodeState,
                 bufs: ExitBuffers, busy: Optional[DecodeState] = None
                 ) -> DecodeState:
    """A full-lane decode, into whichever of ``bufs`` does not hold
    ``busy`` (a fresh state without buffers)."""
    if bufs is None:
        return decode_exits(dev, entry)
    out = bufs[1] if busy is not None and busy.p is bufs[0].p else bufs[0]
    return decode_exits(dev, entry, out=out)


class GraphAudit(Protocol):
    """What :func:`_graph_pairs` tells an audit (``RoundBlocks.audit``)."""

    def captured(self, key: Tuple, graph) -> None:
        """A graph was captured (with ``keep_graph=True``) and
        instantiated under ``key``; the program's buffers are those it
        read."""

    def replaying(self, key: Tuple, graph) -> None:
        """``graph`` is about to replay; raising stops the replay."""

    def replayed(self, key: Tuple, exits: DecodeState) -> None:
        """The graph of ``key`` replayed, leaving the exits in ``exits``."""


_CAPTURE_STREAMS: Dict[torch.device, object] = {}


def capture_stream(device: torch.device):
    """The stream graphs of ``device`` are captured on. Capture runs on a
    side stream, which sets the current device to its own: the one
    ``torch.cuda.graph`` keeps for all captures lies on the first device
    that captured, so each card gets its own."""
    stream = _CAPTURE_STREAMS.get(device)
    if stream is None:
        stream = _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return stream


def _graph_pairs(body: Callable[[], None], st: Dict, bufs: ExitBuffers,
                 blocks: "RoundBlocks", key: Tuple) -> Callable[[int], None]:
    """``run(n)`` for :meth:`RoundBlocks.loop`: ``n // 2`` replays of a
    CUDA graph of two rounds, then one round eagerly for an odd ``n``.

    Two rounds go from one of ``bufs`` through the other and back, so the
    graph of each starting buffer (captured at its first use, ``key``
    adding what else its launches read) leaves the exits where it found
    them. The graph reads and writes only buffers that keep their
    addresses: the program's plan buffers, metadata, ``bufs`` and flags,
    and the compact tables in ``key``. A replay runs the kernels without
    their wrappers, so it adds to ``blocks.replays``, not to the wrappers'
    launch counts. With ``blocks.audit`` the graph is kept after capture
    (``keep_graph=True``) so that the audit can read it, and the audit
    sees every capture and replay.
    """
    graphs, audit = blocks.graphs, blocks.audit

    def run(n: int) -> None:
        for _ in range(n // 2):
            side = 0 if st["exits"].p is bufs[0].p else 1
            graph = graphs.get(key + (side,))
            if graph is None:
                for old in [k for k in graphs if k[:-1] != key]:
                    del graphs[old]  # read compact tables of the past
                graph = torch.cuda.CUDAGraph(keep_graph=audit is not None)
                # thread_local: the decode service's other threads may pin
                # and copy memory meanwhile
                with torch.cuda.graph(graph,
                                      stream=capture_stream(bufs[0].p.device),
                                      capture_error_mode="thread_local"):
                    body()
                    body()
                graphs[key + (side,)] = graph
                if audit is not None:
                    graph.instantiate()
                    audit.captured(key + (side,), graph)
            if audit is not None:
                audit.replaying(key + (side,), graph)
            blocks.replays += 1
            graph.replay()
            if audit is not None:
                audit.replayed(key + (side,), st["exits"])
        if n % 2:
            body()
    return run


def _verify(dev: Dev, exits: DecodeState, rounds: int, max_rounds: int,
            decode_exits: DecodeExitsFn, permuted: bool, blocks: RoundBlocks,
            name: str, bufs: ExitBuffers = None,
            flags: Flags = None) -> SyncResult:
    """Jacobi rounds from ``exits`` to the fixed point, while
    ``rounds < max_rounds``; each round counts. ``flags`` are the done
    flag and round count to use (zeroed here), fresh ones without."""
    graphed = blocks.graphs is not None and None not in (bufs, flags)
    if flags is None:
        flags = (torch.zeros((), dtype=torch.bool, device=exits.p.device),
                 torch.zeros((), dtype=torch.int32, device=exits.p.device))
    done, count = flags
    done.zero_()
    count.zero_()
    if graphed and exits.p is not bufs[0].p and exits.p is not bufs[1].p:
        for o, v in zip(bufs[0], exits):
            o.copy_(v)
        exits = bufs[0]
    st = {"exits": exits}

    def body():
        old = st["exits"]
        new = _full_decode(decode_exits, dev,
                           chain_entries(dev, old, permuted), bufs, old)
        count.add_(~done)
        done.logical_or_(states_equal(new, old))
        st["exits"] = new

    run = None
    if graphed:
        tab = dev.get("luts_compact")
        key = (None if tab is None else (tab.data_ptr(), tab.numel()),)
        run = _graph_pairs(body, st, bufs, blocks, key)
    n, going = blocks.loop(name, body, lambda: (count, ~done),
                           max_rounds - rounds, run)
    return SyncResult(st["exits"], rounds + n, not going)


# ---------------------------------------------------------------------------
# Jacobi (bulk-synchronous) schedule
# ---------------------------------------------------------------------------

def jacobi_sync(dev: Dev, *, max_rounds: int, decode_exits: DecodeExitsFn,
                permuted: bool = True, blocks: Optional[RoundBlocks] = None,
                bufs: ExitBuffers = None, flags: Flags = None) -> SyncResult:
    """The cold speculative pass, then Jacobi rounds to the fixed point.

    ``rounds`` counts the cold pass as round 1, and the loop stops at
    ``max_rounds`` whether or not it converged, as in the JAX package.
    """
    exits = _full_decode(decode_exits, dev,
                         DecodeState.cold(dev["chunk_start"]), bufs)
    return _verify(dev, exits, 1, max_rounds, decode_exits, permuted,
                   blocks or RoundBlocks(), "jacobi", bufs, flags)


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


def phase_maps(eu: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """The (H, C) phase maps of lanes from their exit phases under each
    hypothesis: segment-first chunks re-anchor (their entry phase is 0
    whatever the prefix), so their map is the constant exit-u of
    hypothesis 0."""
    return torch.where(first[None, :], eu[:1].expand_as(eu), eu)


def entry_phases(maps: torch.Tensor, first: torch.Tensor,
                 order: Optional[torch.Tensor]) -> torch.Tensor:
    """Each chunk's entry phase in bitstream order, from every lane's
    phase map (``maps``, (H, C) in lane order) and ``chunk_first``: the
    composed map of the chunks before it, at 0. The scan runs in
    bitstream chunk order (``order``, ``chunk_order``; None for an
    identity plan); inert padding chunks order after every real chunk and
    are segment-firsts (constant maps)."""
    if order is not None:
        order = order.to(torch.int64)
        first, maps = first[order], maps[:, order]
    prefix = compose_prefix(maps.to(torch.int64))
    entry = torch.cat([prefix.new_zeros(1), prefix[0, :-1]])
    return torch.where(first, 0, entry)


def specmap_sync(dev: Dev, *, max_upm: int, max_verify: int,
                 decode_exits: DecodeExitsFn, permuted: bool = True,
                 blocks: Optional[RoundBlocks] = None,
                 bufs: ExitBuffers = None, flags: Flags = None
                 ) -> SyncResult:
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

    first = dev["chunk_first"]
    entry_o = entry_phases(phase_maps(eu, first), first,
                           dev["chunk_order"] if permuted else None)
    entry_u = entry_o[dev["lane_perm"].to(torch.int64)] if permuted \
        else entry_o

    def sel(arr):
        return torch.gather(arr, 0, entry_u[None, :])[0]

    exits = DecodeState(sel(ep), sel(eu), sel(ez), sel(en))
    return _verify(dev, exits, max_upm, max_verify, decode_exits, permuted,
                   blocks or RoundBlocks(), "specmap", bufs, flags)


# ---------------------------------------------------------------------------
# Paper-faithful two-level schedule (Algorithm 3)
# ---------------------------------------------------------------------------

def faithful_sync(dev: Dev, *, seq_chunks: int, max_outer: int,
                  decode_exits: DecodeExitsFn, verify: bool = True,
                  permuted: bool = True,
                  blocks: Optional[RoundBlocks] = None,
                  bufs: ExitBuffers = None, flags: Flags = None
                  ) -> SyncResult:
    """Paper Algorithm 3, plus an optional verification fixed-point pass.

    The paper's schedule can stop with stale exits when a chain dies on a
    spurious match (two desynchronized parses that agree at a chunk end);
    ``verify=True`` appends Jacobi rounds, one in the common case, which
    guarantee the exact sequential parse. ``verify=False`` runs the
    paper's raw schedule, and ``converged`` then says whether every
    sequence boundary was synced.

    Each chain loop's condition, "a lane is alive", and its round count
    stay on the device; the check after the intra-sequence loop's last
    block also reads whether every boundary is synced (the outer loop's
    first test), and the check after an inner loop's last block whether
    every boundary is synced after it (the outer loop's next test).
    """
    blocks = blocks or RoundBlocks()
    c = dev["chunk_seg"].shape[0]
    nxt_of = dev["chunk_next"].to(torch.int64)
    chunk_seq = dev["chunk_seq"]
    device = chunk_seq.device

    def step(tgt):
        """Advance chain targets one chunk along the segment chain; a lane
        with no successor maps to itself, which the mask marks dead."""
        nxt = nxt_of[tgt]
        return nxt, nxt != tgt

    # ---- Phase 0: speculative cold decode of every chunk ------------------
    s_info = _full_decode(decode_exits, dev,
                          DecodeState.cold(dev["chunk_start"]), bufs)
    st = {"s_info": s_info, "chain": s_info,
          "alive": torch.ones(c, dtype=torch.bool, device=device),
          "tgt": torch.arange(c, device=device)}
    roots = dev["seq_last_chunk"].to(torch.int64)
    root_seq = chunk_seq[roots]
    # a boundary needs syncing only if the next chunk continues the same
    # segment (chunk_next never crosses a segment boundary)
    seq_synced = nxt_of[roots] == roots

    def chain_step(seq_ok):
        """One lockstep round of chains; ``seq_ok(tgt)`` says where a chain
        may go. Returns whether any lane was alive when it started, and
        the lanes whose chain found a sync point."""
        alive = st["alive"]
        act = alive.any()
        tgt, has = step(st["tgt"])
        valid = alive & has & seq_ok(tgt)
        new = decode_exits(dev, st["chain"], tgt)
        synced = new.puz_equal(_gather(st["s_info"], tgt))
        st["s_info"] = _scatter_where(st["s_info"], tgt, new, valid)
        st.update(chain=new, alive=valid & ~synced, tgt=tgt)
        return act, valid & synced

    # ---- Phase 1: intra-sequence chains (lockstep rounds) -----------------
    count = torch.zeros((), dtype=torch.int32, device=device)

    def intra():
        act, _ = chain_step(lambda tgt: chunk_seq[tgt] == chunk_seq)
        count.add_(act)

    n, _, all_synced = blocks.loop(
        "intra", intra, lambda: (count, st["alive"].any(), seq_synced.all()),
        seq_chunks - 1)
    rounds = 1 + n

    # ---- Phase 2: inter-sequence chains, outer loop ------------------------
    outer = 0
    while outer < max_outer and not all_synced:
        st.update(chain=_gather(st["s_info"], roots), alive=~seq_synced,
                  tgt=roots)
        found = torch.zeros_like(seq_synced)
        count = torch.zeros((), dtype=torch.int32, device=device)

        def inter():
            act, hit = chain_step(lambda tgt: chunk_seq[tgt] == root_seq + 1)
            found.logical_or_(hit)
            count.add_(act)

        # only boundaries whose chain found a sync point are done; the
        # others retry in the next outer round with the corrected s_info
        n, _, all_synced = blocks.loop(
            f"inter{outer}", inter,
            lambda: (count, st["alive"].any(), (seq_synced | found).all()),
            seq_chunks)
        seq_synced = seq_synced | found
        rounds += n
        outer += 1
    blocks.hints["outer"] = outer
    if not verify:
        return SyncResult(st["s_info"], rounds, bool(all_synced))

    # ---- Verification: the chain recurrence to its true fixed point -------
    return _verify(dev, st["s_info"], rounds, rounds + c + 2, decode_exits,
                   permuted, blocks, "verify", bufs, flags)
