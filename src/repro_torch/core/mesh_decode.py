"""One batch decoded with its chunk lanes split over a mesh (ROADMAP A9b).

The port of the JAX package's ``ParallelDecoder.decode_on``. Where the
JAX package shards its lane arrays over the mesh's data axis and lets the
SPMD partitioner place the work, each entry of a
:class:`~repro_torch.launch.mesh.Mesh` here runs one contiguous *block*
of the padded plan's lanes (``dist.plan.mesh_layout``), under
``torch.cuda.device`` of its card, with the same kernels as ``decode()``:

* **The sync.** Each block keeps its lanes' states and a *halo*: the
  states of the lanes of other blocks its lanes chain from (the edge
  list). A Jacobi round decodes every block's lanes from their entries;
  each block then gathers the edge states the others read into a send
  buffer, and a copy puts them in the reader's halo (a peer copy between
  cards, a local copy between blocks of one card). Rounds stay global
  and bulk-synchronous: a round's fixed-point test is the AND of the
  blocks', read at the host check after each block of rounds (one for
  the whole mesh) from each block's last round that changed a state, so
  ``sync_rounds`` and ``converged`` are the single-card decode's. Blocks
  are cut at sequence starts, so faithful sync's chains stay in their
  block, and its inter-sequence chains start from the halo. specmap's
  phase maps are gathered to every block, which composes the prefix over
  the whole batch. From a program's second decode on, each block's round
  replays as a CUDA graph of that block's card (one round, its send
  gather included); the copies between blocks run between the replays.
* **The write pass.** A sequence writes one contiguous range of
  coefficients. The blocks' sums of their sequences' symbol counts are
  gathered on the first block, which works out every sequence's range
  and rows, and sends them to the others; one host check reads how many
  rows each block writes for each owner. Each block lays its sequences'
  rows end to end in bitstream order (a sequence's partial first and
  last rows included) and writes its lanes' coefficients there with the
  write kernels ``decode()`` chooses; the rows of each owner are one
  piece, sent there and added at its sequences' rows (sequences that
  share a row write disjoint coefficients of it).
* **Placement.** Block ``b`` owns a contiguous range of images, and so of
  coefficient rows (``BlockLayout.rows``): DC undiff (no segment spans
  two images, so no carry crosses a row range) and ``decode()``'s pixel
  stage run there. The result stays on the cards, as :class:`Sharded`
  pieces.

The output is bit-identical to ``decode()``: exits, ``sync_rounds``,
``converged``, coefficients and RGB. Nothing falls back: a card the
machine lacks raises (``launch.mesh``), and so does a kernel that fails on
one card.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import decode as D
from .bitstream import MAX_UPM
from .state import DecodeState
from .sync import (RoundBlocks, SyncLimits, capture_stream, entry_phases,
                   phase_maps, states_equal, sync_limits)
from ..dist.plan import BlockLayout, MeshLayout
from ..kernels.fused.store import write_coefficients

Dev = Dict[str, torch.Tensor]


class Sharded:
    """A tensor split along its first axis into pieces, one a block, each
    on its block's device: piece ``b`` holds rows ``offsets[b]`` to
    ``offsets[b + 1]``. :meth:`full` gives the whole tensor."""

    def __init__(self, pieces: Sequence[torch.Tensor],
                 offsets: Sequence[int]):
        self.pieces = list(pieces)
        self.offsets = tuple(int(o) for o in offsets)
        if len(self.offsets) != len(self.pieces) + 1 or any(
                p.shape[0] != b - a for p, a, b in
                zip(self.pieces, self.offsets, self.offsets[1:])):
            raise ValueError("pieces and offsets disagree")

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.offsets[-1],) + tuple(self.pieces[0].shape[1:])

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor, on ``device`` (the first piece's by
        default)."""
        device = self.pieces[0].device if device is None else device
        return torch.cat([p.to(device) for p in self.pieces])


@dataclasses.dataclass(eq=False)
class BlockProgram:
    """One block's buffers on its device: the replicated plan arrays
    (``plan``; words, tables and lane arrays, read at the block's lanes),
    the block's work buffers (``bufs``, flat, grown on demand) and the
    CUDA graphs of its rounds. ``owner`` is the decoder whose data the
    buffers hold."""
    device: torch.device
    plan: Optional[Dict[str, torch.Tensor]] = None
    bufs: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    graphs: Dict[Tuple, object] = dataclasses.field(default_factory=dict)
    owner: object = None
    stream: object = None        # the CUDA stream of the last decode
    allocations: int = 0
    uploads: int = 0

    def follow(self) -> None:
        """Order this decode after the last one when the current stream of
        the block's card differs from the last decode's."""
        if self.device.type != "cuda":
            return
        cur = torch.cuda.current_stream(self.device)
        if self.stream is not None and self.stream != cur:
            cur.wait_stream(self.stream)
        self.stream = cur

    def buf(self, name: str, n: int, dtype=torch.int32,
            graphs: bool = True) -> torch.Tensor:
        """The first ``n`` elements of the flat buffer ``name``, which is
        reallocated when shorter (dropping the graphs, which may read it,
        unless ``graphs`` is False: the write pass's buffers, sized by the
        data). A new buffer holds zeros: a state read before it is written
        is a valid one (a halo entry is always delivered before a round
        reads it)."""
        t = self.bufs.get(name)
        if t is None or t.numel() < n or t.dtype != dtype:
            t = self.bufs[name] = torch.zeros(max(n, 1), dtype=dtype,
                                              device=self.device)
            if graphs:
                self.graphs.clear()
            self.allocations += 1
        return t[:n]

    def tensors(self) -> List[torch.Tensor]:
        return [*(self.plan or {}).values(), *self.bufs.values()]


def device_ctx(dev: torch.device):
    """``torch.cuda.device(dev)`` on a card, nothing on the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


@dataclasses.dataclass(eq=False)
class _Block:
    """A block during one decode: its layout, program and device views."""
    i: int
    lay: BlockLayout
    prog: BlockProgram
    d: Dev                       # the plan's tensors on the block's device
    v: Dev                       # the block's views and layout tensors
    meta: Dev
    ext: torch.Tensor            # (2, 4, n + halo) exit states
    sends: List[Tuple[int, torch.Tensor, torch.Tensor]]
    launches: Dict[str, int]
    replays: int = 0

    @property
    def n(self) -> int:
        return self.lay.n

    def state(self, side: int) -> DecodeState:
        return DecodeState(*self.ext[side][:, :self.n])


class MeshRun:
    """One decode of a mesh program: the blocks, the exchange and the
    schedules in lane blocks. ``counts`` returns the kernels' launch
    counters (``core.api.launch_counts``); ``kernels`` says whether the
    blocks run the kernels or their plain versions; ``graphs`` whether
    the rounds replay as CUDA graphs (kept for reading with
    ``keep_graphs``)."""

    def __init__(self, blocks: List[_Block], layout: MeshLayout, shape,
                 sync: str, fuse: str, kernels: bool, launch,
                 counts: Callable, rounds: RoundBlocks, graphs: bool,
                 keep_graphs: bool = False):
        self.blocks = blocks
        self.fuse = fuse
        self.live = [b for b in blocks if b.n]
        self.layout = layout
        self.layout_key = layout.key()
        self.shape = shape
        self.sync = sync
        self.kernels = kernels
        self.launch = launch
        self.counts = counts
        self.rounds = rounds
        self.graphs = graphs
        self.keep_graphs = keep_graphs
        self.side = 0
        self.exchanges = 0       # halo exchanges (after each round and phase)
        self.copy_bytes: Dict[str, int] = collections.Counter()
        # the write pass's: every sequence's span (:meth:`spans`) on each
        # block's device, the pieces' row counts, and how many times they
        # were worked out (at each host check of the last loop)
        self.span: Dict[int, torch.Tensor] = {}
        self.pieces = np.zeros((len(blocks), len(blocks)), np.int64)
        self.sized = 0

    # -- per block ------------------------------------------------------------
    @contextlib.contextmanager
    def on(self, blk: _Block):
        """Run the enclosed work on ``blk``'s device, adding its kernel
        launches to the block's."""
        before = self.counts()
        with device_ctx(blk.prog.device):
            yield
        after = self.counts()
        for k in after:
            blk.launches[k] += after[k] - before[k]

    def exits(self, blk: _Block, entry: DecodeState,
              idx: Optional[torch.Tensor] = None,
              out: Optional[DecodeState] = None) -> DecodeState:
        from ..kernels.huffman import ops as HK
        sh = self.shape
        kw = dict(s_max=sh.s_max, min_code_bits=sh.min_code_bits, out=out)
        if self.kernels:
            return HK.decode_exits(blk.d, blk.meta, entry, idx,
                                   launch=self.launch, **kw)
        return HK.decode_exits_plain(blk.d, blk.meta, entry, idx, **kw)

    def entries(self, blk: _Block, st: torch.Tensor) -> DecodeState:
        """entry[i] = exit[chunk_prev[i]] from a (4, n + halo) state; the
        segment-first lanes start cold."""
        prev = DecodeState(*torch.index_select(st, 1, blk.v["prev"]))
        cold = DecodeState.cold(blk.v["start"])
        return cold.select(blk.v["first"], prev)

    # -- the exchange -----------------------------------------------------------
    def copy(self, dst: torch.Tensor, src: torch.Tensor, what: str) -> None:
        """A copy from one block's buffer into another's (a peer copy
        between cards)."""
        dst.copy_(src)
        self.copy_bytes[what] += src.numel() * src.element_size()

    def gather_sends(self, blk: _Block, st: torch.Tensor) -> None:
        for _, idx, buf in blk.sends:
            torch.index_select(st, 1, idx, out=buf)

    def deliver(self, states: Sequence[torch.Tensor]) -> None:
        """Each block's send buffers into its readers' halos: ``states``
        holds each block's (4, n + halo) state."""
        for blk in self.blocks:
            for dst, _, buf in blk.sends:
                d = self.blocks[dst]
                s0 = next(s for a, s, _ in d.lay.recv if a == blk.i)
                k = buf.shape[1]
                self.copy(states[dst][:, d.n + s0:d.n + s0 + k], buf, "halo")
        self.exchanges += 1

    def exchange(self, states: Sequence[torch.Tensor]) -> None:
        for blk in self.blocks:
            if blk.sends:
                with self.on(blk):
                    self.gather_sends(blk, states[blk.i])
        self.deliver(states)

    # -- Jacobi rounds to the fixed point -----------------------------------------
    def round_body(self, blk: _Block, side: int) -> None:
        """One round of ``blk``: decode from the states of ``side`` into
        the other side, test the block's fixed point, gather the sends."""
        old, new = blk.ext[side], blk.ext[1 - side]
        n = blk.n
        out = DecodeState(*new[:, :n])
        self.exits(blk, self.entries(blk, old), out=out)
        eq = states_equal(out, DecodeState(*old[:, :n]))
        last, ridx = blk.v["last_neq"], blk.v["ridx"]
        last.copy_(torch.where(eq, last, ridx))
        ridx.add_(1)
        self.gather_sends(blk, new)

    def _graph(self, blk: _Block, side: int):
        tab = blk.d.get("luts_compact")
        key = (self.layout_key, blk.i, side,
               None if tab is None else (tab.data_ptr(), tab.numel()))
        graph = blk.prog.graphs.get(key)
        if graph is None:
            for old in [k for k in blk.prog.graphs if k[:2] != key[:2]
                        or k[3:] != key[3:]]:
                del blk.prog.graphs[old]
            graph = torch.cuda.CUDAGraph(keep_graph=self.keep_graphs)
            with torch.cuda.graph(graph,
                                  stream=capture_stream(blk.prog.device),
                                  capture_error_mode="thread_local"):
                self.round_body(blk, side)
            if self.keep_graphs:
                graph.instantiate()
            blk.prog.graphs[key] = graph
        return graph

    def one_round(self) -> None:
        side = self.side
        for blk in self.live:
            with self.on(blk):
                if self.graphs:
                    graph = self._graph(blk, side)
                    blk.replays += 1
                    graph.replay()
                else:
                    self.round_body(blk, side)
        self.deliver([b.ext[1 - side] for b in self.blocks])
        self.side = 1 - side

    def verify(self, rounds: int, max_rounds: int, name: str
               ) -> Tuple[int, bool]:
        """Jacobi rounds from the states of ``self.side`` (halos
        delivered) while ``rounds < max_rounds``; each round counts. Each
        host check also reads the write pass's piece sizes from the states
        it leaves (:meth:`size_pieces`): the last check's are the final
        states'."""
        for blk in self.live:
            with self.on(blk):
                blk.v["last_neq"].fill_(-1)
                blk.v["ridx"].zero_()
        k, nb = len(self.live), len(self.blocks)

        def combine(vals, launched):
            self.pieces = np.asarray(vals[k:]).reshape(nb, nb)
            last = max(vals[:k], default=-1)
            if last == launched - 1:
                return launched, True
            return last + 2, False

        n, going = self.rounds.loop(
            name, self.one_round,
            lambda: [b.v["last_neq"] for b in self.live]
            + self.size_pieces(),
            max_rounds - rounds, combine=combine)
        return rounds + n, not going

    def cold_pass(self, side: int = 0) -> None:
        """Every block's cold decode into ``side``, then its halos."""
        for blk in self.live:
            with self.on(blk):
                self.exits(blk, DecodeState.cold(blk.v["start"]),
                           out=blk.state(side))
        self.exchange([b.ext[side] for b in self.blocks])
        self.side = side

    # -- the schedules -------------------------------------------------------------
    def run_sync(self) -> Tuple[int, bool]:
        lim = sync_limits(self.shape)
        if self.sync == "jacobi":
            self.cold_pass()
            return self.verify(1, lim.jacobi, "jacobi")
        if self.sync == "specmap":
            self.specmap()
            return self.verify(MAX_UPM, lim.specmap, "specmap")
        if self.sync == "faithful":
            rounds = self.faithful(lim)
            return self.verify(rounds, rounds + lim.verify, "verify")
        self.cold_pass()   # sequential: one chunk a segment, cold is exact
        return 1, True

    def specmap(self) -> None:
        """Each block decodes its lanes under every phase hypothesis; the
        phase maps are gathered to every block, which composes the prefix
        over the whole batch and picks its lanes' exits."""
        c = self.shape.n_chunks
        hyps, maps = {}, {}
        for blk in self.live:
            with self.on(blk):
                upm = blk.meta["upm"]
                zero = torch.zeros_like(blk.v["start"])
                hyp = [self.exits(blk, DecodeState(
                    blk.v["start"], (upm - 1).clamp(max=u0), zero, zero))
                    for u0 in range(MAX_UPM)]
                hyps[blk.i] = [torch.stack(f) for f in zip(*hyp)]
                own = blk.prog.buf("maps", MAX_UPM * c).view(MAX_UPM, c)
                maps[blk.i] = own
                own[:, blk.lay.lo:blk.lay.hi] = phase_maps(hyps[blk.i][1],
                                                           blk.v["first"])
        for src in self.live:
            part = maps[src.i][:, src.lay.lo:src.lay.hi]
            for dst in self.live:
                if dst is not src:
                    self.copy(maps[dst.i][:, src.lay.lo:src.lay.hi], part,
                              "maps")
        permuted = self.shape.permuted
        for blk in self.live:
            with self.on(blk):
                d = blk.d
                entry_o = entry_phases(maps[blk.i], d["chunk_first"],
                                       d["chunk_order"] if permuted else None)
                if permuted:
                    lanes = d["lane_perm"][blk.lay.lo:blk.lay.hi]
                    entry_u = entry_o[lanes.to(torch.int64)]
                else:
                    entry_u = entry_o[blk.lay.lo:blk.lay.hi]
                st = blk.state(0)
                for f, arr in zip(st, hyps[blk.i]):
                    f.copy_(torch.gather(arr, 0, entry_u[None, :])[0])
        self.exchange([b.ext[0] for b in self.blocks])
        self.side = 0

    def faithful(self, lim: SyncLimits) -> int:
        """Algorithm 3 in lane blocks: the cold pass, intra-sequence
        chains (inside each block), then the inter-sequence chains from
        each boundary's root (in the halo when the sequence before lies in
        another block), with the halos refreshed before each outer
        round. Returns the rounds; the states are left in side 0 with
        their halos delivered."""
        for blk in self.live:
            with self.on(blk):
                self.exits(blk, DecodeState.cold(blk.v["start"]),
                           out=blk.state(0))
        info = {b.i: b.ext[0] for b in self.blocks}
        st: Dict[int, Dict] = {}

        def step(blk: _Block, s: Dict, seq_ok) -> Tuple:
            alive = s["alive"]
            act = alive.any()
            nxt = blk.v["next"][s["tgt"]]
            valid = alive & (nxt != s["tgt"]) & seq_ok(nxt)
            new = self.exits(blk, s["chain"], nxt)
            cur = info[blk.i]
            synced = new.puz_equal(DecodeState(*cur[:, nxt]))
            info[blk.i] = _scatter4(cur, nxt, new, valid)
            s.update(chain=new, alive=valid & ~synced, tgt=nxt)
            return act, valid & synced

        # intra-sequence chains: a lane a chain, inside its block
        for blk in self.live:
            with self.on(blk):
                n = blk.n
                st[blk.i] = {"chain": blk.state(0),
                             "alive": torch.ones(n, dtype=torch.bool,
                                                 device=blk.prog.device),
                             "tgt": torch.arange(n, device=blk.prog.device),
                             "count": torch.zeros((), dtype=torch.int32,
                                                  device=blk.prog.device)}

        def intra():
            for blk in self.live:
                with self.on(blk):
                    own = blk.v["seq"][:blk.n]
                    act, _ = step(blk, st[blk.i],
                                  lambda t, own=own, b=blk: b.v["seq"][t] == own)
                    st[blk.i]["count"].add_(act)

        def reads():
            return ([st[b.i]["count"] for b in self.live]
                    + [st[b.i]["alive"].any() for b in self.live])

        def combine(vals, _launched):
            k = len(self.live)
            return max(vals[:k], default=0), any(vals[k:])

        n, _ = self.rounds.loop("intra", intra, reads, lim.intra,
                                combine=combine)
        rounds = 1 + n

        # inter-sequence chains, an outer loop over the boundaries
        bnd = [b for b in self.live if len(b.lay.roots)]
        synced = {}
        for blk in bnd:
            with self.on(blk):
                synced[blk.i] = torch.zeros(len(blk.lay.roots),
                                            dtype=torch.bool,
                                            device=blk.prog.device)
        all_synced, outer = not bnd, 0
        while outer < lim.outer and not all_synced:
            self.exchange([info[b.i] for b in self.blocks])
            for blk in bnd:
                with self.on(blk):
                    roots = blk.v["roots"]
                    st[blk.i] = {
                        "chain": DecodeState(*info[blk.i][:, roots]),
                        "alive": ~synced[blk.i], "tgt": roots,
                        "found": torch.zeros_like(synced[blk.i]),
                        "count": torch.zeros((), dtype=torch.int32,
                                             device=blk.prog.device),
                        "root_seq": blk.v["seq"][roots]}

            def inter():
                for blk in bnd:
                    with self.on(blk):
                        s = st[blk.i]
                        act, hit = step(
                            blk, s, lambda t, s=s, b=blk:
                            b.v["seq"][t] == s["root_seq"] + 1)
                        s["found"].logical_or_(hit)
                        s["count"].add_(act)

            def reads_inter():
                return ([st[b.i]["count"] for b in bnd]
                        + [st[b.i]["alive"].any() for b in bnd]
                        + [(synced[b.i] | st[b.i]["found"]).all()
                           for b in bnd])

            def combine_inter(vals, _launched):
                k = len(bnd)
                return (max(vals[:k]), any(vals[k:2 * k]),
                        all(vals[2 * k:]))

            n, _, all_synced = self.rounds.loop(
                f"inter{outer}", inter, reads_inter, lim.inter,
                combine=combine_inter)
            for blk in bnd:
                with self.on(blk):
                    synced[blk.i] = synced[blk.i] | st[blk.i]["found"]
            rounds += n
            outer += 1
        self.rounds.hints["outer"] = outer
        for blk in self.live:
            if info[blk.i] is not blk.ext[0]:
                with self.on(blk):
                    blk.ext[0].copy_(info[blk.i])
        self.exchange([b.ext[0] for b in self.blocks])
        self.side = 0
        return rounds

    # -- the write pass ------------------------------------------------------------
    def size_pieces(self) -> List[torch.Tensor]:
        """The pieces' row counts, ``(blocks * blocks,)`` device scalars,
        from the states of ``self.side``: the blocks' sums of their
        sequences' symbol counts are gathered on the first block, which
        works out every sequence's range and rows (:meth:`spans`)."""
        side = self.side
        head, nb = self.blocks[0], len(self.blocks)
        offs = list(itertools.accumulate(
            [len(b.lay.seqs) for b in self.blocks], initial=0))
        sums = head.prog.buf("seq_all", offs[-1], torch.int64)
        for blk in self.live:
            with self.on(blk):
                q = len(blk.lay.seqs)
                s = blk.prog.buf("seq_sum", q + 1, torch.int64).zero_()
                s.index_add_(0, blk.v["seq_slot"],
                             blk.state(side).n.to(torch.int64))
                part = sums[offs[blk.i]:offs[blk.i + 1]]
                if blk is head:
                    part.copy_(s[:q])
            if blk is not head:
                self.copy(part, s[:q], "seq_sums")
        self.sized += 1
        with self.on(head):
            spans = head.prog.buf("spans", 4 * len(self.layout.seq_pos),
                                  torch.int64).view(4, -1)
            self.span[head.i] = self.spans(head, sums, spans)
            sizes = torch.zeros(nb * nb, dtype=torch.int64,
                                device=head.prog.device)
            sizes.index_add_(0, head.v["seq_piece"], spans[3])
        return list(sizes)

    def write_pass(self) -> List[Optional[torch.Tensor]]:
        """Each block's lanes' coefficients, into a buffer of their
        sequences' rows; returns the buffers ((rows, 64) int32, None for a
        block that writes nothing).

        A sequence writes one contiguous range of coefficients: from its
        start, the carry of the sequences before it in its segment, for
        its symbol count, cut at its segment's end. The first block sends
        every sequence's range and rows to the others. A block lays its
        sequences' rows end to end in bitstream order, so that the rows of
        one owner are one piece. The pieces' sizes were read at the sync's
        last host check (at one of their own after sequential sync, which
        has none)."""
        sh, side = self.shape, self.side
        head, nb = self.blocks[0], len(self.blocks)
        if not self.sized:
            self.pieces = np.asarray(self.rounds.read(
                *self.size_pieces())).reshape(nb, nb)
        spans = self.span[head.i]
        for blk in self.blocks[1:]:
            self.span[blk.i] = blk.prog.buf(
                "spans", spans.numel(), torch.int64).view(spans.shape)
            self.copy(self.span[blk.i], spans, "spans")
        out: List[Optional[torch.Tensor]] = [None] * nb
        for blk in self.live:
            n_rows = int(self.pieces[blk.i].sum())
            if not n_rows:
                continue
            with self.on(blk):
                base, wmax = self.write_bases(blk, side)
                n_coef = 64 * n_rows

                def buf(name, blk=blk, n_coef=n_coef):
                    if name == "streams":
                        return tuple(
                            blk.prog.buf(f"stream{k}", sh.s_max * blk.n,
                                         graphs=False).view(sh.s_max, blk.n)
                            for k in (0, 1))
                    n = n_coef + (blk.n if name == "scatter" else 0)
                    return blk.prog.buf(name, n, graphs=False)

                res = write_coefficients(
                    blk.d, blk.meta, self.entries(blk, blk.ext[side]), base,
                    wmax, n_coef, kernels=self.kernels, fuse=self.fuse,
                    s_max=sh.s_max, min_code_bits=sh.min_code_bits,
                    launch=self.launch, buf=buf)
                out[blk.i] = res.view(n_rows, 64)
        return out

    @staticmethod
    def spans(blk: _Block, sums: torch.Tensor,
              out: torch.Tensor) -> torch.Tensor:
        """Every sequence's first and end coefficient, first row and row
        count, by global id, into ``out`` ((4, sequences) int64), from the
        blocks' symbol counts laid end to end."""
        d, v = blk.d, blk.v
        by_id = sums[v["seq_pos"]]
        before = torch.cumsum(by_id, 0) - by_id
        seg = v["seq_seg"]
        g0 = d["seg_coeff_base"][seg] + (before - before[v["seq_seg_start"]])
        seg_end = torch.cat([d["seg_coeff_base"][1:], d["units_end"][None]])
        g1 = torch.minimum(g0 + by_id, seg_end[seg]).maximum(g0)
        r0 = torch.div(g0, 64, rounding_mode="floor")
        rows = torch.div(g1 - 64 * r0 + 63, 64, rounding_mode="floor")
        return torch.stack([g0, g1, r0, rows.where(g1 > g0, 0)], out=out)

    def write_bases(self, blk: _Block, side: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The block's lanes' write bases and last positions in its buffer:
        sequence ``q``'s coefficient ``g`` lands at ``g - 64 * (r0[q] -
        at[q])``, ``at[q]`` its first row in the buffer. An inert lane
        writes nothing."""
        v = blk.v
        g0, g1, r0, rows = self.span[blk.i][:, v["seqs"]]
        shift = 64 * (r0 - (torch.cumsum(rows, 0) - rows))
        # each sequence's range in the buffer, then an empty one
        ends = F.pad(torch.stack([g0 - shift, g1 - shift]),
                     (0, 1))[:, v["seq_slot"]]
        inseq = D.segmented_exclusive_cumsum(blk.state(side).n,
                                             v["seq_start"])
        return (blk.prog.buf("bases", blk.n).copy_(ends[0] + inseq),
                blk.prog.buf("wmax", blk.n).copy_(ends[1] - 1))

    def place(self, written: List[Optional[torch.Tensor]]
              ) -> List[torch.Tensor]:
        """Each block's owned rows: every block's piece for it, gathered
        into one buffer and added row by row at its sequences' rows
        (sequences that share a row write disjoint coefficients of it, 0
        elsewhere)."""
        rows = []
        for dst in self.blocks:
            o0, o1 = dst.lay.rows
            ks = self.pieces[:, dst.i]
            total = int(ks.sum())
            with self.on(dst):
                acc = dst.prog.buf("rows", (o1 - o0) * 64).view(o1 - o0, 64)
                acc.zero_()
                recv = dst.prog.buf("recv", total * 64,
                                    graphs=False).view(total, 64)
            at = 0
            for a in np.flatnonzero(ks):
                k, o = int(ks[a]), int(self.pieces[a, :dst.i].sum())
                if a == dst.i:
                    with self.on(dst):
                        recv[at:at + k].copy_(written[a][o:o + k])
                else:
                    self.copy(recv[at:at + k], written[a][o:o + k], "rows")
                at += k
            if total:
                with self.on(dst):
                    r0, cnt = self.span[dst.i][2:, dst.v["owned"]]
                    first = torch.cumsum(cnt, 0) - cnt
                    idx = torch.repeat_interleave(r0 - o0 - first, cnt,
                                                  output_size=total)
                    idx += torch.arange(total, device=idx.device)
                    acc.index_add_(0, idx, recv)
            rows.append(acc)
        return rows


def _scatter4(st: torch.Tensor, idx: torch.Tensor, new: DecodeState,
              ok: torch.Tensor) -> torch.Tensor:
    """``st`` (4, L) with column ``idx[i]`` set to ``new[i]`` where
    ``ok[i]``: ``core.sync._scatter_where`` on the stacked fields (the
    masked lanes write a sentinel column past the end)."""
    c = st.shape[1]
    tgt = torch.where(ok, idx, c)
    buf = torch.cat([st, st.new_zeros(4, 1)], 1)
    buf[:, tgt] = torch.stack(list(new))
    return buf[:, :c]


def host_arrays(layout: MeshLayout) -> List[Dict[str, np.ndarray]]:
    """The layout arrays each block uploads (int64 indices and the int32
    sequence ids of its lanes and halo)."""
    return [{"prev": blk.prev, "next": blk.next, "seq": blk.seq,
             "roots": blk.roots, "seq_slot": blk.seq_slot,
             "seq_start": blk.seq_start, "seqs": blk.seqs,
             "owned": blk.owned, "seq_pos": layout.seq_pos,
             "seq_seg_start": layout.seq_seg_start,
             "seq_seg": layout.seq_seg, "seq_piece": layout.seq_piece,
             **{f"send{dst}": lanes for dst, lanes in layout.sends[b]}}
            for b, blk in enumerate(layout.blocks)]


def peer_access(mesh) -> Dict[str, bool]:
    """Whether each ordered pair of the mesh's distinct cards has peer
    access (a copy between cards without it goes through the host)."""
    cards = sorted({d.index for d in mesh.devices.flat if d.type == "cuda"})
    return {f"{a}->{b}": bool(torch.cuda.can_device_access_peer(a, b))
            for a in cards for b in cards if a != b}


def expected_bytes(layout: MeshLayout, sync: str, exchanges: int,
                   sized: int, pieces: np.ndarray) -> Dict[str, int]:
    """The bytes the exchange moves between blocks in one decode: each
    halo exchange (after the cold pass or phase and after each round),
    specmap's phase maps, the sequence sums to the first block (``sized``
    times) and the spans from it, from the layout; the rows sent to their
    owners from the pieces' row counts (``pieces[a, b]``, block ``a``'s
    rows that block ``b`` owns, read at a host check)."""
    nb = len(layout.blocks)
    live = [b for b in layout.blocks if b.n]
    halo = 16 * sum(len(b.halo) for b in layout.blocks)
    out = {"halo": halo * exchanges}
    if sync == "specmap":
        out["maps"] = 4 * MAX_UPM * sum(b.n for b in live) * (len(live) - 1)
    out["seq_sums"] = 8 * sum(len(b.seqs) for b in layout.blocks[1:]) \
        * sized
    out["spans"] = 32 * len(layout.seq_pos) * (nb - 1)
    out["rows"] = 256 * int(pieces.sum() - np.trace(pieces))
    return {k: v for k, v in out.items() if v}
