"""Sharding plans: lane balance, lane blocks and the model's layout.

The port of the JAX package's ``dist/plan.py``: the lane balance of the
decoder (numpy), the lane blocks of a decode over a mesh
(:func:`mesh_layout`), and the model's sharding plan (:func:`rules_for`,
:func:`param_rules`, :class:`ShardLayout`, at the end of this module);
the logical-axis rules are in ``dist/sharding.py``.

The decoder can split its chunk-lane axis into contiguous blocks, one a
device. Lanes default to bitstream order, so a skewed batch (one big JPEG
and many small ones) gives every block equal *counts* but concentrates the
long image's sequences, the paper's thread-block unit, on few blocks.
Because chain adjacency is the explicit chunk_prev/chunk_next lane graph
(core/sync.py), lanes may be permuted at plan time: assign whole
*sequences* (seq_chunks-bounded chunk runs) to lane blocks, lay each
block's sequences out contiguously, and pad every block to a common length
with inert lanes (start == limit == 0, chunk_first=True, chunk_seq=-1:
they decode nothing, stay cold, and chain to themselves). The decode is
bit-identical to the unpermuted plan's on every schedule and backend.
"""
from __future__ import annotations

import dataclasses
from typing import (Dict, FrozenSet, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from .sharding import Rules, normalize

BALANCE_POLICIES = ("none", "roundrobin", "lpt")


def check_balance(policy: str) -> None:
    if policy not in BALANCE_POLICIES:
        raise ValueError(
            f"unknown lane balance policy {policy!r}: expected one of "
            f"{BALANCE_POLICIES}")


def default_lanes(device) -> int:
    """Lane blocks a balanced plan gets without ``lanes=``: the card count
    on a CUDA device (the JAX package takes its device count), 1 on the
    CPU."""
    return torch.cuda.device_count() if torch.device(device).type == "cuda" \
        else 1


def _sequence_runs(plan) -> List[np.ndarray]:
    """Chunk-id runs per sequence, in bitstream order (identity plans)."""
    if plan.balance != "none":
        raise ValueError(
            "plan is already lane-balanced; balance the identity plan "
            "produced by build_batch_plan instead")
    seq = np.asarray(plan.chunk_seq)
    cuts = np.flatnonzero(np.diff(seq)) + 1
    return np.split(np.arange(plan.n_chunks, dtype=np.int32), cuts)


def _assign_bins(sizes: Sequence[int], n_lanes: int,
                 policy: str) -> List[List[int]]:
    """Assign sequence ids to lane blocks; returns per-block id lists.

    "none" models the unbalanced layout at sequence granularity: a
    contiguous, equal-count run of the bitstream-ordered sequence list per
    block (the naive static partition). "roundrobin" deals sequences
    cyclically; "lpt" is longest-processing-time (sort by chunk count
    descending, always place on the least-loaded block), whose max-min load
    gap is bounded by one sequence's chunk count.
    """
    check_balance(policy)
    q_n = len(sizes)
    bins: List[List[int]] = [[] for _ in range(n_lanes)]
    if policy == "none":
        per = -(-q_n // n_lanes)
        for q in range(q_n):
            bins[q // per].append(q)
    elif policy == "roundrobin":
        for q in range(q_n):
            bins[q % n_lanes].append(q)
    else:  # lpt
        loads = [0] * n_lanes
        for q in sorted(range(q_n), key=lambda i: (-sizes[i], i)):
            d = min(range(n_lanes), key=lambda i: (loads[i], i))
            bins[d].append(q)
            loads[d] += sizes[q]
        for b in bins:
            b.sort()
    return bins


def lane_loads(plan, n_lanes: int, policy: str) -> np.ndarray:
    """Per-block real chunk counts under a policy's sequence assignment,
    without building the permuted plan."""
    runs = _sequence_runs(plan)
    sizes = [len(r) for r in runs]
    bins = _assign_bins(sizes, n_lanes, policy)
    return np.array([sum(sizes[q] for q in b) for b in bins], dtype=np.int64)


def plan_lane_loads(plan, n_lanes: int) -> np.ndarray:
    """Actual real-chunk count per lane block of a (balanced) plan."""
    if plan.n_chunks % n_lanes:
        raise ValueError(
            f"plan has {plan.n_chunks} lanes, not divisible into {n_lanes} "
            f"lane blocks")
    real = np.asarray(plan.lane_perm) < plan.n_real_chunks
    return real.reshape(n_lanes, -1).sum(axis=1).astype(np.int64)


def local_batch_plan(local_blobs, *, chunk_bits: int = 1024,
                     seq_chunks: int = 32, balance: str = "none",
                     lanes: Optional[int] = None, validation=None,
                     device="cuda"):
    """Plan ONLY the bytes this process holds (a multi-process launch).

    The plan is built where the bytes live: parse/unstuff/frame the local
    blobs, optionally balance the lanes (``lanes`` blocks, by default
    :func:`default_lanes` of ``device``), and hand back a plan whose
    bucketed ``PlanShape`` is what crosses processes (see
    ``repro_torch.launch.multihost.plan_consensus``). A process with zero
    local blobs gets the inert-lane-only ``empty_batch_plan`` so it still
    takes part in the consensus.

    ``validation`` (a ``core.bitstream.BatchValidation`` of the local
    blobs) switches to resilient planning: this process's damaged blobs
    are quarantined/recovered locally and never raise, so one corrupt feed
    cannot strand the other processes at the consensus exchange.
    """
    check_balance(balance)
    from ..core.bitstream import build_batch_plan, empty_batch_plan
    if not local_blobs:
        plan = empty_batch_plan(chunk_bits=chunk_bits, seq_chunks=seq_chunks)
    else:
        plan = build_batch_plan(list(local_blobs), chunk_bits=chunk_bits,
                                seq_chunks=seq_chunks, validation=validation)
    if balance != "none":
        n_lanes = int(lanes) if lanes is not None else default_lanes(device)
        plan = balance_lanes(plan, n_lanes, balance)
    return plan


def balance_lanes(plan, n_lanes: int, policy: str):
    """Rewrite a BatchPlan with its chunk lanes balanced over ``n_lanes``.

    Returns a new plan whose lane axis is a permutation of the input's
    chunks plus inert padding lanes, such that each of the ``n_lanes``
    contiguous lane blocks holds a balanced set of whole sequences. The
    decode result is bit-identical; only work placement changes.
    """
    check_balance(policy)
    if policy == "none" or n_lanes <= 1:
        return plan
    runs = _sequence_runs(plan)
    sizes = [len(r) for r in runs]
    bins = _assign_bins(sizes, n_lanes, policy)
    block = max(1, max(sum(sizes[q] for q in b) for b in bins))

    c_real = plan.n_chunks
    c_pad = n_lanes * block
    perm = np.empty(c_pad, dtype=np.int32)   # lane -> bitstream chunk id
    inert = c_real
    for d, b in enumerate(bins):
        ids = (np.concatenate([runs[q] for q in b])
               if b else np.zeros(0, dtype=np.int32))
        k = len(ids)
        perm[d * block: d * block + k] = ids
        perm[d * block + k: (d + 1) * block] = np.arange(
            inert, inert + block - k, dtype=np.int32)
        inert += block - k
    order = np.empty(c_pad, dtype=np.int32)  # bitstream chunk id -> lane
    order[perm] = np.arange(c_pad, dtype=np.int32)

    pad = c_pad - c_real

    def ext(a: np.ndarray, fill) -> np.ndarray:
        a = np.asarray(a)
        return np.concatenate([a, np.full(pad, fill, dtype=a.dtype)])

    # chain adjacency in bitstream chunk-id space (shared definition with
    # build_batch_plan), then mapped to lanes; inert chunks (ids >= c_real)
    # are flagged first and therefore self-chain
    from ..core.bitstream import chain_adjacency  # lazy: core imports us

    first_e = ext(plan.chunk_first, True)
    prev_c, next_c = chain_adjacency(first_e)

    return dataclasses.replace(
        plan,
        n_chunks=int(c_pad),
        chunk_seg=ext(plan.chunk_seg, 0)[perm],
        chunk_start=ext(plan.chunk_start, 0)[perm],
        chunk_limit=ext(plan.chunk_limit, 0)[perm],
        chunk_first=first_e[perm],
        chunk_seq=ext(plan.chunk_seq, -1)[perm],
        chunk_seq_first=ext(plan.chunk_seq_first, True)[perm],
        chunk_prev=order[prev_c[perm]].astype(np.int32),
        chunk_next=order[next_c[perm]].astype(np.int32),
        lane_perm=perm,
        chunk_order=order,
        seq_last_chunk=order[np.asarray(plan.seq_last_chunk)].astype(np.int32),
        balance=policy,
        # record the block layout: capacity padding (core.bitstream.
        # build_plan_data) pads each of these n_lanes blocks independently,
        # so a bucketed plan keeps its per-block sequence assignment
        n_lanes=n_lanes,
    )


# ---------------------------------------------------------------------------
# Lane blocks of a mesh decode (core.mesh_decode)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BlockLayout:
    """One block of a mesh decode: lanes ``[lo, hi)`` of the padded plan.

    A block's states are laid out as its ``n = hi - lo`` lanes, then its
    *halo*: the lanes of other blocks that its lanes chain from
    (``halo``, global lanes, grouped by source block as ``recv`` gives
    them: ``(source block, start, stop)`` in the halo). Indices into that
    layout: ``prev`` (each lane's entry source), ``next`` (each lane's
    and each halo entry's successor in this block; a lane whose successor
    lies in another block is its own), ``seq`` (``chunk_seq`` of both),
    and ``roots``, the sequence boundaries faithful sync chains across
    whose next sequence lies here. ``seqs`` are the global ids of its
    sequences in bitstream order (so in the order of the blocks that own
    their rows), ``seq_slot`` each lane's index in it (``len(seqs)`` for
    an inert lane) and ``seq_start`` the position of the first lane of
    its sequence. It owns the coefficient rows ``rows`` (the units of
    images ``images``); ``owned`` lists the sequences whose rows it owns,
    those of block 0 first, each block's in bitstream order.
    """
    lo: int
    hi: int
    halo: np.ndarray
    recv: Tuple[Tuple[int, int, int], ...]
    prev: np.ndarray
    next: np.ndarray
    seq: np.ndarray
    roots: np.ndarray
    seqs: np.ndarray
    seq_slot: np.ndarray
    seq_start: np.ndarray
    rows: Tuple[int, int]
    images: Tuple[int, int]
    owned: np.ndarray

    @property
    def n(self) -> int:
        return self.hi - self.lo

    def sizes(self) -> Tuple:
        """What a block's buffers and graphs are shaped by."""
        return (self.n, len(self.halo), self.recv, len(self.roots),
                len(self.seqs), self.rows)


@dataclasses.dataclass
class MeshLayout:
    """The lane blocks of a padded plan over a mesh of ``len(blocks)``.

    ``sends[a]`` lists, for each block ``b`` that reads block ``a``'s
    states, ``(b, lanes)``: ``a``'s local lanes, in the order of ``b``'s
    halo. ``seq_pos[q]`` is sequence ``q``'s position in the blocks'
    ``seqs`` laid end to end, ``seq_seg_start[q]`` the first sequence of
    its segment, ``seq_seg[q]`` its segment and ``seq_piece[q]`` the
    block pair that decodes it and owns its rows (``a * blocks + b``).
    A sequence writes one contiguous range of coefficients, inside its
    segment and so inside its image's rows.
    """
    bounds: np.ndarray
    blocks: List[BlockLayout]
    sends: List[List[Tuple[int, np.ndarray]]]
    seq_pos: np.ndarray
    seq_seg_start: np.ndarray
    seq_seg: np.ndarray
    seq_piece: np.ndarray

    def key(self) -> Tuple:
        return tuple(b.sizes() for b in self.blocks)


def _block_bounds(arrays, n_blocks: int, n_real: int,
                  even: bool) -> np.ndarray:
    """Lane bounds of ``n_blocks`` blocks, each cut at a sequence start (an
    inert lane starts one too), so no sequence spans two blocks. ``even``
    (a plan balanced into as many lane blocks) cuts at its own blocks;
    else each cut is the sequence start nearest to an equal share of the
    real lanes."""
    c = len(arrays["chunk_seq"])
    if even:
        return np.arange(n_blocks + 1, dtype=np.int64) * (c // n_blocks)
    real = np.asarray(arrays["lane_perm"]) < n_real
    before = np.concatenate([[0], np.cumsum(real)])   # real lanes before i
    cuts = np.append(np.flatnonzero(arrays["chunk_seq_first"]), c)
    bounds = [0]
    for b in range(1, n_blocks):
        t = b * n_real / n_blocks
        bounds.append(int(cuts[np.argmin(np.abs(before[cuts] - t))]))
    bounds.append(c)
    return np.maximum.accumulate(np.asarray(bounds, dtype=np.int64))


def _owners(plan, bounds: np.ndarray, arrays, permuted: bool) -> np.ndarray:
    """The owning block of each image: the block whose share of the
    bitstream holds the middle of the image's chunks (contiguous ranges
    of images, in order)."""
    n = len(bounds) - 1
    r = plan.n_real_chunks
    if permuted:
        cb = np.asarray([b * r // n for b in range(n + 1)])
    else:
        cb = np.minimum(bounds, r)
    order = np.asarray(arrays["chunk_order"], np.int64)[:r]
    seg = np.asarray(arrays["chunk_seg"], np.int64)[order]
    img = np.asarray(plan.seg_image, np.int64)[seg]     # by chunk id
    k = np.arange(plan.n_images)
    first = np.searchsorted(img, k, "left")
    end = np.searchsorted(img, k, "right")
    mid = np.where(end > first, (first + end - 1) // 2, first)
    return np.clip(np.searchsorted(cb, mid, "right") - 1, 0, n - 1)


def mesh_layout(plan, arrays, n_blocks: int) -> MeshLayout:
    """The lane blocks of ``arrays`` (a plan's padded arrays,
    ``PlanData.arrays``) over ``n_blocks`` mesh entries, made in numpy at
    plan time: bounds, halos and the edge lists of the exchange,
    sequences, the row ranges each block owns and the owner of each
    sequence's rows."""
    permuted = plan.balance != "none"
    c = len(arrays["chunk_seq"])
    bounds = _block_bounds(arrays, n_blocks, plan.n_real_chunks,
                           permuted and plan.n_lanes == n_blocks
                           and c % n_blocks == 0)
    prev = np.asarray(arrays["chunk_prev"], np.int64)
    nxt = np.asarray(arrays["chunk_next"], np.int64)
    first = np.asarray(arrays["chunk_first"], bool)
    seq = np.asarray(arrays["chunk_seq"], np.int32)
    seq_first = np.asarray(arrays["chunk_seq_first"], bool)
    chunk_seg = np.asarray(arrays["chunk_seg"], np.int64)

    owner = _owners(plan, bounds, arrays, permuted)
    images = np.searchsorted(owner, np.arange(n_blocks + 1), "left")
    unit_image = np.asarray(plan.unit_image)[:plan.total_units]
    ustart = np.searchsorted(unit_image, np.arange(plan.n_images + 1),
                             "left")
    ustart[-1] = plan.total_units
    rows = ustart[images]

    # a sequence writes one contiguous range of coefficients, inside its
    # segment and so inside the rows of its segment's image's owner
    n_seq = plan.n_sequences
    lanes = np.flatnonzero(seq >= 0)
    seq_seg = np.zeros(n_seq, np.int64)
    seq_seg[seq[lanes]] = chunk_seg[lanes]
    seq_owner = owner[np.asarray(plan.seg_image, np.int64)[seq_seg]]
    seq_block = np.zeros(n_seq, np.int64)
    seq_block[seq[lanes]] = np.searchsorted(bounds, lanes, "right") - 1
    if np.any(np.diff(seq_owner) < 0):
        raise ValueError("sequence ids out of image order")
    ids = np.arange(n_seq)

    blocks = []
    for b in range(n_blocks):
        lo, hi = int(bounds[b]), int(bounds[b + 1])
        n = hi - lo
        p = prev[lo:hi]
        away = ~first[lo:hi] & ((p < lo) | (p >= hi))
        src = np.unique(p[away])   # chunk_prev is injective off the firsts
        src_block = np.searchsorted(bounds, src, "right") - 1
        order = np.lexsort((src, src_block))
        halo, src_block = src[order], src_block[order]
        recv = tuple((int(a), int(np.searchsorted(src_block, a, "left")),
                      int(np.searchsorted(src_block, a, "right")))
                     for a in np.unique(src_block))
        slot = {int(s): n + j for j, s in enumerate(halo)}
        loc_prev = np.where(away, 0, p - lo)
        for i in np.flatnonzero(away):
            loc_prev[i] = slot[int(p[i])]
        nx = nxt[lo:hi]
        loc_next = np.where((nx >= lo) & (nx < hi), nx - lo, np.arange(n))
        halo_next = np.zeros(len(halo), np.int64)
        for i in np.flatnonzero(away):
            halo_next[slot[int(p[i])] - n] = i
        lanes_seq = seq[lo:hi]
        bound = seq_first[lo:hi] & ~first[lo:hi] & (lanes_seq >= 0)
        seqs = np.sort(lanes_seq[seq_first[lo:hi] & (lanes_seq >= 0)]
                       ).astype(np.int64)
        starts = np.flatnonzero(seq_first[lo:hi] | (lanes_seq < 0))
        seq_start = starts[np.searchsorted(starts, np.arange(n), "right") - 1] \
            if n else np.zeros(0, np.int64)
        slot_of = {int(q): j for j, q in enumerate(seqs)}
        seq_slot = np.asarray([slot_of.get(int(q), len(seqs))
                               for q in lanes_seq], np.int64)
        mine = ids[seq_owner == b]
        owned = mine[np.argsort(seq_block[mine], kind="stable")]
        blocks.append(BlockLayout(
            lo=lo, hi=hi, halo=halo, recv=recv, prev=loc_prev.astype(np.int64),
            next=np.concatenate([loc_next, halo_next]).astype(np.int64),
            seq=np.concatenate([lanes_seq, seq[halo]]).astype(np.int32),
            roots=loc_prev[bound].astype(np.int64), seqs=seqs,
            seq_slot=seq_slot, seq_start=seq_start.astype(np.int64),
            rows=(int(rows[b]), int(rows[b + 1])),
            images=(int(images[b]), int(images[b + 1])), owned=owned))

    sends: List[List[Tuple[int, np.ndarray]]] = [[] for _ in blocks]
    for b, blk in enumerate(blocks):
        for a, s0, s1 in blk.recv:
            sends[a].append((b, blk.halo[s0:s1] - blocks[a].lo))

    # sequence-level carry of the write bases: each sequence's position in
    # the blocks' seqs end to end, and its segment's first sequence
    all_seqs = np.concatenate([blk.seqs for blk in blocks])
    seq_pos = np.empty(n_seq, np.int64)
    seq_pos[all_seqs] = np.arange(len(all_seqs))
    lead = seq_first & (seq >= 0)
    seg_first_seq = np.zeros(n_seq, bool)
    seg_first_seq[seq[lead]] = first[lead]
    seg_first_seq[:1] = True
    pos = np.arange(n_seq, dtype=np.int64)
    seq_seg_start = np.maximum.accumulate(np.where(seg_first_seq, pos, 0))

    return MeshLayout(bounds=bounds, blocks=blocks, sends=sends,
                      seq_pos=seq_pos, seq_seg_start=seq_seg_start,
                      seq_seg=seq_seg, seq_piece=seq_block * n_blocks
                      + seq_owner)


# ---------------------------------------------------------------------------
# The model's sharding plan: rules, the parameter audit, one rank's layout
# ---------------------------------------------------------------------------
#
# ``mesh`` below is anything with ``axis_names`` and ``shape`` (axis ->
# size), as the JAX package's functions read a ``jax.sharding.Mesh``: a
# ``launch.mesh.ProcessMesh`` of ranks, a ``launch.mesh.Mesh`` of devices.

# logical axes that only ever label activations and data, never parameters
ACTIVATION_ONLY = ("batch", "seq", "kv_seq", "chunks", "units")

# the logical axes a layout can split over the "model" axis
MODEL_AXES = ("heads", "kv_heads", "mlp", "experts", "vocab")


def _axes_size(mesh, axes: Tuple[str, ...]) -> int:
    return int(np.prod([mesh.shape[a] for a in axes])) if axes else 1


def rules_for(cfg, mesh, kind: str, batch: int) -> Rules:
    """Logical rules for one workload cell, as the JAX package's.

    ``kind``: ``"train"``, ``"prefill"`` or ``"decode"``; ``batch`` the
    global batch, whose split over the data axes is dropped when it does
    not divide them. The width axes ride ``"model"``; a decode of a
    config with ``decode_kv_shard == "seq"`` spreads the cache length
    (``"kv_seq"``) over it.
    """
    names = set(mesh.axis_names)
    data = tuple(a for a in ("pod", "data") if a in names)
    model = ("model",) if "model" in names else ()
    if data and batch % _axes_size(mesh, data) != 0:
        data = ()
    rules: Rules = {
        "batch": data, "seq": (), "kv_seq": (), "embed": (),
        "heads": model, "kv_heads": model, "mlp": model, "experts": model,
        "vocab": model, "chunks": data, "units": data,
    }
    if kind == "decode" and getattr(cfg, "decode_kv_shard", "none") == "seq":
        rules["kv_seq"] = model
    return rules


def param_rules(rules: Rules, cfg, mesh) -> Rules:
    """The parameter side of ``rules``: the activation-only axes dropped,
    and every axis demoted to replicated whose labelled dimensions do not
    all divide its mesh extent, audited over the parameters of
    ``abstract_params(cfg)`` (on the ``meta`` device) as the JAX package
    audits its abstract tree."""
    from ..models.model import abstract_params  # lazy: models import us

    prules: Rules = {k: normalize(v) for k, v in rules.items()
                     if k not in ACTIVATION_ONLY}
    model = abstract_params(cfg)
    bad = set()
    for name, axes in model.specs().items():
        shape = model.get_parameter(name).shape
        for dim, logical in zip(shape, axes):
            if logical is None or logical not in prules:
                continue
            on = tuple(a for a in prules[logical] if a in mesh.shape)
            if on and dim % _axes_size(mesh, on) != 0:
                bad.add(logical)
    for logical in bad:
        prules[logical] = ()
    return prules


class Segments(NamedTuple):
    """How a parameter's dimension over the model axis is laid out when a
    contiguous cut would mix unlike columns: runs of ``sizes`` in order,
    each cut into ``model`` equal slices where ``split`` says so and held
    whole on every rank where not. ``needs``: the logical axes that must
    all be split for the cut; without any of them the parameter is held
    whole. SSD's ``w_in`` is ``[z | x | B | C | dt]``: each rank holds its
    heads' ``z``, ``x`` and ``dt`` and all of ``B`` and ``C``."""
    sizes: Tuple[int, ...]
    split: Tuple[bool, ...]
    needs: Tuple[str, ...]


class Cut(NamedTuple):
    """This rank's part of a parameter along ``dim``: the runs ``pieces``
    (``(start, length)`` each) joined in order."""
    dim: int
    pieces: Tuple[Tuple[int, int], ...]

    @property
    def length(self) -> int:
        return sum(n for _, n in self.pieces)

    def take(self, t):
        """This rank's part of ``t`` (a tensor or a numpy array of the
        whole parameter): a tensor's one run is a view of it."""
        if isinstance(t, np.ndarray):
            idx = np.concatenate([np.arange(s, s + n)
                                  for s, n in self.pieces])
            return np.take(t, idx, axis=self.dim)
        parts = [t.narrow(self.dim, s, n) for s, n in self.pieces]
        return torch.cat(parts, self.dim) if len(parts) > 1 else parts[0]


@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """What one rank of a ``(data, model)`` mesh holds of a model, its
    batch and its caches: the port's counterpart of the JAX package's
    ``param_shardings``, ``batch_shardings`` and ``cache_shardings``.

    ``split`` are the logical axes cut over the model axis (after the
    audit of :func:`param_rules`); a parameter is cut on its first such
    dimension into ``model`` equal slices, of which this rank holds slice
    ``model_rank``, or by its :class:`Segments` (:meth:`param_cut`). With
    ``batch_split``, batch inputs and caches hold the ``data_rank``-th of
    ``data`` equal runs of rows (:meth:`rows`). ``group`` is the process
    group of this rank's model axis, over which the layers reduce,
    ``data_group`` that of its data axis, over which MoE counts its
    capacity (None where no process group runs: in one process, or to
    slice weights alone). ``kv_seq``: a decode layout of a
    ``decode_kv_shard="seq"`` config, whose GQA caches hold this rank's
    run of the cache length (:meth:`seq_range`) for every kv head.
    ``whole`` names the layers held whole on every rank though the model
    axis has several ranks (an SSD whose ``mlp`` or ``heads`` the audit
    demoted): their values are the same either way.

    Caches differ in layout from the JAX package's, with the same values:
    there they stay batch-sharded only and XLA's partitioner reshards
    them for the attention; here each rank's caches hold the kv heads of
    its own slice (:meth:`local` of ``"kv_heads"``; all of them when the
    audit kept ``kv_heads`` whole, or under ``kv_seq``), SSD's state its
    heads and its conv inputs its ``x`` channels with all of ``B`` and
    ``C``, MLA's latent whole, and its data rank's rows.
    """
    data: int = 1
    model: int = 1
    data_rank: int = 0
    model_rank: int = 0
    batch_split: bool = False
    split: FrozenSet[str] = frozenset()
    kv_seq: bool = False
    whole: FrozenSet[str] = frozenset()
    group: object = dataclasses.field(default=None, compare=False,
                                      repr=False)
    data_group: object = dataclasses.field(default=None, compare=False,
                                           repr=False)

    @property
    def tensor_parallel(self) -> bool:
        """Whether the layers run over a model group of several ranks."""
        return self.model > 1

    def splits(self, logical: str) -> bool:
        return logical in self.split

    def param_cut(self, shape: Sequence[int],
                  axes: Sequence[Optional[str]],
                  segments: Optional[Segments] = None) -> Optional[Cut]:
        """This rank's :class:`Cut` of a parameter of ``shape`` with
        logical ``axes`` (and ``segments`` along its split dimension), or
        None when it is held whole."""
        if segments is not None and not all(
                a in self.split for a in segments.needs):
            return None
        for dim, logical in enumerate(axes):
            if logical not in self.split:
                continue
            runs = [(shape[dim], True)] if segments is None \
                else list(zip(segments.sizes, segments.split))
            if sum(n for n, _ in runs) != shape[dim]:
                raise ValueError(f"segments {segments.sizes} do not make "
                                 f"dimension {dim} of {tuple(shape)}")
            pieces, off = [], 0
            for n, cut in runs:
                k = n // self.model
                if cut and k * self.model != n:
                    raise ValueError(f"dimension {dim} of {tuple(shape)} "
                                     f"({logical}) does not split into "
                                     f"{self.model}")
                pieces.append((off + self.model_rank * k, k) if cut
                              else (off, n))
                off += n
            return Cut(dim, tuple(pieces))
        return None

    def rows(self, batch: int) -> slice:
        """This rank's rows of a global batch of ``batch``."""
        if not self.batch_split:
            return slice(0, batch)
        n = batch // self.data
        return slice(self.data_rank * n, (self.data_rank + 1) * n)

    def batch(self, inputs: Dict[str, torch.Tensor]) -> Dict:
        """Every batch input's rows of this rank (dimension 0)."""
        return {k: v[self.rows(v.shape[0])] for k, v in inputs.items()}

    def local(self, logical: str, n: int) -> slice:
        """This rank's part of a dimension of ``n`` labelled ``logical``
        (the query ``"heads"`` its attention computes, the ``"kv_heads"``
        its caches hold, its ``"vocab"`` rows): all of it unless the
        layout splits ``logical``."""
        if logical not in self.split:
            return slice(0, n)
        k = n // self.model
        return slice(self.model_rank * k, (self.model_rank + 1) * k)

    def seq_range(self, n: int) -> slice:
        """Under ``kv_seq``, this rank's positions of a cache of ``n``:
        a run of ``ceil(n / model)`` (the last rank's may end early; its
        cache is as long as the others', the tail never written); all of
        them otherwise."""
        if not self.kv_seq:
            return slice(0, n)
        k = -(-n // self.model)
        return slice(min(self.model_rank * k, n),
                     min((self.model_rank + 1) * k, n))

    def report(self) -> str:
        """What this rank's layout splits and holds whole, for a log."""
        text = f"split={sorted(self.split)}"
        if self.kv_seq:
            text += " kv_seq"
        if self.whole:
            text += f" whole={sorted(self.whole)}"
        return text


# an SSD's parameters are cut (by their ``Segments``) only with both
SSD_AXES = ("mlp", "heads")


def shard_layout(cfg, mesh, rank: int, batch: int, kind: str = "decode",
                 group=None, data_group=None) -> ShardLayout:
    """Rank ``rank``'s :class:`ShardLayout` of ``cfg`` on a ``("data",
    "model")`` ``mesh`` (rank ``data_rank * model + model_rank``) for a
    global batch of ``batch``: :func:`rules_for`, then :func:`param_rules`.
    Every family splits; an axis the audit demotes is held whole, as the
    JAX package's partitioner holds it."""
    if tuple(mesh.axis_names) != ("data", "model"):
        raise ValueError(f"a ShardLayout needs a ('data', 'model') mesh, "
                         f"got axes {tuple(mesh.axis_names)}")
    data, model = mesh.shape["data"], mesh.shape["model"]
    if not 0 <= rank < data * model:
        raise ValueError(f"rank {rank} outside a mesh of {data * model}")
    rules = rules_for(cfg, mesh, kind, batch)
    prules = param_rules(rules, cfg, mesh)
    split = frozenset(k for k in MODEL_AXES if model > 1
                      and "model" in prules.get(k, ()))
    whole = frozenset({"SSD"} if model > 1 and cfg.ssm is not None
                      and not set(SSD_AXES) <= split else ())
    d, m = divmod(rank, model)
    return ShardLayout(data=data, model=model, data_rank=d, model_rank=m,
                       batch_split="data" in normalize(rules["batch"]),
                       split=split,
                       kv_seq=model > 1 and "model" in normalize(
                           rules["kv_seq"]),
                       whole=whole, group=group, data_group=data_group)


# ---------------------------------------------------------------------------
# The gradient classes of a split model's parameters
# ---------------------------------------------------------------------------

# a rank's gradient of a parameter it holds cut: its own part, complete
CUT = "cut"
# of a parameter held whole whose consumers are whole: complete, the same
# on every rank of the model group
WHOLE = "whole"
# of a parameter held whole whose consumers are split (each rank feeds it
# only its own heads, experts or columns): a share, summed over the group
PARTIAL = "partial"

# the sub-layers a layout splits; a parameter's sub-layer is its name up to
# the first of these
SUBLAYERS = ("attn", "xattn", "ssm", "ffn")


class GradClass(NamedTuple):
    """How one rank's gradient of a parameter relates to the unsplit
    model's: ``kind`` is :data:`CUT`, :data:`WHOLE` or :data:`PARTIAL`.
    A :data:`CUT` parameter's ``runs`` are its local runs along
    ``cut.dim``, ``(start, length, whole)`` each: a run held whole on
    every rank (a :class:`Segments` run that is not split, as SSD's
    ``B`` and ``C``) feeds the rank's split heads only, so its gradient
    is partial too."""
    kind: str
    cut: Optional[Cut] = None
    runs: Tuple[Tuple[int, int, bool], ...] = ()

    @property
    def whole_runs(self) -> Tuple[Tuple[int, int], ...]:
        return tuple((s, n) for s, n, whole in self.runs if whole)


def _sublayer(name: str) -> Optional[str]:
    parts = name.split(".")
    for i, part in enumerate(parts[:-1]):
        if part in SUBLAYERS:
            return ".".join(parts[:i + 1])
    return None


def grad_classes(model) -> Dict[str, GradClass]:
    """Parameter name -> its :class:`GradClass` on ``model`` (a rank's
    slice, ``model.layout``), from the layout's cut of each parameter and
    the sub-layer it belongs to (its name; ``Model.specs()`` gives the
    axes the cut follows). A parameter the layout cuts is :data:`CUT`. A
    parameter held whole in a sub-layer (GQA, MLA, SSD, an FFN) of which
    the layout cuts another parameter feeds that sub-layer's split
    products alone, and is :data:`PARTIAL`: GQA's ``wk``/``wv`` where the
    audit keeps ``kv_heads`` whole, MLA's latent projections and norms,
    the MoE router (its gates weigh a rank's own experts only) and shared
    experts held whole (run on model rank 0 alone). Every other
    parameter (norms, a layer held whole, the frontends; everything
    without a model group) is :data:`WHOLE`."""
    cuts = {name: model.cut_of(name) for name, _ in model.named_parameters()}
    split = {_sublayer(name) for name, cut in cuts.items()
             if cut is not None} - {None}
    out = {}
    for name, cut in cuts.items():
        if cut is None:
            out[name] = GradClass(PARTIAL if _sublayer(name) in split
                                  else WHOLE)
            continue
        seg = model.segments(name)
        flags = seg.split if seg is not None else (True,)
        runs, at = [], 0
        for (_, n), cut_run in zip(cut.pieces, flags):
            runs.append((at, n, not cut_run))
            at += n
        out[name] = GradClass(CUT, cut, tuple(runs))
    return out
