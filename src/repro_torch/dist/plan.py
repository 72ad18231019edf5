"""Lane-permutation plans: balance skewed chunk lanes across lane blocks.

The lane-balance half of the JAX package's ``dist/plan.py`` (numpy; its
logical sharding rules are JAX-only and not ported).

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
from typing import List, Optional, Sequence

import numpy as np
import torch

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
