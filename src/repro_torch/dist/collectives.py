"""Collective traffic of a step, counted as the step runs.

The port of the JAX package's ``dist/collectives.py``. There the dry run
parses the partitioned HLO text for each collective instruction's
result; here the dry run (``launch.dryrun``) runs the port's own step
over a ``torch.distributed`` process group, and :class:`CollectiveCounter`
(a ``TorchDispatchMode``) records every ``c10d`` op the step makes: its
kind, its bytes and its group. The bytes are those of the op's first
argument, which holds its result, as the JAX package counts a result
once: an all-reduce's whole operand, an all-gather's gathered output, a
reduce-scatter's scattered output, a broadcast's tensor, a receive's
buffer. A send is not counted: its bytes are the receiver's.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# c10d op -> kind: the JAX package's kind names, and a broadcast and a
# reduce, which XLA's HLO has not
_OPS = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "recv_": "collective-permute",
    "recv_any_source_": "collective-permute",
    "broadcast_": "broadcast",
    "reduce_": "reduce",
}


class Collective(NamedTuple):
    kind: str
    nbytes: int
    group: str


def _group_name(args) -> Optional[str]:
    from torch._C._distributed_c10d import ProcessGroup
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return ProcessGroup.unbox(a).group_name
            except RuntimeError:  # a ReduceOp or another custom class
                continue
    return None


class CollectiveCounter(TorchDispatchMode):
    """While active, every ``c10d`` op is recorded as a
    :class:`Collective` in ``events``, its bytes times ``repeat`` (a
    count that stands for ``repeat`` equal runs: :meth:`repeating`).
    ``groups`` names the process groups (label -> group): an op's group
    is its label, the process group's name where it has none."""

    def __init__(self, groups: Optional[Dict[str, object]] = None):
        super().__init__()
        self.labels = {g.group_name: label
                       for label, g in (groups or {}).items()
                       if g is not None}
        self.events: List[Collective] = []
        self.repeat = 1

    @contextlib.contextmanager
    def repeating(self, n: int) -> Iterator[None]:
        """Count what runs inside as ``n`` runs of it."""
        was, self.repeat = self.repeat, self.repeat * n
        try:
            yield
        finally:
            self.repeat = was

    def record(self, func, args) -> bool:
        """Record ``func`` if it is a collective; whether it was."""
        if func.namespace != "c10d":
            return False
        kind = _OPS.get(func.overloadpacket.__name__)
        if kind is not None:
            nbytes = sum(t.numel() * t.element_size()
                         for t in tree_leaves(args[0])
                         if isinstance(t, torch.Tensor))
            name = _group_name(args)
            self.events.append(Collective(
                kind, nbytes * self.repeat, self.labels.get(name, name)))
        return True

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.record(func, args)
        return func(*args, **(kwargs or {}))


def summarize(counter: CollectiveCounter) -> Tuple[int, Dict[str, int]]:
    """(total collective bytes, {kind: bytes}), zero-traffic kinds
    omitted, as the JAX package's ``summarize`` gives them."""
    per: Dict[str, int] = defaultdict(int)
    for e in counter.events:
        per[e.kind] += e.nbytes
    per = {k: v for k, v in per.items() if v}
    return sum(per.values()), per


def by_group(counter: CollectiveCounter) -> Dict[str, int]:
    """{group: bytes}, zero-traffic groups omitted."""
    per: Dict[str, int] = defaultdict(int)
    for e in counter.events:
        per[e.group] += e.nbytes
    return {k: v for k, v in per.items() if v}
