"""The traced run's reduction: device operations by batch, busy time,
idle gaps named by what the harness was doing on the host.

The harness records spans only around its own calls (``SPANS``): the
call into ``decode``, the wait for the batch's RGB, and the loop's own
work between batches. ``torch.profiler`` puts them and the card's
operations (kernels, copies, fills; graph replays' kernels too) on one
clock. A batch's operations are those that start inside the profiler's
mirror of its decode span on the device: the device's own record of the
work launched in that span, on the device's clock. Host spans cut the
batches only where there are no mirrors (a trace without a card): the
two clocks are aligned only approximately, and an offset longer than a
batch's last operation moves that operation into the next batch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

SPAN_DECODE, SPAN_WAIT, SPAN_LOOP = "bench.decode", "bench.wait", "bench.loop"
SPANS = (SPAN_DECODE, SPAN_WAIT, SPAN_LOOP)
BREAKDOWN_ENTRIES = 10
NAME_CHARS = 120


@dataclasses.dataclass(frozen=True)
class Op:
    name: str
    start_us: float
    end_us: float

    @property
    def us(self) -> float:
        return self.end_us - self.start_us


@dataclasses.dataclass
class Trace:
    """What one traced stretch of the window held."""

    batches: List[List[Op]]     # each traced batch's device operations
    busy_s: float
    window_s: float
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


def _merge(intervals: Sequence[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(device: Sequence[Op], spans: Sequence[Op],
           marks: Sequence[Op] = ()) -> Trace:
    """Reduce a traced stretch: ``device`` the card's operations,
    ``spans`` the harness's spans (``SPANS``) on the host, ``marks`` the
    mirrors of the decode spans on the device, all in profiler us."""
    spans = sorted(spans, key=lambda s: s.start_us)
    t0 = min(s.start_us for s in spans)
    t1 = max(s.end_us for s in spans)
    ordered = sorted(device, key=lambda op: op.start_us)
    inside = [op for op in ordered if op.end_us > t0 and op.start_us < t1]
    if marks:
        bounds = _merge([(m.start_us, m.end_us) for m in marks])
    else:
        # a batch runs from its decode span's start to its wait span's end
        bounds, open_at = [], None
        for s in spans:
            if s.name == SPAN_DECODE:
                open_at = s.start_us
            elif s.name == SPAN_WAIT and open_at is not None:
                bounds.append((open_at, s.end_us))
                open_at = None
    batches: List[List[Op]] = [[] for _ in bounds]
    k = 0
    for op in ordered:
        while k < len(bounds) and op.start_us >= bounds[k][1]:
            k += 1
        if k < len(bounds) and op.start_us >= bounds[k][0]:
            batches[k].append(op)
    busy = _merge([(max(op.start_us, t0), min(op.end_us, t1))
                   for op in inside])
    by_name: Dict[str, float] = {}
    for op in inside:
        by_name[op.name] = by_name.get(op.name, 0.0) + op.us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]

    def doing(a: float, b: float) -> str:
        mid = (a + b) / 2
        for s in spans:
            if s.start_us <= mid < s.end_us:
                return s.name
        return "bench.between"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:BREAKDOWN_ENTRIES]
    return Trace(
        batches=batches,
        busy_s=sum(b - a for a, b in busy) / 1e6,
        window_s=(t1 - t0) / 1e6,
        device_ops=[(name[:NAME_CHARS], us / 1e6) for name, us in top],
        idle_gaps=[(doing(a, b), (b - a) / 1e6) for a, b in longest])


def from_profiler(prof) -> Tuple[List[Op], List[Op], List[Op]]:
    """(device operations, harness spans, the decode spans' mirrors on
    the device) of a stopped ``torch.profiler.profile``."""
    from torch.autograd import DeviceType
    device, spans, marks = [], [], []
    for e in prof.events():
        op = Op(e.name, float(e.time_range.start), float(e.time_range.end))
        if e.name in SPANS:
            # the profiler mirrors a host span on the device over the work
            # launched in it: that is no operation of the card's
            if e.device_type != DeviceType.CUDA:
                spans.append(op)
            elif e.name == SPAN_DECODE:
                marks.append(op)
        elif e.device_type == DeviceType.CUDA:
            device.append(op)
    return device, spans, marks


def first_index(ops: Sequence[Op], patterns: Sequence[str]) -> int:
    """Index of the first operation whose name holds one of ``patterns``,
    -1 where none does."""
    return next((i for i, op in enumerate(ops)
                 if any(p in op.name for p in patterns)), -1)


def last_index(ops: Sequence[Op], patterns: Sequence[str]) -> int:
    """Index of the last operation whose name holds one of ``patterns``,
    -1 where none does."""
    return next((i for i in range(len(ops) - 1, -1, -1)
                 if any(p in ops[i].name for p in patterns)), -1)
