"""Contract checker over what a decode really runs
(``python -m repro_torch.analysis contracts``).

The counterpart of the JAX package's ``analysis/jaxpr_check.py``, with its
:class:`Violation` and :class:`Access` records, its cell labels
(``shape.label()/sync/backend/mode[/extra]``) and its :func:`run` and
:func:`run_self_test`. Where the JAX checker walks the jaxprs its decode
stages, the port has no jaxpr. It reads instead, for a grid of decoders
(:func:`tier0_decoders`):

* the aten ops a decode dispatches, through a ``TorchDispatchMode``
  (:class:`TaintTracker`);
* the kernel launches, which ``ctypes`` makes past the dispatcher, through
  ``kernels.build``'s launch recorder (``build.recording_launches``);
* the CUDA graphs that its Jacobi rounds capture on the card
  (``core.sync._graph_pairs``), through :class:`GraphAuditor`, which reads
  each graph's nodes with ``kernels.huffman.ops.graph_nodes``.

The contracts (``core.contracts.TRACE_CONTRACTS``):

* **identity-lane-graph**, the "gather creep" regression the JAX checker
  was written for. The plan buffers of ``LANE_GRAPH_ARRAYS`` are
  *tainted*, per tensor storage, once ``dec.dev`` has bound and uploaded
  them; every op's outputs, and every argument its schema marks as
  written (in-place ops, ``out=``), get the union of its inputs' taints
  (a fresh output's taint replaces what its address held before), and a
  kernel launch spreads the union of its operands' taints over all of
  them, as the JAX checker treats a ``pallas_call``. An op of
  :data:`INDEXED_OPS` whose index operand is tainted is an
  :class:`Access`. An identity plan's decode may index only through
  ``IDENTITY_LIVE_OK[sync]``; a permuted plan's must show a tainted
  access (the flip check). An op that takes an index operand but is not
  in the table is a violation too, so the table cannot fall behind the
  code.
* **no-f64**: no float64 tensor in or out of any op or kernel launch of
  the entropy stage (``ParallelDecoder.coefficients``, the JAX checker's
  ``coeffs_fn``).
* **no-host-read**, in place of no-host-callback: between the plan upload
  and the entropy stage's return, no ``.item()``, ``nonzero``,
  ``masked_select``, boolean-mask index or copy of a device tensor to the
  CPU, but ``core.sync.host_check``'s own reads, which number the
  decode's ``RoundBlocks.checks``. On the card, the syncs that
  ``torch.cuda.set_sync_debug_mode("warn")`` sees (it sees syncs made in
  C++ too) are held to the same count.
* **graph-buffers**, in place of words-donated: (a) every graph of a
  program's sync rounds holds kernel, memset and device-to-device copy
  nodes only, and two nodes of the exit kernel on the kernel backend;
  (b) before each replay, the pointers those exit nodes read and write
  are the program's buffers and compact tables at their current
  addresses, or the graph's own temporaries (its memory pool), and no
  graph of replaced compact tables is left; off the card, the program's
  buffers keep their addresses from decode to decode; (c) after a replay
  the exits lie in one of the program's two exit buffers; (d) nothing a
  decode returns (coefficients, RGB, planes) shares storage with a
  program buffer.
* **int32-lattice**: ``contracts.check_index_lattice`` over every shape
  of the grid and the largest ladder rung the runtime guard admits.

Two contracts run on a decode over a mesh of two blocks or more
(``ParallelDecoder.decode_on``, :func:`check_mesh`), on cards or on CPU
blocks, and are not applicable to a mesh of one:

* **collective-accounting**: a :class:`MeshTracker` counts the bytes of
  every copy from one block's buffers into another's (the halo exchange,
  specmap's phase maps, the sequence sums, the sequences' spans and the
  rows sent to their owners, by the buffer they land in); they equal the
  program's own account (``DecodeOutput.mesh["expected_bytes"]``, worked
  out from the layout and the pieces' sizes the write pass reads), per
  exchange of the rounds and per write pass; and the taint
  of each block's lane graph reaches the halo of every block that reads
  it (the copies between blocks carry taint, across cards too).
* **words-donated-mesh**, the mesh half of words-donated: nothing a mesh
  decode returns shares storage with any block's buffers, and on the
  card each block's round graphs read only that block's buffers and
  compact tables, or the graph's own temporaries.

The checker runs on the card unless asked for the CPU (``device="cpu"``,
``--device cpu``), where the grid has the plain backend only and no graph.
Decodes outside the checker run the same code: the graph audit is an
opt-in of ``RoundBlocks`` (``DecodeProgram.audit``), and the launch
recorder is off but in the thread that installs it.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import inspect
import sys
import time
import warnings
from pathlib import Path
from typing import (Callable, Dict, FrozenSet, Iterator, List, Optional,
                    Sequence, Set, Tuple)

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from . import contracts
from ..core import decode as D
from ..core import sync as SY
from ..core import mesh_decode as MD
from ..core.api import (ParallelDecoder, clear_decode_programs,
                        discard_decode_programs, lut_tables, mesh_program,
                        resolve_device, run_sync)
from ..core.bitstream import bucket_capacity
from ..core.state import DecodeState
from ..jpeg.encoder import DatasetSpec, build_dataset
from ..kernels import build as B
from ..kernels.huffman import ops as HK
from ..launch.mesh import Mesh, make_host_mesh

SYNCS = ("jacobi", "faithful", "sequential", "specmap")

#: aten ops (by overload packet) that index, and the argument that holds
#: the index: where a tainted operand makes an :class:`Access`. The decode
#: reaches ``index`` (``_gather``, ``lane_subset``, ``chunk_write_bases``),
#: ``index_put_`` (``_scatter_where``, ``scatter_streams``, ``decode_span``),
#: ``index_select`` (``chunk_meta``) and ``gather`` (specmap's ``sel``,
#: ``compose_prefix``, ``undiff_dc``).
INDEXED_OPS: Dict[str, str] = {
    "index": "indices", "_unsafe_index": "indices",
    "index_put": "indices", "index_put_": "indices",
    "_index_put_impl_": "indices", "_unsafe_index_put": "indices",
    "gather": "index", "index_select": "index", "take": "index",
    "scatter": "index", "scatter_": "index", "scatter_add": "index",
    "scatter_add_": "index", "scatter_reduce": "index",
    "scatter_reduce_": "index", "index_add": "index", "index_add_": "index",
    "index_copy": "index", "index_copy_": "index", "index_fill": "index",
    "index_fill_": "index", "index_reduce": "index",
    "index_reduce_": "index", "put": "index", "put_": "index",
    "embedding": "indices",
}
# ops that read a device value to the host, whatever their operands
HOST_READ_OPS = frozenset({"_local_scalar_dense", "nonzero", "masked_select",
                           "equal", "_unique", "_unique2", "unique_dim",
                           "unique_consecutive"})
# indexing ops whose boolean mask index is a host read (nonzero)
MASK_INDEX_OPS = frozenset({"index", "index_put", "index_put_",
                            "_index_put_impl_"})
# copies, which read to the host when their source is on a device and
# their destination on the CPU
COPY_OPS = frozenset({"_to_copy", "copy_", "_copy_from",
                      "_copy_from_and_resize"})

# cudaGraphNodeType -> name (csrc/huffman.cu rt_graph_nodes, word 0)
NODE_TYPES = {0: "kernel", 1: "copy", 2: "memset", 3: "host", 4: "child graph",
              5: "empty", 6: "event wait", 7: "event record",
              8: "semaphore signal", 9: "semaphore wait", 10: "memory alloc",
              11: "memory free", 12: "batch memop", 13: "conditional"}
# cudaMemoryType -> name (words 1 and 2 of a copy node)
MEMORY_TYPES = {0: "host", 1: "pinned host", 2: "device", 3: "managed"}
# the node kinds a graph of sync rounds may hold
GRAPH_NODE_KINDS = frozenset({"kernel", "exit kernel", "memset",
                              "device copy"})
# exit-kernel nodes in a graph of two rounds on the kernel backend
EXIT_NODES_PER_GRAPH = 2

_HOST_CHECK_CODE = SY.host_check.__code__
_HOST_CHECK_LINES, _first = inspect.getsourcelines(SY.host_check)
_HOST_CHECK_LINES = range(_first, _first + len(_HOST_CHECK_LINES))
_SYNC_FILE = Path(SY.__file__).resolve()
_PACKAGE = Path(__file__).resolve().parents[1]
_SYNC_WARNING = "called a synchronizing CUDA operation"


@dataclasses.dataclass(frozen=True)
class Access:
    """One indexed op whose index operand is tainted."""
    prim: str                 # the aten op (overload packet)
    taint: FrozenSet[str]


@dataclasses.dataclass(frozen=True)
class Violation:
    contract: str
    cell: str
    detail: str

    def format(self) -> str:
        return f"[{self.contract}] {self.cell}: {self.detail}"


class GraphAuditError(RuntimeError):
    """A graph's replay was refused by the graph-buffers contract."""

    def __init__(self, violations: List[Violation]):
        super().__init__("; ".join(v.format() for v in violations))
        self.violations = violations


# ---------------------------------------------------------------------------
# The dispatch mode: taint, dtypes and host reads of every op
# ---------------------------------------------------------------------------

_EMPTY: FrozenSet[str] = frozenset()


def _tensors(x) -> List[torch.Tensor]:
    """The tensors in an op's arguments or results (lists and tuples of
    tensors flattened; aten nests no deeper)."""
    if isinstance(x, torch.Tensor):
        return [x]
    out = []
    if isinstance(x, (list, tuple)):
        for v in x:
            if isinstance(v, torch.Tensor):
                out.append(v)
            elif isinstance(v, (list, tuple)):
                out += [t for t in v if isinstance(t, torch.Tensor)]
    return out


def _key(t: torch.Tensor) -> int:
    """What a tensor's taint is kept under: its storage's address (views
    share it; host and device addresses never coincide under the card's
    unified addressing); 0 for a tensor that holds no memory."""
    return t.untyped_storage().data_ptr()


class _OpInfo:
    """What the tracker needs of an op's schema, worked out once per op."""

    __slots__ = ("name", "index", "unlisted", "written", "host", "copy",
                 "mask")

    def __init__(self, func):
        self.name = func.overloadpacket.__name__
        args = func._schema.arguments
        want = INDEXED_OPS.get(self.name)
        self.index = tuple((i, a.name) for i, a in enumerate(args)
                           if a.name == want)
        self.unlisted = want is None and any(
            a.name in ("index", "indices") and "Tensor" in str(a.type)
            for a in args)
        self.written = tuple((i, a.name) for i, a in enumerate(args)
                             if a.alias_info is not None
                             and a.alias_info.is_write)
        self.host = self.name in HOST_READ_OPS
        self.copy = self.name in COPY_OPS
        self.mask = self.name in MASK_INDEX_OPS


_OP_INFO: Dict[int, _OpInfo] = {}


def _arg(args, kwargs, pos: int, name: str):
    return args[pos] if pos < len(args) else kwargs.get(name)


def _caller() -> Tuple[bool, str]:
    """Whether ``core.sync.host_check`` is on the stack, and the innermost
    frame of the package outside this module, as ``file:line``."""
    sanctioned, where = False, "?"
    f = sys._getframe(2)
    while f is not None:
        if f.f_code is _HOST_CHECK_CODE:
            sanctioned = True
        path = Path(f.f_code.co_filename)
        if where == "?" and _PACKAGE in path.parents \
                and path.name != "trace_check.py":
            where = f"{path.relative_to(_PACKAGE.parent)}:{f.f_lineno}"
        f = f.f_back
    return sanctioned, where


class TaintTracker(TorchDispatchMode):
    """Follows the lane-graph taint through a decode, and records its
    indexed accesses, float64 tensors and host reads.

    ``seeds`` maps a taint name to the tensor that carries it. Enter it
    with :func:`tracing`, which also installs it as the thread's launch
    recorder. It keeps a reference to every tensor an op makes, so that
    no address is reused while it runs (a fresh output then never lands
    on a tainted address, and its taint is the union of its op's inputs'
    alone), and does no device work itself (no copy, allocation or sync):
    it may run while a CUDA graph is captured.
    """

    def __init__(self, seeds: Optional[Dict[str, torch.Tensor]] = None):
        super().__init__()
        self.taint: Dict[int, FrozenSet[str]] = {}
        self.keep: List[torch.Tensor] = []
        self.accesses: Set[Access] = set()
        self.indexed: Set[str] = set()    # every indexed op, tainted or not
        self.unlisted: Set[str] = set()
        self.f64: List[str] = []
        self.host_reads: List[str] = []   # not host_check's
        self.sanctioned = 0               # host_check's reads seen
        self.launches: Dict[str, int] = collections.Counter()
        self.ops = 0
        self._pending: List[torch.Tensor] = []
        for name, t in (seeds or {}).items():
            k = _key(t)
            if k:
                self.taint[k] = self.taint.get(k, _EMPTY) | {name}
                self.keep.append(t)

    def taint_of(self, t: torch.Tensor) -> FrozenSet[str]:
        return self.taint.get(_key(t), _EMPTY)

    def _union(self, ts) -> FrozenSet[str]:
        u, taint = _EMPTY, self.taint
        for t in ts:
            v = taint.get(t.untyped_storage().data_ptr())
            if v:
                u = u | v
        return u

    def _spread(self, ts, taint: FrozenSet[str]) -> None:
        """Give ``taint`` to ``ts`` (a non-empty union of the inputs of the
        op that wrote them)."""
        for t in ts:
            k = _key(t)
            if k:
                self.taint[k] = taint

    def _f64(self, what: str, ts) -> None:
        for t in ts:
            if t.dtype is torch.float64:
                self.f64.append(f"{what}: float64 {tuple(t.shape)}")

    def _host_read(self, what: str) -> None:
        sanctioned, where = _caller()
        if sanctioned:
            self.sanctioned += 1
        else:
            self.host_reads.append(f"{what} at {where}")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        info = _OP_INFO.get(id(func))   # ops live as long as torch
        if info is None:
            info = _OP_INFO[id(func)] = _OpInfo(func)
        ins = _tensors(args)
        if kwargs:
            ins += _tensors(tuple(kwargs.values()))
        outs = _tensors(out)
        if info.index:
            self.indexed.add(info.name)
            idx = [t for pos, nm in info.index
                   for t in _tensors(_arg(args, kwargs, pos, nm))]
            hit = self._union(idx)
            if hit:
                self.accesses.add(Access(info.name, hit))
            if info.mask and any(t.dtype in (torch.bool, torch.uint8)
                                 for t in idx):
                self._host_read(f"boolean-mask aten.{info.name}")
        elif info.unlisted:
            self.unlisted.add(info.name)
        if info.host:
            self._host_read(f"aten.{info.name}")
        elif info.copy and ins and outs:
            src = ins[1] if info.name == "copy_" else ins[0]
            if src.is_cuda and not outs[0].is_cuda:
                self._host_read(f"aten.{info.name} from {src.device} to "
                                f"the CPU")
        self._f64(f"aten.{info.name}", ins)
        self._f64(f"aten.{info.name}", outs)
        u = self._union(ins)
        if u:
            self._spread(outs, u)
            for pos, nm in info.written:
                self._spread(_tensors(_arg(args, kwargs, pos, nm)), u)
        self.keep += outs
        return out

    # the launch recorder (kernels.build.recording_launches)
    def operand(self, t: torch.Tensor) -> None:
        self._pending.append(t)

    def launch(self, what: str) -> None:
        ts, self._pending = self._pending, []
        self.launches[what] += 1
        self._f64(what, ts)
        u = self._union(ts)
        if u:
            self._spread(ts, u)


@contextlib.contextmanager
def tracing(tracker: TaintTracker) -> Iterator[TaintTracker]:
    """Run the block under ``tracker``: its ops through the dispatch mode,
    its kernel launches through the launch recorder."""
    with tracker, B.recording_launches(tracker):
        yield tracker


@contextlib.contextmanager
def sync_warnings(enabled: bool) -> Iterator[list]:
    """The syncs of the block, as ``torch.cuda.set_sync_debug_mode("warn")``
    reports them (an empty list unless ``enabled``)."""
    if not enabled:
        yield []
        return
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as ws:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield ws
        finally:
            torch.cuda.set_sync_debug_mode(prev)


def _syncs(ws) -> Tuple[int, List[str]]:
    """(host_check's syncs, the others as ``file:line``) of recorded
    warnings."""
    ours, others = 0, []
    for w in ws:
        if _SYNC_WARNING not in str(w.message):
            continue
        path = Path(w.filename).resolve()
        if path == _SYNC_FILE and w.lineno in _HOST_CHECK_LINES:
            ours += 1
        else:
            others.append(f"{path.name}:{w.lineno}")
    return ours, others


@dataclasses.dataclass
class Trace:
    """What one traced stretch of a decode did."""
    tracker: TaintTracker
    host_checks: int          # core.sync.host_check calls
    syncs: Tuple[int, List[str]] = (0, [])


@contextlib.contextmanager
def traced(seeds: Dict[str, torch.Tensor], cuda: bool) -> Iterator[Trace]:
    """Run the block under a fresh :class:`TaintTracker` seeded with
    ``seeds`` (and, with ``cuda``, the sync debug mode); the
    :class:`Trace` is complete when the block ends."""
    trace = Trace(TaintTracker(seeds), 0)
    count = SY.host_check.count
    with sync_warnings(cuda) as ws, tracing(trace.tracker):
        yield trace
    trace.host_checks = SY.host_check.count - count
    trace.syncs = _syncs(ws)


def lane_graph_seeds(dev: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The taint seeds of a bound program's buffers: its lane-graph
    arrays, each under its own name."""
    return {k: dev[k] for k in contracts.LANE_GRAPH_ARRAYS if k in dev}


def check_lane_graph(accesses: Sequence[Access], sync: str, permuted: bool,
                     cell: str) -> List[Violation]:
    """The identity-lane-graph contract over a decode's accesses."""
    if permuted:
        if any(a.taint for a in accesses):
            return []
        return [Violation(
            "identity-lane-graph", cell,
            "permuted program shows NO lane-graph-tainted indexed access: "
            "the contract cannot flip, so the checker is vacuous (taint "
            "mapping broke?)")]
    allowed = contracts.identity_live_ok(sync)
    bad = sorted({f"{a.prim}[{'+'.join(sorted(a.taint - allowed))}]"
                  for a in accesses if a.taint - allowed})
    if not bad:
        return []
    return [Violation(
        "identity-lane-graph", cell,
        f"identity program indexes through lane-graph operands: "
        f"{', '.join(bad)} (allowed for {sync}: "
        f"{sorted(allowed) or 'none'}): the gather-creep regression")]


def check_trace(trace: Trace, cell: str, sync: str, permuted: bool,
                checks: int, cuda: bool) -> List[Violation]:
    """Every contract a traced stretch of the entropy stage answers:
    identity-lane-graph, no-f64 and no-host-read (``checks``: the
    ``RoundBlocks.checks`` of the stretch)."""
    tr = trace.tracker
    out = check_lane_graph(sorted(tr.accesses, key=repr), sync, permuted,
                           cell)
    if tr.unlisted:
        out.append(Violation(
            "identity-lane-graph", cell,
            f"ops with an index operand that INDEXED_OPS lacks: "
            f"{sorted(tr.unlisted)}"))
    if tr.f64:
        out.append(Violation("no-f64", cell,
                             f"float64 in the entropy stage: "
                             f"{sorted(set(tr.f64))[:4]}"))
    if tr.host_reads:
        out.append(Violation("no-host-read", cell,
                             f"host reads besides host_check's: "
                             f"{sorted(set(tr.host_reads))[:4]}"))
    if trace.host_checks != checks:
        out.append(Violation(
            "no-host-read", cell,
            f"{trace.host_checks} host_check reads, RoundBlocks.checks "
            f"{checks}"))
    if cuda:
        ours, others = trace.syncs
        if others:
            out.append(Violation("no-host-read", cell,
                                 f"syncs besides host_check's: "
                                 f"{others[:4]}"))
        if ours != checks or tr.sanctioned != checks:
            out.append(Violation(
                "no-host-read", cell,
                f"host_check synced {ours} times and copied to the host "
                f"{tr.sanctioned} times, RoundBlocks.checks {checks}"))
    return out


# ---------------------------------------------------------------------------
# graph-buffers: the program's buffers and the graphs that read them
# ---------------------------------------------------------------------------

def program_buffers(program) -> Dict[str, torch.Tensor]:
    """A program's buffers by name (``plan.words``, ``work.meta.ts``,
    ``work.exits0.p``, ...)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(name: str, v) -> None:
        if isinstance(v, torch.Tensor):
            out[name] = v
        elif isinstance(v, dict):
            for k, x in v.items():
                walk(f"{name}.{k}", x)
        elif hasattr(v, "_fields"):  # a DecodeState
            for k in v._fields:
                walk(f"{name}.{k}", getattr(v, k))
        else:
            for i, x in enumerate(v):
                walk(f"{name}{i}", x)

    walk("plan", program.plan or {})
    walk("work", program.work)
    return out


def buffer_pointers(program) -> Dict[str, int]:
    return {k: t.data_ptr() for k, t in program_buffers(program).items()}


def check_addresses(program, before: Dict[str, int],
                    cell: str) -> List[Violation]:
    """graph-buffers (b) off the card: the program's buffers still lie
    where ``before`` found them, and it allocated once."""
    now = buffer_pointers(program)
    moved = sorted(k for k in before if now.get(k) != before[k])
    out = []
    if moved:
        out.append(Violation(
            "graph-buffers", cell,
            f"program buffers reallocated between decodes: {moved[:4]}"))
    if program.allocations != 1:
        out.append(Violation("graph-buffers", cell,
                             f"program allocated {program.allocations} "
                             f"times"))
    return out


def check_outputs(out, program, cell: str) -> List[Violation]:
    """graph-buffers (d): no tensor a decode returns shares storage with
    a program buffer."""
    spans = []
    for name, t in program_buffers(program).items():
        s = t.untyped_storage()
        spans.append((name, t.device, s.data_ptr(), s.data_ptr() + s.nbytes()))
    fields = [("coeffs", out.coeffs), ("rgb", out.rgb)] + [
        (f"planes[{i}]", p) for i, p in enumerate(out.planes or [])]
    bad = []
    for field, t in fields:
        if t is None:
            continue
        s = t.untyped_storage()
        lo, hi = s.data_ptr(), s.data_ptr() + s.nbytes()
        bad += [f"{field} shares {name}" for name, dev, a, b in spans
                if dev == t.device and lo < b and a < hi]
    if not bad:
        return []
    return [Violation("graph-buffers", cell,
                      f"a decode returns program memory: {bad[:4]}")]


def node_kind(row: Sequence[int]) -> str:
    """A graph node's kind, from its ``graph_nodes`` row."""
    t = int(row[0])
    if t == 0:
        return "exit kernel" if int(row[1]) == 1 else "kernel"
    if t == 1:
        src = MEMORY_TYPES.get(int(row[1]), f"memory {int(row[1])}")
        dst = MEMORY_TYPES.get(int(row[2]), f"memory {int(row[2])}")
        return "device copy" if src == dst == "device" else \
            f"copy {src} -> {dst}"
    return NODE_TYPES.get(t, f"node type {t}")


def classify_nodes(rows, exit_nodes: int, cell: str
                   ) -> Tuple[Dict[str, int], List[Violation]]:
    """graph-buffers (a) over a graph's ``graph_nodes`` rows: the node
    counts by kind, and a violation for a kind that is not a kernel,
    memset or device-to-device copy, or for another number of exit-kernel
    nodes than ``exit_nodes``."""
    kinds = collections.Counter(node_kind(r) for r in rows)
    out = []
    bad = {k: n for k, n in kinds.items() if k not in GRAPH_NODE_KINDS}
    if bad:
        out.append(Violation("graph-buffers", cell,
                             f"graph holds nodes other than kernels, "
                             f"memsets and device copies: {bad}"))
    if kinds["exit kernel"] != exit_nodes:
        out.append(Violation("graph-buffers", cell,
                             f"graph holds {kinds['exit kernel']} exit-kernel "
                             f"nodes, expected {exit_nodes}"))
    return dict(kinds), out


def pool_spans(graph) -> List[Tuple[int, int]]:
    """The address spans of a graph's private memory pool (its captured
    temporaries), from the caching allocator's snapshot."""
    pool = tuple(graph.pool())
    return [(s["address"], s["address"] + s["total_size"])
            for s in torch.cuda.memory_snapshot()
            if tuple(s.get("segment_pool_id", ())) == pool]


@dataclasses.dataclass
class _GraphRecord:
    exits: List[List[int]]            # the exit nodes' rows
    live: Dict[str, int]              # the program's pointers at capture
    pool: List[Tuple[int, int]]       # the graph's own memory
    kinds: Dict[str, int]


def check_exit_pointers(rec: _GraphRecord, now: Dict[str, int],
                        table: Optional[int], lanes: int,
                        cell: str) -> List[Violation]:
    """graph-buffers (b): each exit node's pointers are the program's
    buffers where they lie ``now`` (``table``: the compact tables of the
    replaying key), or the graph's own memory."""
    at_capture: Dict[int, List[str]] = collections.defaultdict(list)
    for name, p in rec.live.items():
        at_capture[p].append(name)
    bad = []
    for row in rec.exits:
        if int(row[3]) != lanes:
            bad.append(f"exit node over {int(row[3])} lanes, program has "
                       f"{lanes}")
        for op, p in zip(HK.EXIT_NODE_POINTERS, (int(v) for v in row[4:])):
            if op == "luts_compact":
                if p != table:
                    bad.append(f"{op} at {p:#x}, the key's tables at "
                               f"{table or 0:#x}")
            elif p in at_capture:
                names = at_capture[p]
                if not any(now.get(n) == p for n in names):
                    bad.append(f"{op} reads {names[0]} at {p:#x}, which "
                               f"now lies at {now.get(names[0], 0):#x}")
            elif not any(a <= p < b for a, b in rec.pool):
                bad.append(f"{op} at {p:#x} is neither a program buffer nor "
                           f"the graph's own memory")
    if not bad:
        return []
    return [Violation("graph-buffers", cell,
                      f"a replay would read stale memory: {bad[:4]}")]


class GraphAuditor:
    """``RoundBlocks.audit`` of one program (``DecodeProgram.audit``):
    reads each graph at capture (graph-buffers (a)), checks its exit
    nodes' pointers before each replay and refuses the replay on a
    violation ((b)), and checks where the exits lie after it ((c))."""

    def __init__(self, program, cell: str):
        self.program = program
        self.cell = cell
        self.exit_nodes = EXIT_NODES_PER_GRAPH if program.backend == "cuda" \
            else 0
        self.records: Dict[Tuple, _GraphRecord] = {}
        self.violations: List[Violation] = []
        self.replays = 0

    def captured(self, key: Tuple, graph) -> None:
        rows = HK.graph_nodes(graph).tolist()
        kinds, vs = classify_nodes(rows, self.exit_nodes, self.cell)
        self.violations += vs
        self.records[key] = _GraphRecord(
            [r for r in rows if node_kind(r) == "exit kernel"],
            buffer_pointers(self.program), pool_spans(graph), kinds)

    def check_replay(self, key: Tuple) -> List[Violation]:
        rec = self.records.get(key)
        if rec is None:
            return [Violation("graph-buffers", self.cell,
                              f"graph {key} replays but was not read at "
                              f"its capture")]
        out = []
        stale = [k for k in self.program.graphs if k[:-1] != key[:-1]]
        if stale:
            out.append(Violation("graph-buffers", self.cell,
                                 f"{len(stale)} graphs of replaced compact "
                                 f"tables remain"))
        table = key[0][0] if key[0] is not None else None
        return out + check_exit_pointers(
            rec, buffer_pointers(self.program), table,
            self.program.shape.n_chunks, self.cell)

    def replaying(self, key: Tuple, graph) -> None:
        vs = self.check_replay(key)
        if vs:
            self.violations += vs
            raise GraphAuditError(vs)
        self.replays += 1

    def replayed(self, key: Tuple, exits) -> None:
        ptrs = {st.p.data_ptr() for st in self.program.work["exits"]}
        if exits.p.data_ptr() not in ptrs:
            self.violations.append(Violation(
                "graph-buffers", self.cell,
                "after a replay the exits lie outside the program's two "
                "exit buffers"))


# ---------------------------------------------------------------------------
# int32-lattice
# ---------------------------------------------------------------------------

def max_admissible_rung(s_max: int) -> int:
    """The largest ladder rung whose dense coefficient extent the runtime
    guard admits at ``s_max``."""
    rung, n = 1, 1
    while True:
        cap = bucket_capacity(n)
        if cap * 64 + contracts.write_overshoot(s_max) > contracts.INT32_MAX:
            return rung
        rung, n = cap, cap + 1


@dataclasses.dataclass(frozen=True)
class _Rung:
    """A duck shape at the largest admissible rung."""
    n_units: int
    s_max: int
    n_words: int
    n_chunks: int

    def label(self) -> str:
        return f"max-admissible-rung(u{self.n_units},s{self.s_max})"


def check_lattice(shapes) -> List[Violation]:
    """int32-lattice: the valid model over ``shapes`` and the largest rung
    the runtime guard admits (which must itself pass it).

    The adversarial model (unvalidated damaged segments) is reported, not
    enforced, as the JAX package's contract states it (its
    ``docs/ANALYSIS.md``): :func:`adversarial_headroom`. Its bound would
    refuse legitimate large batches: at the full-width ``newyork``
    capacities a damaged segment may span 61,995 of 269,063 chunks."""
    out: List[Violation] = []
    for sh in shapes:
        try:
            contracts.check_index_lattice(sh, model="valid")
        except contracts.ContractViolation as e:
            out.append(Violation("int32-lattice", f"{sh.label()}/valid",
                                 str(e)))
    s_max = max(sh.s_max for sh in shapes)
    rung = max_admissible_rung(s_max)
    duck = _Rung(rung, s_max, (contracts.INT32_MAX - 63) // 32, rung)
    try:
        contracts.check_index_lattice(duck, model="valid")
    except contracts.ContractViolation as e:
        out.append(Violation(
            "int32-lattice", duck.label(),
            f"runtime guard admits a bucket the lattice rejects: {e}"))
    return out


def adversarial_headroom(sh) -> Tuple[bool, int]:
    """Whether the adversarial model holds at ``sh``'s capacities, and the
    largest damaged segment, in chunks, whose write base cannot wrap."""
    try:
        contracts.check_index_lattice(sh, model="adversarial")
        holds = True
    except contracts.ContractViolation:
        holds = False
    return holds, contracts.max_damaged_segment_chunks(sh)


# ---------------------------------------------------------------------------
# The grid
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    """A decoder of the grid: ``blobs`` decoded with ``options``, then a
    second batch of the same bucket (``second``)."""
    name: str
    blobs: List[bytes]
    second: List[bytes]
    sync: str
    backend: str
    extra: str = ""
    options: Dict[str, object] = dataclasses.field(default_factory=dict)
    full_width: bool = False

    def decoder(self, device, second: bool = False):
            return ParallelDecoder.from_bytes(
            list(self.second if second else self.blobs), sync=self.sync,
            backend=self.backend, device=device, **self.options)


def cell_label(shape, sync: str, backend: str, extra: str = "") -> str:
    mode = "permuted" if shape.permuted else "identity"
    lab = f"{shape.label()}/{sync}/{backend}/{mode}"
    return f"{lab}/{extra}" if extra else lab


def tier0_blobs() -> Dict[str, List[bytes]]:
    """The JAX checker's tier-0 batches: two 48x32 q75 frames with a
    restart interval of 2, and one 64x64 q90 frame."""
    rst = build_dataset(DatasetSpec("t0-restart", n_images=2, width=48,
                                    height=32, quality=75,
                                    restart_interval=2))
    one = build_dataset(DatasetSpec("t0-plain", n_images=1, width=64,
                                    height=64, quality=90))
    return {"t0-restart": list(rst.jpeg_bytes),
            "t0-plain": list(one.jpeg_bytes)}


def newyork_blobs(seed: int = 0) -> List[bytes]:
    """The full-width batch: 32 frames of the paper's ``newyork`` setting
    (1920x1080, 4:2:0, q95), 8 distinct each 4 times."""
    ds = build_dataset(DatasetSpec("newyork", 8, 1920, 1080, 95), seed=seed)
    return [b for b in ds.jpeg_bytes for _ in range(4)]


def _second(blobs: List[bytes]) -> List[bytes]:
    """Another batch of the same bucket: the frames rotated by one."""
    return blobs[1:] + blobs[:1]


# On the card the plain backend runs the small grid (the CPU tests'): its
# decode launches every op of every symbol step (a million for the
# sequential 64x64 cell at 1024 bits), some 30 us each under the tracker.
CARD_PLAIN_GRID = (("t0-restart",), 256)


def tier0_decoders(device="cuda", shapes: Sequence[str] = ("t0-restart",
                                                           "t0-plain"),
                   chunk_bits: int = 1024,
                   newyork: Optional[List[bytes]] = None) -> List[Cell]:
    """The grid: the JAX checker's identity cells (``shapes`` times the
    four syncs, at ``chunk_bits``) and a ``roundrobin`` flip over 2 lane
    blocks of the first shape, on the plain backend; on the card the
    kernel backend runs them and the plain backend :data:`CARD_PLAIN_GRID`.
    On the card ``newyork`` (the full-width batch) adds its cells on the
    kernels: jacobi with every fuse mode, faithful and specmap with
    ``post``, sequential with ``full``, and an ``lpt`` flip over 4 lane
    blocks, so that they launch B1-B6 and B1 lies in every graph."""
    blobs = tier0_blobs()
    grids = [("torch", tuple(shapes), chunk_bits)]
    if torch.device(device).type == "cuda":
        grids = [("torch", *CARD_PLAIN_GRID),
                 ("cuda", tuple(shapes), chunk_bits)]
    cells = []
    for backend, shapes, bits in grids:
        opts = dict(chunk_bits=bits)
        for name in shapes:
            for sync in SYNCS:
                cells.append(Cell(name, blobs[name], _second(blobs[name]),
                                  sync, backend, options=dict(opts)))
        first = shapes[0]
        cells.append(Cell(first, blobs[first], _second(blobs[first]),
                          "jacobi", backend, "flip",
                          dict(opts, balance="roundrobin", lanes=2)))
    if len(grids) > 1 and newyork is not None:
        runs = [("jacobi", "post"), ("jacobi", "full"), ("jacobi", "none"),
                ("faithful", "post"), ("specmap", "post"),
                ("sequential", "full")]
        for sync, fuse in runs:
            cells.append(Cell("newyork", newyork, _second(newyork), sync,
                              "cuda", f"fuse={fuse}",
                              dict(chunk_bits=1024, fuse=fuse),
                              full_width=True))
        cells.append(Cell("newyork", newyork, _second(newyork), "jacobi",
                          "cuda", "flip", dict(chunk_bits=1024, fuse="post",
                                               balance="lpt", lanes=4),
                          full_width=True))
    return cells


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CellResult:
    label: str
    shape: object
    cell: Cell
    violations: List[Violation] = dataclasses.field(default_factory=list)
    accesses: Set[Access] = dataclasses.field(default_factory=set)
    graphs: List[Dict[str, int]] = dataclasses.field(default_factory=list)
    replays: int = 0
    indexed: Set[str] = dataclasses.field(default_factory=set)
    ops: int = 0
    launches: Dict[str, int] = dataclasses.field(
        default_factory=collections.Counter)
    host_checks: List[int] = dataclasses.field(default_factory=list)
    ms: Optional[Tuple[float, float]] = None  # warm decode without, with

    @property
    def operands(self) -> FrozenSet[str]:
        """The lane-graph operands that reach an index."""
        return frozenset().union(*(a.taint for a in self.accesses))


def _timed_ms(fn: Callable[[], object], cuda: bool) -> float:
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    if cuda:
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def check_cell(cell: Cell, device) -> CellResult:
    """Every contract on one cell: the batch decoded cold and then warm
    (on the card the warm decode captures the round graphs; both traced
    on the kernel backend, the cold one on the plain backend), then the
    second batch of the bucket (its replays audited, its RGB held by
    (d)); the program's buffers must keep their addresses throughout.
    A full-width cell also times a warm decode without and with the
    tracker."""
    dec = cell.decoder(device)
    prog = dec.program
    cuda = prog.device.type == "cuda"
    label = cell_label(dec.shape, cell.sync, cell.backend, cell.extra)
    res = CellResult(label, dec.shape, cell)

    def add(trace: Trace) -> None:
        res.violations += check_trace(trace, label, cell.sync,
                                      dec.shape.permuted, prog.host_checks,
                                      cuda)
        res.accesses |= trace.tracker.accesses
        res.indexed |= trace.tracker.indexed
        res.ops += trace.tracker.ops
        res.launches.update(trace.tracker.launches)

    audit = GraphAuditor(prog, label) if cuda else None
    prog.audit = audit
    try:
        seeds = lane_graph_seeds(dec.dev)   # the program allocates here
        before = buffer_pointers(prog)
        for traced_now in (True, cuda and cell.backend == "cuda"):
            res.violations += check_addresses(prog, before, label)
            if traced_now:
                with traced(seeds, cuda) as trace:
                    out = dec.coefficients()
                add(trace)
            else:
                out = dec.coefficients()
            res.host_checks.append(prog.host_checks)
            res.violations += check_outputs(out, prog, label)
        dec2 = cell.decoder(device, second=True)
        out = dec2.decode(emit="rgb")
        res.violations += check_outputs(out, prog, label)
        res.violations += check_addresses(prog, before, label)
        del out
        if cell.full_width:
            plain = _timed_ms(dec2.coefficients, cuda)
            with traced(lane_graph_seeds(dec2.dev), cuda) as trace:
                res.ms = (plain, _timed_ms(dec2.coefficients, cuda))
            add(trace)
        if audit is not None:
            res.violations += audit.violations
            res.graphs = [r.kinds for r in audit.records.values()]
            res.replays = audit.replays
    finally:
        prog.audit = None
        discard_decode_programs(lambda p: p is prog)
    return res


# ---------------------------------------------------------------------------
# The mesh contracts: collective-accounting and words-donated-mesh
# ---------------------------------------------------------------------------

# the buffer a copy between blocks lands in -> what the program calls it
_EXCHANGE_BUFFERS = {"ext": "halo", "maps": "maps", "seq_all": "seq_sums",
                     "spans": "spans", "recv": "rows"}


def _exchange_kind(name: str) -> str:
    return _EXCHANGE_BUFFERS.get(name, f"into {name}")


class MeshTracker(TaintTracker):
    """A :class:`TaintTracker` that also counts the bytes of every copy
    from one block's buffer into another block's (``owners``: a storage's
    address -> (block, buffer name)), by the kind of exchange the target
    buffer says."""

    def __init__(self, seeds, owners: Dict[int, Tuple[int, str]]):
        super().__init__(seeds)
        self.owners = owners
        self.copies: Dict[str, int] = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if func.overloadpacket.__name__ == "copy_":
            src = self.owners.get(_key(args[1]))
            dst = self.owners.get(_key(args[0]))
            if src and dst and src[0] != dst[0]:
                self.copies[_exchange_kind(dst[1])] += \
                    args[1].numel() * args[1].element_size()
        return out


@dataclasses.dataclass
class MeshResult:
    label: str
    blocks: int
    violations: List[Violation]
    copies: Dict[str, int]
    expected: Dict[str, int]
    graphs: int = 0


def _spans(tensors) -> List[Tuple[torch.device, int, int]]:
    out = []
    for t in tensors:
        s = t.untyped_storage()
        out.append((t.device, s.data_ptr(), s.data_ptr() + s.nbytes()))
    return out


def check_mesh_outputs(out, prog, cell: str) -> List[Violation]:
    """words-donated-mesh, outputs: no piece a mesh decode returns shares
    storage with any block's buffers."""
    spans = _spans(t for b in prog.blocks for t in b.tensors())
    fields = [("coeffs", out.coeffs), ("rgb", out.rgb)] + [
        (f"planes[{i}]", p) for i, p in enumerate(out.planes or [])]
    bad = []
    for field, sh in fields:
        for i, t in enumerate([] if sh is None else sh.pieces):
            (dev, lo, hi), = _spans([t])
            if hi > lo and any(d == dev and lo < b and a < hi
                               for d, a, b in spans):
                bad.append(f"{field} piece {i}")
    if not bad:
        return []
    return [Violation("words-donated-mesh", cell,
                      f"a mesh decode returns block memory: {bad[:4]}")]


def check_mesh_graphs(prog, tables: Dict[torch.device, torch.Tensor],
                      cell: str) -> Tuple[int, List[Violation]]:
    """words-donated-mesh, graphs: each exit-kernel node of each block's
    round graphs reads and writes only that block's buffers and its card's
    compact tables, or the graph's own memory pool."""
    n, out = 0, []
    for b, bp in enumerate(prog.blocks):
        own = _spans(bp.tensors() + [tables[bp.device]])
        for key, graph in bp.graphs.items():
            n += 1
            pool = pool_spans(graph)
            for row in HK.graph_nodes(graph).tolist():
                if node_kind(row) != "exit kernel":
                    continue
                for name, p in zip(HK.EXIT_NODE_POINTERS, row[4:18]):
                    if not any(a <= p < e for _, a, e in own) and \
                            not any(a <= p < e for a, e in pool):
                        out.append(Violation(
                            "words-donated-mesh", cell,
                            f"block {b}'s round graph reads {name} at "
                            f"{p:#x}, outside its card's buffers"))
    return n, out


def check_mesh(dec: ParallelDecoder, mesh: Mesh, cell: str,
               emit: str = "rgb") -> MeshResult:
    """Both mesh contracts on one decoder over ``mesh`` (two blocks or
    more): a first decode allocates (and on the card loads the kernels),
    the second, traced, captures the round graphs on the card."""
    mesh = mesh.flat()
    dec.decode_on(mesh, emit=emit)
    prog = mesh_program(dec.shape, dec.sync, dec.backend, dec.fuse, mesh,
                        dec.launch)
    cuda = mesh.device_type == "cuda"
    prog.keep_graphs = cuda
    owners = {}
    for b, bp in enumerate(prog.blocks):
        for name, t in bp.bufs.items():
            owners[_key(t)] = (b, name)
        for name, t in (bp.plan or {}).items():
            owners[_key(t)] = (b, "plan:" + name)
    seeds = {f"lane@{b}": bp.bufs["lay_prev"]
             for b, bp in enumerate(prog.blocks)}
    tracker = MeshTracker(seeds, owners)
    try:
        with tracing(tracker):
            out = dec.decode_on(mesh, emit=emit)
        vs: List[Violation] = []
        got = {k: v for k, v in tracker.copies.items() if v}
        exp = out.mesh["expected_bytes"]
        if got != exp:
            vs.append(Violation(
                "collective-accounting", cell,
                f"copies between blocks {got} != the program's account "
                f"{exp}"))
        ex = out.mesh["exchanges"]
        if ex and got.get("halo", 0) != ex * out.mesh["round_bytes"]:
            vs.append(Violation(
                "collective-accounting", cell,
                f"halo copies {got.get('halo', 0)} over {ex} exchanges, "
                f"not {out.mesh['round_bytes']} bytes each"))
        lay, _ = dec.mesh_layout(mesh.size)
        for b, blk in enumerate(lay.blocks):
            reads = {f"lane@{a}" for a, _, _ in blk.recv}
            have = tracker.taint_of(prog.blocks[b].bufs["ext"])
            if not reads <= have:
                vs.append(Violation(
                    "collective-accounting", cell,
                    f"block {b}'s halo lacks the taint of "
                    f"{sorted(reads - have)}: a copy between blocks "
                    f"dropped it"))
        vs += check_mesh_outputs(out, prog, cell)
        graphs = 0
        if cuda:
            tables = {d: lut_tables(dec._arrays["luts"], d)[0]
                      for d in {bp.device for bp in prog.blocks}}
            graphs, more = check_mesh_graphs(prog, tables, cell)
            vs += more
            if not graphs:
                vs.append(Violation("words-donated-mesh", cell,
                                    "the warm mesh decode captured no "
                                    "round graph"))
        return MeshResult(cell, mesh.size, vs, got, exp, graphs)
    finally:
        prog.keep_graphs = False
        discard_decode_programs(lambda p: p is prog)


def mesh_cells(device: torch.device) -> List[Tuple[str, ParallelDecoder,
                                                    Mesh]]:
    """The mesh cells, each over two blocks (two cards where the machine
    has them, else two blocks of one card or of the CPU), at 128-bit
    chunks in sequences of 4: a single-segment 32x16 frame on the
    identity plan with jacobi (blocks cut inside its segment: halos), and
    the tier-0 restart batch balanced round-robin over the blocks with
    specmap (phase maps gathered to every block)."""
    if device.type == "cuda" and torch.cuda.device_count() >= 2:
        mesh = make_host_mesh(2)
    else:
        mesh = Mesh([device] * 2)
    backend = "cuda" if device.type == "cuda" else "torch"
    segment = build_dataset(DatasetSpec("mesh-segment", n_images=1,
                                        width=32, height=16, quality=90))
    kw = dict(chunk_bits=128, seq_chunks=4, backend=backend, device=device)
    plain = ParallelDecoder.from_bytes(list(segment.jpeg_bytes),
                                       sync="jacobi", **kw)
    rr = ParallelDecoder.from_bytes(tier0_blobs()["t0-restart"],
                                    sync="specmap", balance="roundrobin",
                                    lanes=2, **kw)
    return [(f"mesh2/segment/jacobi/{backend}", plain, mesh),
            (f"mesh2/t0-restart/specmap/roundrobin/{backend}", rr, mesh)]


# ---------------------------------------------------------------------------
# The whole checker
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Report:
    device: str
    cells: List[CellResult]
    violations: List[Violation]
    shapes: List[object]
    caught: List[Violation] = dataclasses.field(default_factory=list)
    failures: List[str] = dataclasses.field(default_factory=list)
    meshes: List[MeshResult] = dataclasses.field(default_factory=list)

    def lines(self, verbose: bool = False) -> List[str]:
        out = []
        for m in self.meshes:
            out.append(f"checked {m.label} over {m.blocks} blocks: copies "
                       f"between blocks {m.copies} (the program's account "
                       f"{m.expected}), {m.graphs} round graphs read")
        for r in self.cells:
            if verbose or r.ms is not None:
                graphs = "; ".join(
                    ", ".join(f"{n} {k}" for k, n in sorted(g.items()))
                    for g in r.graphs) or "none"
                ms = "" if r.ms is None else \
                    f"; warm decode {r.ms[0]:.2f} ms, traced {r.ms[1]:.2f} ms"
                out.append(f"checked {r.label}: {r.ops} ops and kernel "
                           f"launches {dict(sorted(r.launches.items()))} "
                           f"traced, lane-graph operands at an index "
                           f"{sorted(r.operands)}, host checks "
                           f"{r.host_checks}, {len(r.graphs)} graphs "
                           f"({graphs}), {r.replays} replays audited{ms}")
        for sh in self.shapes:
            holds, k = adversarial_headroom(sh)
            if verbose or not holds:
                out.append(f"lattice {sh.label()}: adversarial model "
                           f"(reported, not enforced) "
                           f"{'holds' if holds else 'overflows'}: a damaged "
                           f"segment may span {k} chunks, the shape holds "
                           f"{sh.n_chunks}")
        for v in self.caught:
            out.append(f"self-test caught: {v.format()}")
        for f in self.failures:
            out.append(f"[self-test] seeded: {f}")
        for v in self.violations:
            out.append(v.format())
        n = len(self.violations) + len(self.failures)
        ran = [c for c in contracts.TRACE_CONTRACTS
               if c not in contracts.MESH_CONTRACTS]
        mesh = ", ".join(contracts.MESH_CONTRACTS)
        on_mesh = (f"on {len(self.meshes)} mesh cells: {mesh}" if
                   self.meshes else f"not run, no mesh of two blocks or "
                   f"more was checked: {mesh}")
        out.append(
            f"{n} contract violation{'s' if n != 1 else ''} across "
            f"{len(self.cells)} cells ({len(self.shapes)} shapes, "
            f"{self.device}; contracts: {', '.join(ran)}; {on_mesh})")
        return out

    @property
    def ok(self) -> bool:
        return not self.violations and not self.failures


def check(device="cuda", self_test: bool = False,
          cells: Optional[List[Cell]] = None,
          newyork: Optional[List[bytes]] = None,
          meshes: Optional[bool] = None) -> Report:
    """Run the checker over ``cells`` (the grid of :func:`tier0_decoders`
    without them; on the card with the full-width cells of ``newyork``,
    the batch :func:`newyork_blobs` makes when it is None), the mesh
    contracts over :func:`mesh_cells` (``meshes``; by default with the
    grid) and, with ``self_test``, the seeded faults.
    ``device="cuda"`` needs a card."""
    if meshes is None:
        meshes = cells is None
    dev = resolve_device(device)
    if cells is None:
        if dev.type == "cuda" and newyork is None:
            newyork = newyork_blobs()
        cells = tier0_decoders(dev, newyork=newyork)
    # the audited programs must capture their graphs themselves
    clear_decode_programs()
    results, shapes = [], []
    for cell in cells:
        r = check_cell(cell, dev)
        results.append(r)
        if r.shape not in shapes:
            shapes.append(r.shape)
    violations = [v for r in results for v in r.violations]
    if shapes:
        violations += check_lattice(shapes)
    mesh_results = [check_mesh(dec, mesh, label) for label, dec, mesh in
                    (mesh_cells(dev) if meshes else [])]
    violations += [v for m in mesh_results for v in m.violations]
    report = Report(str(dev), results, violations, shapes,
                    meshes=mesh_results)
    if self_test:
        report.failures, report.caught = run_self_test(device=dev.type)
    clear_decode_programs()
    return report


def run(self_test: bool = False, verbose: bool = False,
        device="cuda") -> int:
    """The checker over the tier-0 grid (on the card also the full-width
    cells), then ``self_test``'s seeded faults; prints each violation and
    a summary line, and returns the exit code."""
    report = check(device=device, self_test=self_test)
    for line in report.lines(verbose):
        print(line)
    return 0 if report.ok else 1


# ---------------------------------------------------------------------------
# Seeded faults: prove the checker catches what it claims to
# ---------------------------------------------------------------------------

def _seed_decoder(device: str, sync: str = "jacobi"):
    return ParallelDecoder.from_bytes(
        tier0_blobs()["t0-restart"], chunk_bits=256, sync=sync,
        backend="cuda" if device == "cuda" else "torch", device=device)


def _seeded_sync(dec, seed: Callable, cuda: bool) -> List[Violation]:
    """``run_sync`` on ``dec``'s identity plan through a ``decode_exits``
    that also runs ``seed(dev, entry)``, traced; the violations found."""
    dev = dec.dev
    sh = dec.shape
    meta = D.chunk_meta(dev)

    def decode_exits(d, entry, idx=None, out=None):
        seed(d, entry)
        return HK.decode_exits(d, meta, entry, idx, out=out, s_max=sh.s_max,
                               min_code_bits=sh.min_code_bits)

    blocks = SY.RoundBlocks()
    with traced(lane_graph_seeds(dev), cuda) as trace:
        run_sync(dev, sh, dec.sync, decode_exits, blocks)
    return check_trace(trace, "seeded", dec.sync, sh.permuted, blocks.checks,
                       cuda)


def _creep(dev, entry) -> None:
    """The gather-creep bug, rebuilt: a lane-graph read indexed by
    ``chunk_order``."""
    creep = dev["chunk_prev"][dev["chunk_order"].to(torch.int64)]
    del creep


def _widen(dev, entry) -> None:
    """A float64 op in the entropy stage."""
    entry.p.to(torch.float64)  # repro: allow[f64-literal-promotion]


def _item(dev, entry) -> None:
    """A host read in a sync round."""
    entry.p.sum().item()


def _seed_realloc(dec, cuda: bool) -> List[Violation]:
    """A program buffer reallocated after the round graphs were captured:
    caught before the next decode replays them (on the card, by the graph
    audit; off it, by the address check before the next decode)."""
    prog = dec.program
    audit = GraphAuditor(prog, "seeded-realloc") if cuda else None
    prog.audit = audit
    try:
        dec.coefficients()
        before = buffer_pointers(prog)
        dec.coefficients()   # captures on the card
        meta = prog.work["meta"]
        meta["ts"] = torch.empty_like(meta["ts"])
        if not cuda:
            return check_addresses(prog, before, "seeded-realloc")
        replays = audit.replays
        try:
            dec.coefficients()
        except GraphAuditError as e:
            if audit.replays != replays:
                return []   # caught only after a replay: not caught
            return e.violations
        return []
    finally:
        prog.audit = None
        discard_decode_programs(lambda p: p is prog)


def _seed_pinned_copy(dec) -> List[Violation]:
    """A graph of two exit-kernel rounds that also copies to pinned host
    memory (captured here, never replayed)."""
    dev = dec.dev
    sh = dec.shape
    meta = D.chunk_meta(dev)
    entry = DecodeState.cold(dev["chunk_start"])
    kw = dict(s_max=sh.s_max, min_code_bits=sh.min_code_bits)
    host = torch.empty(entry.p.shape, dtype=entry.p.dtype, pin_memory=True)
    exits = HK.decode_exits(dev, meta, entry, **kw)   # loads the kernel
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        exits = HK.decode_exits(dev, meta, entry, **kw)
        exits = HK.decode_exits(dev, meta, exits, **kw)
        host.copy_(exits.p, non_blocking=True)
    rows = HK.graph_nodes(graph).tolist()
    return classify_nodes(rows, EXIT_NODES_PER_GRAPH, "seeded-pinned-copy")[1]


def _seed_skipped_edge(device: str) -> List[Violation]:
    """A halo exchange that skips one block's first send (the program
    still counts it) on the identity mesh cell."""
    label, dec, mesh = mesh_cells(resolve_device(device))[0]
    deliver = MD.MeshRun.deliver

    def skipping(run, states):
        blk = next(b for b in run.blocks if b.sends)
        sends, blk.sends = blk.sends, blk.sends[1:]
        try:
            deliver(run, states)
        finally:
            blk.sends = sends
        run.copy_bytes["halo"] += 16 * sends[0][1].numel()

    MD.MeshRun.deliver = skipping
    try:
        return check_mesh(dec, mesh, "seeded-skipped-edge").violations
    finally:
        MD.MeshRun.deliver = deliver


def _seed_mesh_alias(device: str) -> List[Violation]:
    """A mesh decode whose first coefficient piece is a view of its
    block's buffer."""
    import dataclasses as dc
    label, dec, mesh = mesh_cells(resolve_device(device))[0]
    out = dec.decode_on(mesh, emit="coeffs")
    prog = mesh_program(dec.shape, dec.sync, dec.backend, dec.fuse,
                        mesh.flat(), dec.launch)
    rows = prog.blocks[0].bufs["rows"]
    n = out.coeffs.pieces[0].numel()
    alias = MD.Sharded([rows[:n].view(-1, 64)] + out.coeffs.pieces[1:],
                       out.coeffs.offsets)
    try:
        return check_mesh_outputs(dc.replace(out, coeffs=alias), prog,
                                  "seeded-alias")
    finally:
        discard_decode_programs(lambda p: p is prog)


def run_self_test(verbose: bool = False, device: str = "cuda"
                  ) -> Tuple[List[str], List[Violation]]:
    """Prove the checker catches its seeded faults, each by its own
    contract: the gather-creep read (identity-lane-graph, naming
    ``chunk_order``), a float64 op in the entropy stage (no-f64), an
    ``.item()`` in a sync-loop body (no-host-read), a returned view of a
    program buffer and a program buffer reallocated after capture
    (graph-buffers), on the card a graph that copies to pinned host memory
    (graph-buffers (a)), and on a mesh of two blocks a halo exchange that
    skips an edge (collective-accounting) and a returned view of a
    block's buffer (words-donated-mesh). Returns ``(failures, caught)``: what was
    not caught, and the violations that caught the rest."""
    import dataclasses as dc

    cuda = device == "cuda"
    failures: List[str] = []
    caught: List[Violation] = []

    def expect(what: str, vs: List[Violation], contract: str,
               detail: str = "") -> None:
        hit = [v for v in vs if v.contract == contract and detail in v.detail]
        if hit:
            caught.append(Violation(hit[0].contract, what, hit[0].detail))
            if verbose:
                print(f"self-test: {what} caught by {contract}")
        else:
            failures.append(f"{what} was NOT caught by {contract} "
                            f"(found: {[v.contract for v in vs]})")

    dec = _seed_decoder(device)
    expect("gather-creep", _seeded_sync(dec, _creep, cuda),
           "identity-lane-graph", "chunk_order")
    expect("float64 op", _seeded_sync(dec, _widen, cuda), "no-f64")
    expect(".item() in a sync round", _seeded_sync(dec, _item, cuda),
           "no-host-read")
    out = dec.coefficients()
    view = dc.replace(out, coeffs=dec.program.work["bases"][:4])
    expect("returned work-buffer view", check_outputs(
        view, dec.program, "seeded-view"), "graph-buffers")
    del out, view, dec
    expect("buffer reallocated after capture", _seed_realloc(
        _seed_decoder(device), cuda), "graph-buffers")
    if cuda:
        expect("device-to-host copy in a graph", _seed_pinned_copy(
            _seed_decoder(device)), "graph-buffers", "pinned host")
    expect("skipped halo edge", _seed_skipped_edge(device),
           "collective-accounting", "halo")
    expect("output aliasing a block's buffer", _seed_mesh_alias(device),
           "words-donated-mesh", "block memory")
    return failures, caught
