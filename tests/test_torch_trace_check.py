"""The traced-program checker (``repro_torch.analysis.trace_check``) on the
CPU: its int32 lattice against the JAX package's, the taint tracker's
propagation (views, in-place ops, ``out=``, ``.to()``, kernel launches
through the launch recorder), its host-read and float64 findings, the
graph-node reader's classifier and pointer check on node rows read from
a real graph on the card (``_torch_graph_nodes.json``), and the CLI.
The grid and the seeded faults are in ``test_torch_trace_check_grid.py``
and ``test_torch_trace_check_seeds.py``.
"""
import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from repro.analysis import contracts as RC
from repro.core import bitstream as RB
from repro_torch.analysis import contracts as C
from repro_torch.analysis import trace_check as T
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.core import bitstream as TB
from repro_torch.core import sync as SY
from repro_torch.kernels import build as B
from repro_torch.kernels.huffman import ops as HK

NODES = Path(__file__).resolve().parent / "_torch_graph_nodes.json"

# the newyork bucket's capacities (32 1080p frames, 4:2:0, q95, 1024-bit
# chunks), as its PlanShape has them on the card
NEWYORK = dict(n_units=1_688_336, n_chunks=269_063, s_max=514,
               n_words=8_149_281)


def duck(**kw):
    base = dict(n_units=1 << 20, s_max=16, n_words=1 << 18, n_chunks=1 << 12,
                label=lambda: "duck")
    base.update(kw)
    return SimpleNamespace(**base)


def grid_shapes():
    blobs = T.tier0_blobs()
    out = []
    for name, bits in (("t0-restart", 1024), ("t0-restart", 256),
                       ("t0-plain", 1024)):
        plan = TB.build_batch_plan(blobs[name], chunk_bits=bits)
        out.append(TB.plan_shape(plan))
    return out


LATTICE_SHAPES = {
    "duck": duck(),
    "duck-huge-units": duck(n_units=1 << 26),
    "duck-adversarial": duck(n_units=1 << 24, n_chunks=1 << 16, s_max=1024),
    "newyork": duck(**NEWYORK),
    "newyork-x16": duck(**dict(NEWYORK, n_units=16 * NEWYORK["n_units"])),
}


def _ranges(fn, sh, model):
    try:
        return {k: (r.lo, r.hi) for k, r in fn(sh, model=model).items()}
    except ValueError as e:   # both packages' ContractViolation
        return type(e).__name__


@pytest.mark.parametrize("name", sorted(LATTICE_SHAPES))
@pytest.mark.parametrize("model", ["valid", "adversarial"])
def test_lattice_equals_reference(name, model):
    sh = LATTICE_SHAPES[name]
    assert _ranges(C.plan_index_ranges, sh, model) == \
        _ranges(RC.plan_index_ranges, sh, model)

    def verdict(check):
        try:
            check(sh, model=model)
            return None
        except ValueError as e:
            return str(e)

    assert verdict(C.check_index_lattice) == verdict(RC.check_index_lattice)
    assert C.max_damaged_segment_chunks(sh) == \
        RC.max_damaged_segment_chunks(sh)


def test_lattice_on_grid_shapes_equals_reference():
    for sh in grid_shapes():
        for model in ("valid", "adversarial"):
            assert _ranges(C.plan_index_ranges, sh, model) == \
                _ranges(RC.plan_index_ranges, sh, model)
        assert C.max_damaged_segment_chunks(sh) == \
            RC.max_damaged_segment_chunks(sh)
    assert T.check_lattice(grid_shapes()) == []


def test_largest_admissible_rung_equals_reference():
    """The JAX checker's loop, with its own bucket_capacity, against the
    port's: the same rung, which both lattices admit."""
    for s_max in (130, 514, 5778):
        rung, n = 1, 1
        while True:
            cap = RB.bucket_capacity(n)
            if cap * 64 + RC.write_overshoot(s_max) > RC.INT32_MAX:
                break
            rung, n = cap, cap + 1
        assert T.max_admissible_rung(s_max) == rung
        sh = duck(n_units=rung, s_max=s_max, n_words=(C.INT32_MAX - 63) // 32,
                  n_chunks=rung)
        C.check_index_lattice(sh, model="valid")
        RC.check_index_lattice(sh, model="valid")


def test_lattice_flags_an_overflowing_shape():
    vs = T.check_lattice([duck(n_units=1 << 26, label=lambda: "huge")])
    assert vs and all(v.contract == "int32-lattice" for v in vs)


def test_adversarial_model_is_reported_not_enforced():
    """The JAX package's contract (its docs/ANALYSIS.md): the valid model
    is enforced, the adversarial headroom reported. At the newyork
    capacities the valid model holds and the adversarial one does not."""
    ny = duck(**NEWYORK, label=lambda: "newyork")
    assert T.check_lattice([ny]) == []
    assert T.adversarial_headroom(ny) == (False, 61_995)
    with pytest.raises(RC.ContractViolation):
        RC.check_index_lattice(ny, model="adversarial")
    assert T.adversarial_headroom(duck()) == (
        True, C.max_damaged_segment_chunks(duck()))
    line = [ln for ln in T.Report("cpu", [], [], [ny]).lines()
            if ln.startswith("lattice newyork")]
    assert line and "reported, not enforced" in line[0]


def test_int_range_check_and_fits():
    r = (C.IntRange(0, 10) + C.IntRange.const(5)) * C.IntRange.const(64)
    assert (r.lo, r.hi) == (320, 960) and r.fits_int32
    assert r.check("x") is r
    assert not C.IntRange(0, C.INT32_MAX + 1).fits_int32
    with pytest.raises(C.ContractViolation):
        C.IntRange(0, C.INT32_MAX + 1).check("x")


def test_liveness_tables_equal_reference():
    assert C.LANE_GRAPH_ARRAYS == RC.LANE_GRAPH_ARRAYS
    assert dict(C.IDENTITY_LIVE_OK) == dict(RC.IDENTITY_LIVE_OK)
    for sync in T.SYNCS:
        assert C.identity_live_ok(sync) == RC.identity_live_ok(sync)
    with pytest.raises(C.ContractViolation):
        C.identity_live_ok("nope")


def test_catalog_names_every_contract():
    ran = set(C.TRACE_CONTRACTS) - set(C.MESH_CONTRACTS)
    assert ran == {"identity-lane-graph", "no-f64", "no-host-read",
                   "graph-buffers", "int32-lattice"}
    assert set(C.MESH_CONTRACTS) == {"collective-accounting",
                                     "words-donated-mesh"}
    assert set(C.MESH_CONTRACTS) <= set(C.TRACE_CONTRACTS)
    line = T.Report("cpu", [], [], []).lines()[-1]
    assert line.startswith("0 contract violations")
    assert "not run" in line and "collective-accounting" in line
    mesh = T.MeshResult("mesh2", 2, [], {}, {})
    line = T.Report("cpu", [], [], [], meshes=[mesh]).lines()[-1]
    assert "not run" not in line and "on 1 mesh cells" in line


# -- the taint tracker -----------------------------------------------------------

def test_taint_through_views_in_place_out_and_to():
    graph = torch.arange(6, dtype=torch.int32)
    data = torch.arange(10.0)
    tr = T.TaintTracker({"chunk_prev": graph})
    with T.tracing(tr):
        view = graph[1:4]
        wide = view.to(torch.int64)
        out = torch.empty(3, dtype=torch.int64)
        torch.add(wide, 1, out=out)
        acc = torch.zeros(3, dtype=torch.int64)
        acc.add_(out)
        clean = torch.arange(3)
        got = data[acc]
    for t in (view, wide, out, acc, got):
        assert tr.taint_of(t) == {"chunk_prev"}
    assert tr.taint_of(clean) == frozenset()
    assert T.Access("index", frozenset({"chunk_prev"})) in tr.accesses
    assert not tr.f64 and not tr.host_reads and not tr.unlisted


def test_taint_tracks_through_loop_carry():
    """Taint entering a loop's carry on the first iteration is seen by an
    indexed access on the second."""
    order = torch.tensor([2, 0, 3, 1])
    x = torch.arange(4.0)
    tr = T.TaintTracker({"chunk_order": order})
    with T.tracing(tr):
        j = torch.zeros(1, dtype=torch.int64)
        acc = torch.zeros(1)
        for _ in range(3):
            acc = acc + x[j]
            j = order[j]
    assert any("chunk_order" in a.taint for a in tr.accesses)


def test_untainted_gather_not_flagged():
    lut = torch.arange(8.0)
    graph = torch.arange(4, dtype=torch.int32)
    tr = T.TaintTracker({"lane_perm": graph})
    with T.tracing(tr):
        idx = torch.tensor([1, 2])
        lut[idx]
        torch.gather(lut, 0, idx)
        torch.index_select(lut, 0, idx)
        graph.to(torch.int64)[idx]   # tainted data, clean index
    assert not any(a.taint for a in tr.accesses)


@pytest.mark.parametrize("op", ["gather", "index_select", "index_put_",
                                "scatter_"])
def test_every_indexed_op_form_is_seen(op):
    data = torch.zeros(4)
    idx = torch.tensor([3, 1])
    tr = T.TaintTracker({"chunk_next": idx})
    with T.tracing(tr):
        if op == "gather":
            torch.gather(data, 0, idx)
        elif op == "index_select":
            torch.index_select(data, 0, idx)
        elif op == "index_put_":
            data[idx] = 1.0
        else:
            data.scatter_(0, idx, torch.ones(2))
    assert tr.accesses == {T.Access(op, frozenset({"chunk_next"}))}
    assert op in T.INDEXED_OPS and not tr.unlisted


def test_recorded_launch_spreads_taint():
    """A kernel launch the dispatcher never sees, as the launch recorder
    reports it (a fake launch on the CPU): its operands' taints reach all
    of them."""
    graph = torch.arange(4, dtype=torch.int32)
    out = torch.zeros(4, dtype=torch.int32)
    table = torch.arange(8.0)
    tr = T.TaintTracker({"chunk_prev": graph})
    with T.tracing(tr):
        B.ptr(graph)
        B.ptr(out)
        B.check(0, "fake_kernel")
        table[out.to(torch.int64)]
    B.ptr(out)   # no recorder outside: nothing noted
    assert tr.launches == {"fake_kernel": 1}
    assert tr.taint_of(out) == {"chunk_prev"}
    assert T.Access("index", frozenset({"chunk_prev"})) in tr.accesses


def test_host_reads_and_f64_are_found():
    x = torch.arange(4)
    tr = T.TaintTracker()
    with T.tracing(tr):
        x.sum().item()
        x[x > 1]
        torch.ones(2, dtype=torch.float64)
    assert any("_local_scalar_dense" in r for r in tr.host_reads)
    assert any("boolean-mask" in r for r in tr.host_reads)
    assert tr.f64 and tr.sanctioned == 0


def test_host_check_reads_are_its_own():
    tr = T.TaintTracker()
    blocks = SY.RoundBlocks()
    with T.traced({}, False) as trace:
        blocks.read(torch.tensor(3), torch.tensor(True))
    assert trace.host_checks == blocks.checks == 1
    assert not trace.tracker.host_reads
    assert T.check_trace(trace, "c", "jacobi", False, 1, False) == []
    vs = T.check_trace(trace, "c", "jacobi", False, 2, False)
    assert [v.contract for v in vs] == ["no-host-read"]
    del tr


def test_lane_graph_check_both_ways():
    a = [T.Access("index", frozenset({"chunk_next"}))]
    assert T.check_lane_graph(a, "faithful", False, "c") == []
    assert T.check_lane_graph(a, "jacobi", False, "c")[0].contract == \
        "identity-lane-graph"
    assert T.check_lane_graph(a, "jacobi", True, "c") == []
    assert T.check_lane_graph([], "jacobi", True, "c")[0].contract == \
        "identity-lane-graph"


# -- the graph reader's rows, as a real graph of two jacobi rounds gave them ----

def card_nodes():
    return json.loads(NODES.read_text())


def test_classifier_on_a_real_graph():
    rows = card_nodes()["rows"]
    kinds, vs = T.classify_nodes(rows, T.EXIT_NODES_PER_GRAPH, "card")
    assert vs == []
    assert kinds["exit kernel"] == 2 and set(kinds) <= T.GRAPH_NODE_KINDS


def test_classifier_flags_host_nodes_and_copies():
    rows = card_nodes()["rows"]
    pinned = [1, 2, 1, 2] + [0] * (HK.NODE_WORDS - 4)   # device -> pinned
    host = [3] + [0] * (HK.NODE_WORDS - 1)
    alloc = [10] + [0] * (HK.NODE_WORDS - 1)
    for extra in (pinned, host, alloc):
        _, vs = T.classify_nodes(rows + [extra], 2, "card")
        assert [v.contract for v in vs] == ["graph-buffers"]
    exits = [r for r in rows if T.node_kind(r) == "exit kernel"]
    _, vs = T.classify_nodes(exits[:1], 2, "card")
    assert vs and "exit-kernel" in vs[0].detail
    assert T.node_kind(pinned) == "copy device -> pinned host"


def test_exit_pointers_against_the_program():
    """graph-buffers (b) on the real exit nodes: their pointers named as
    the program's buffers were at capture, the entries in the graph's own
    pool; a buffer that moved, or a pointer that is neither, is caught."""
    data = card_nodes()
    rows = [r for r in data["rows"] if T.node_kind(r) == "exit kernel"]
    live = {k: int(v) for k, v in data["live"].items()}
    pool = [tuple(s) for s in data["pool"]]
    rec = T._GraphRecord(rows, live, pool, {})
    table, lanes = int(data["table"]), int(data["lanes"])
    assert T.check_exit_pointers(rec, live, table, lanes, "card") == []
    moved = dict(live, **{"work.meta.ts": live["work.meta.ts"] + 4096})
    vs = T.check_exit_pointers(rec, moved, table, lanes, "card")
    assert vs and "work.meta.ts" in vs[0].detail
    vs = T.check_exit_pointers(T._GraphRecord(rows, live, [], {}), live,
                               table, lanes, "card")
    assert vs and "neither" in vs[0].detail
    assert T.check_exit_pointers(rec, live, table + 16, lanes, "card")


def test_audit_refuses_graphs_of_replaced_tables():
    """A graph keyed on compact tables that were replaced is gone before
    a replay of the current key; one left behind refuses the replay."""
    old, new = ((0x1000, 128), 0), ((0x2000, 128), 0)
    prog = SimpleNamespace(plan={}, work={}, graphs={old: None, new: None},
                           backend="cuda", shape=SimpleNamespace(n_chunks=26))
    audit = T.GraphAuditor(prog, "c")
    audit.records[new] = T._GraphRecord([], {}, [], {})
    with pytest.raises(T.GraphAuditError) as e:
        audit.replaying(new, None)
    assert "replaced compact tables" in str(e.value) and audit.replays == 0
    del prog.graphs[old]
    audit.replaying(new, None)
    assert audit.replays == 1
    with pytest.raises(T.GraphAuditError):   # never read at capture
        audit.replaying(old, None)


def test_contracts_without_a_card_exits_non_zero(capsys):
    assert not torch.cuda.is_available()
    assert analysis_main(["contracts"]) != 0
    assert "no CUDA device" in capsys.readouterr().err
