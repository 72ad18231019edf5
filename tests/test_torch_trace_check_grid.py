"""The traced-program checker's small grid on the CPU, held against the
JAX package's jaxpr checker.

The grid is ``t0-restart`` (two 48x32 q75 frames, restart interval 2) at
256-bit chunks: the four syncs on the identity plan and a ``roundrobin``
flip over 2 lane blocks. Per cell, the set of lane-graph operands that
reach an index in the port's decode (``trace_check.check_cell`` on
``device="cpu"``) equals the set the JAX checker finds in the jaxpr of
``repro``'s ``coeffs_fn`` on the same bytes with ``backend="jnp"``: empty
on identity plans but faithful's ``{chunk_next}``, and non-empty on the
flip. ``repro.analysis.jaxpr_check`` does not run with this JAX as it
stands (``jax.core.Literal`` is gone): each test points its ``jcore`` at
``jax.extend.core`` and its ``_DROPVAR`` at ``()``, the module's own
fallback, through a ``monkeypatch`` scoped to the test. The file itself
is not edited.
"""
import jax
import jax.extend.core
import pytest

from repro.analysis import jaxpr_check as J
from repro.core.api import ParallelDecoder as RefDecoder
from repro_torch.analysis import trace_check as T
from repro_torch.core.api import clear_decode_programs

CELLS = ("jacobi", "faithful", "sequential", "specmap", "flip")
_CELLS = {}
_RESULTS = {}


def cells():
    if not _CELLS:
        _CELLS.update({("flip" if c.extra == "flip" else c.sync): c
                       for c in T.tier0_decoders("cpu",
                                                 shapes=("t0-restart",),
                                                 chunk_bits=256)})
    return _CELLS


def result(name):
    """The port's checker on one cell, once per process."""
    if name not in _RESULTS:
        _RESULTS[name] = T.check_cell(cells()[name], "cpu")
    return _RESULTS[name]


@pytest.fixture
def reference(monkeypatch):
    monkeypatch.setattr(J, "jcore", jax.extend.core)
    monkeypatch.setattr(J, "_DROPVAR", ())
    return J


def reference_operands(J, cell):
    dec = RefDecoder.from_bytes(list(cell.blobs), sync=cell.sync,
                                backend="jnp", **cell.options)
    tr = J._trace(dec)
    names = J._invar_names(dec.data.words, dec._dev_rest)
    assert len(names) == len(tr.jaxpr.jaxpr.invars)
    accesses = J.lane_graph_accesses(tr.jaxpr, names)
    return frozenset().union(*(a.taint for a in accesses)), dec.shape


@pytest.mark.parametrize("name", CELLS)
def test_lane_graph_operands_equal_reference(reference, name):
    cell = cells()[name]
    want, ref_shape = reference_operands(reference, cell)
    got = result(name)
    assert got.shape.permuted == ref_shape.permuted == (name == "flip")
    assert got.operands == want
    expect = {"faithful": {"chunk_next"},
              "flip": {"chunk_order", "chunk_prev", "lane_perm"}}
    assert got.operands == expect.get(name, frozenset())


@pytest.mark.parametrize("name", CELLS)
def test_cell_holds_every_contract(name):
    """No violation: the lane graph, no float64, no host read but
    host_check's (as many as RoundBlocks.checks), no output aliasing a
    program buffer, and the buffers' addresses stable over the three
    decodes of the cell (two of the batch, one of a second batch)."""
    r = result(name)
    assert r.violations == [], [v.format() for v in r.violations]
    assert r.ops > 10_000 and len(r.host_checks) == 2
    assert r.host_checks == ([0, 0] if name == "sequential" else
                             [2, 2] if name == "faithful" else [1, 1])
    assert not r.graphs and r.ms is None
    # the op table covers what the decode really indexes with
    assert {"index", "index_put_", "index_select"} <= r.indexed
    assert r.indexed <= set(T.INDEXED_OPS)


def test_addresses_stable_over_three_decodes():
    clear_decode_programs()
    cell = cells()["jacobi"]
    dec = cell.decoder("cpu")
    dec.coefficients()
    before = T.buffer_pointers(dec.program)
    dec.coefficients()
    out = cell.decoder("cpu", second=True).decode(emit="rgb")
    assert T.buffer_pointers(dec.program) == before
    assert dec.program.allocations == 1
    assert T.check_outputs(out, dec.program, "c") == []
    assert out.planes and out.rgb is not None
    clear_decode_programs()
