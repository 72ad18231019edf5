"""The traced-program checker's self-test on the CPU: every seeded fault
is caught by its own contract (``trace_check.run_self_test``), the mesh
contracts' seeds on two CPU blocks. The card adds a graph that copies to
pinned host memory (``chip_smoke.py`` phase 10b)."""
import pytest

from repro_torch.analysis import trace_check as T

SEEDS = {"gather-creep": ("identity-lane-graph", "chunk_order"),
         "float64 op": ("no-f64", "float64"),
         ".item() in a sync round": ("no-host-read", "_local_scalar_dense"),
         "returned work-buffer view": ("graph-buffers", "work.bases"),
         "buffer reallocated after capture": ("graph-buffers",
                                              "work.meta.ts"),
         "skipped halo edge": ("collective-accounting", "halo"),
         "output aliasing a block's buffer": ("words-donated-mesh",
                                              "block memory")}
_RUN = []


def self_test():
    if not _RUN:
        _RUN.append(T.run_self_test(device="cpu"))
    return _RUN[0]


def test_nothing_escapes():
    failures, caught = self_test()
    assert failures == []
    assert {v.cell for v in caught} == set(SEEDS)


@pytest.mark.parametrize("seed", sorted(SEEDS))
def test_seed_caught_by_its_own_contract(seed):
    contract, detail = SEEDS[seed]
    hit = [v for v in self_test()[1] if v.cell == seed]
    assert hit and hit[0].contract == contract and detail in hit[0].detail


def test_check_reports_a_clean_cell():
    """``trace_check.check`` on the CPU over a one-cell grid."""
    cell = T.tier0_decoders("cpu", shapes=("t0-restart",),
                            chunk_bits=256)[0]
    report = T.check(device="cpu", self_test=False, cells=[cell])
    assert report.ok and len(report.cells) == 1
    assert report.lines()[-1].startswith("0 contract violations across "
                                         "1 cells")
