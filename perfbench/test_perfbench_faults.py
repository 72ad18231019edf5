"""The check that decides ``correct``, with the timed path broken
underneath (``perfbench.rehearse``): each fault a one-card decode cell
can have, and the control (the reference in TF32 in the program's
place), comes out not correct; a run that has a module of the JAX
package's name loaded prints no result."""
import pytest

from perfbench.rehearse import STUB
from perfbench.tiny_cell import CELL, make_root, rehearse

ARGS = ("--workload", CELL, "--seed", "2147483699", "--seconds", "0.5",
        "--trace", "0")


@pytest.mark.parametrize("fault", ["stale", "half", "altered", "control"])
def test_a_broken_timed_path_is_not_correct(tmp_path, fault):
    rc, last, err = rehearse(make_root(tmp_path), *ARGS, fault=fault)
    assert rc == 0, err
    assert last["correct"] is False, err
    assert any(v["value"] > v["limit"] for v in last["checks"].values())


def test_a_run_that_loaded_the_jax_package_prints_no_result(tmp_path):
    rc, last, err = rehearse(make_root(tmp_path), *ARGS, fault="import")
    assert rc != 0 and last is None
    assert STUB in err
