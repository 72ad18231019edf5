"""The port's specmap and sequential schedules against the JAX package's,
on shared plans (``tests/_torch_sync.py``): the half of
``test_torch_sync.py``'s schedule cases split off so that the two files
take about as long. Exits, ``sync_rounds`` and ``converged`` must be
bit-identical to ``repro.core.sync`` (``backend="jnp"``), on identity
plans and (specmap) on ``balance_lanes`` permutations, and the
coefficients must equal the sequential oracle.
"""
import pytest

from _torch_corpus import corpus
from _torch_sync import one_thread  # noqa: F401 (autouse)
from _torch_sync import check_schedule, schedule_cases


@pytest.mark.parametrize("sync,name,chunk_bits",
                         schedule_cases(("specmap", "sequential")))
def test_schedule_matches_repro(sync, name, chunk_bits):
    check_schedule(corpus(name), sync, chunk_bits)


@pytest.mark.parametrize("name", ["420", "restart", "mixed"])
@pytest.mark.parametrize("sync", ["specmap"])
def test_schedule_on_a_permuted_plan_matches_repro(sync, name):
    """A ``balance_lanes(plan, 4, "lpt")`` plan, carried over with its
    lane permutation (``permuted=True``)."""
    check_schedule(corpus(name), sync, 128, balance=4)
