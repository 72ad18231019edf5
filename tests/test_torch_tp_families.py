"""Tensor-parallel serving of the other families across processes on the
CPU: MoE over its experts, MLA's and SSD's heads, the encoder and the
cross-attention, held against the JAX package's unsharded forward.

For each of the five archs' smoke configs (jamba, deepseek-v2,
deepseek-v3, mamba2, whisper) in f32, the port's unsharded prefill and 4
greedy steps, ``repro``'s (compiled) fed the same tokens, and ranks of
``(1, 2)``, ``(1, 4)`` and ``(2, 2)`` meshes over gloo, every arch in
each (``tests/_torch_tp.py``).

Limits: each rank's logits within 1e-4 of ``repro``'s (jamba 1e-3) and
normwise within 1e-4 of the port's unsharded ones, equal bit for bit
across its model group; greedy tokens ``repro``'s; every MoE layer's
experts for each token ``repro``'s and the same on every rank, its
``dropped_frac`` ``repro``'s; the ranks' caches, joined
by kv heads, SSD heads and channels and rows, within the same limits of
the port's unsharded caches.
"""
import numpy as np
import pytest

from _torch_tp import (Case, check_logits_and_routing, join_caches,
                       rank_arrays, serve_all, tol_of)

FAMILIES = ("jamba-v0.1-52b", "deepseek-v2-236b", "deepseek-v3-671b",
            "mamba2-780m", "whisper-base")
CASES = tuple(Case(arch, arch) for arch in FAMILIES)
MESHES = ((1, 2), (1, 4), (2, 2))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_families")
    refs, runs = serve_all(root, CASES, {mesh: CASES for mesh in MESHES})
    return root, refs, runs


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"d{m[0]}m{m[1]}")
@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_split_serving_equals_repro(served, case, mesh):
    root, refs, runs = served
    for r, res in enumerate(runs[mesh]):
        assert res["rank"] == r and tuple(res["coords"]) == divmod(
            r, mesh[1])
    check_logits_and_routing(case, refs[case.name],
                             rank_arrays(root, case.name, mesh), mesh)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"d{m[0]}m{m[1]}")
@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_split_caches_join_to_unsharded(served, case, mesh):
    root, refs, runs = served
    layout = runs[mesh][0]["layouts"][case.name]
    got, exp = join_caches(rank_arrays(root, case.name, mesh), mesh,
                           layout, refs[case.name]["caches"])
    assert set(got) == set(exp) and got
    for key, want in exp.items():
        np.testing.assert_allclose(got[key], want, **tol_of(case.arch),
                                   err_msg=f"{case.name} {key}")


def test_every_family_splits(served):
    """Over two model ranks every family's layers split: MoE by experts,
    MLA and SSD by heads (SSD's cut by segments, ``mlp`` and ``heads``
    both split), whisper's encoder and cross-attention by heads; nothing
    is held whole. On four, jamba-smoke's two kv heads stay whole."""
    runs = served[2]
    two = runs[(1, 2)][0]["layouts"]
    for case in CASES:
        assert {"heads", "mlp", "vocab"} <= set(two[case.name]["split"])
        assert two[case.name]["whole"] == []
    for arch in ("jamba-v0.1-52b", "deepseek-v2-236b", "deepseek-v3-671b"):
        assert "experts" in two[arch]["split"]
    four = runs[(1, 4)][0]["layouts"]["jamba-v0.1-52b"]
    assert "kv_heads" not in four["split"] and "experts" in four["split"]
