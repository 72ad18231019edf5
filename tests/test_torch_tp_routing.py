"""The split MoE's routing over the data group, experts demoted by the
audit, and the ``kv_seq`` rule, across processes on the CPU, held against
the JAX package's unsharded forward (``tests/_torch_tp.py``).

* Drops: jamba's and deepseek-v2's smoke configs with ``capacity_factor``
  0.5 and prompts of 96 positions, so that experts overflow, over
  ``(2, 2)`` and over ``(2, 1)``
  (the data axis alone). The capacity and the ranks within each expert
  count the global batch, as ``repro``'s argsort over the traced global
  shape does: each MoE layer's ``dropped_frac`` and outputs are
  ``repro``'s. Counting per data rank would drop other slots (checked on
  ``repro``'s own routing).
* Experts demoted: jamba's with 6 experts over ``model=4``: the audit
  keeps ``mlp`` and every rank holds every expert's ``mlp`` columns.
* ``kv_seq``: jamba's and llama3-8b's with ``decode_kv_shard="seq"``, a
  cache of 62 positions (runs of 16, the last of 14) over ``(1, 4)``
  and ``(2, 2)``: the caches joined along their positions are the
  unsharded ones.

Limits as ``test_torch_tp_families.py``'s.
"""
import numpy as np
import pytest

from _torch_lm import B
from _torch_tp import (Case, check_logits_and_routing, join_caches,
                       rank_arrays, serve_all, tol_of)

# 2 x 96 prompt positions: enough slots an expert to pass its capacity
# (at least 32 slots, rounded up to a multiple of 32)
DROPS = tuple(Case(name, arch, moe=(("capacity_factor", 0.5),), s=96,
                   max_len=104)
              for name, arch in (("jamba-drop", "jamba-v0.1-52b"),
                                 ("dsv2-drop", "deepseek-v2-236b")))
DEMOTED = Case("jamba-e6", "jamba-v0.1-52b", moe=(("n_experts", 6),))
SEQ = tuple(Case(f"{arch.split('-')[0]}-seq", arch,
                 cfg=(("decode_kv_shard", "seq"),), max_len=62)
            for arch in ("jamba-v0.1-52b", "llama3-8b"))
MESHES = {(2, 2): DROPS + SEQ, (2, 1): DROPS, (1, 4): (DEMOTED,) + SEQ}
CASES = DROPS + (DEMOTED,) + SEQ
PAIRS = [(case, mesh) for mesh, cases in MESHES.items() for case in cases]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_routing")
    refs, runs = serve_all(root, CASES, MESHES)
    return root, refs, runs


def _id(pair):
    case, mesh = pair
    return f"{case.name}-d{mesh[0]}m{mesh[1]}"


@pytest.mark.parametrize("pair", PAIRS, ids=map(_id, PAIRS))
def test_split_serving_equals_repro(served, pair):
    case, mesh = pair
    root, refs, _ = served
    check_logits_and_routing(case, refs[case.name],
                             rank_arrays(root, case.name, mesh), mesh)


@pytest.mark.parametrize("pair", PAIRS, ids=map(_id, PAIRS))
def test_split_caches_join_to_unsharded(served, pair):
    case, mesh = pair
    root, refs, runs = served
    layout = runs[mesh][0]["layouts"][case.name]
    got, exp = join_caches(rank_arrays(root, case.name, mesh), mesh,
                           layout, refs[case.name]["caches"])
    assert set(got) == set(exp) and got
    for key, want in exp.items():
        np.testing.assert_allclose(got[key], want, **tol_of(case.arch),
                                   err_msg=f"{case.name} {key}")


def _kept(idx, n_experts, cap):
    """Slots kept by the sort-based capacity over the tokens of ``idx``."""
    flat = idx.reshape(-1)
    order = np.argsort(flat, kind="stable")
    first = np.searchsorted(flat[order], np.arange(n_experts))
    rank = np.arange(flat.size) - first[flat[order]]
    return int((rank < cap).sum())


@pytest.mark.parametrize("case", DROPS, ids=lambda c: c.name)
def test_drops_count_the_global_batch(served, case):
    """The cases drop slots, and counting the capacity per data rank
    would drop others: ``repro``'s ``dropped_frac`` (which the ranks
    equal, ``test_split_serving_equals_repro``) is not what two data
    ranks counting their own tokens would give."""
    from repro_torch.models.ffn import capacity

    _, refs, _ = served
    cfg = refs[case.name]["cj"]
    m = cfg.moe
    routing = refs[case.name]["routing"]
    assert max(d for _, d in routing) > 0.1
    differs = 0
    for idx, dropped in routing:
        t = idx.shape[0] // 2
        local = sum(_kept(idx[h * t:(h + 1) * t], m.n_experts,
                          capacity(cfg, t)) for h in range(2))
        np.testing.assert_allclose(
            1 - _kept(idx, m.n_experts, capacity(cfg, idx.shape[0]))
            / idx.size, dropped, atol=1e-7)
        differs += abs((1 - local / idx.size) - dropped) > 1e-6
    assert differs


def test_layouts_of_the_cases(served):
    """6 experts do not divide four ranks: the audit demotes ``experts``
    and keeps ``mlp``. The ``kv_seq`` rule holds in the decode layouts
    of the seq configs, and each rank's GQA cache holds 16 of the 62
    positions for every kv head."""
    root, _, runs = served
    e6 = runs[(1, 4)][0]["layouts"]["jamba-e6"]
    assert "experts" not in e6["split"] and "mlp" in e6["split"]
    assert e6["whole"] == []
    for mesh in ((1, 4), (2, 2)):
        model = mesh[1]
        for case in SEQ:
            assert runs[mesh][0]["layouts"][case.name]["kv_seq"]
            z = rank_arrays(root, case.name, mesh)[0]
            k = [z[f] for f in z.files if f.endswith(".k")]
            assert k and all(a.shape[1] == -(-62 // model) for a in k)
            assert all(a.shape[2] == 2 for a in k)    # every kv head
            assert all(a.shape[0] == B // mesh[0] for a in k)
    for case in DROPS:
        assert runs[(2, 1)][0]["layouts"][case.name]["split"] == []
