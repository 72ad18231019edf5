"""Training split over gloo processes on the CPU: the loss, every gradient,
the train step's norm, moments and residual, held against the JAX
package's unsharded ``jax.value_and_grad`` and the port's unsplit run
(``tests/_torch_tp_train.py``).

Meshes ``(1, 2)`` and ``(2, 2)`` train all ten archs' smoke configs in
f32 and deepseek-v2's with ``capacity_factor`` 0.5 and 96 positions a
row, so that experts overflow (``dsv2-drop``); ``(2, 1)`` trains
llama3-8b's and ``dsv2-drop``. Against ``repro`` (llama3-8b, the JAX
package's own train test's arch, and ``dsv2-drop``: MoE with drops, MLA,
a dense prefix layer) on all three meshes: the loss within rtol 1e-5,
each joined gradient within 1e-3 of its leaf's largest |value|, each
MoE layer call's routing and ``dropped_frac`` ``repro``'s. Against the
port's unsplit run: the loss within rtol 1e-5, each joined gradient
normwise within 1e-4 (four archs looser: ``OWN_NORM_LOOSE`` says why),
routing equal; after one ``make_train_step`` step the grad norm the
norm of the joined gradients (rtol 1e-5) and within the gradients'
limit of the unsplit run's, the joined moments within 2 (mu) and 4 (nu)
times that limit, the
parameters within 2 x lr, the joined int8 residual as
``test_train_step_int8_residual`` says, every part held whole
bit-identical across its model group, every replica bit-identical
across its data group.
"""
import numpy as np
import pytest

from repro_torch.configs import ARCH_IDS
from repro_torch.dist.plan import CUT, PARTIAL, WHOLE, grad_classes, \
    shard_layout
from repro_torch.models import model as TM
from repro_torch.train.step import train_rows

from _torch_tp_train import (GRAD_TOL, LOSS_RTOL, STEP_ATOL, Case,
                             DuckMesh, check_routing, held_whole, join,
                             normwise, own_limit, own_routing, rank_arrays,
                             rank_models, run_slice, to_jax_names,
                             train_all)

DROP = Case("dsv2-drop", "deepseek-v2-236b", moe=(("capacity_factor", 0.5),),
            s=96)
ALL = tuple(Case(arch, arch) for arch in ARCH_IDS) + (DROP,)
BY_NAME = {c.name: c for c in ALL}
REPRO = ("llama3-8b", DROP.name)
MESHES = {(1, 2): ALL, (2, 2): ALL,
          (2, 1): (BY_NAME["llama3-8b"], DROP)}
PAIRS = [(c, mesh) for mesh, cases in MESHES.items() for c in cases]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_train")
    refs, runs = train_all(root, ALL, MESHES, against_repro=REPRO)
    return root, refs, runs


def _id(pair):
    case, mesh = pair
    return f"{case.name}-d{mesh[0]}m{mesh[1]}"


def _ranks(trained, case, mesh):
    root, refs, runs = trained
    for r, res in enumerate(runs):
        assert res["rank"] == r and tuple(res["coords"]) == divmod(r, 2)
    return refs[case.name], rank_arrays(root, case.name, mesh), \
        rank_models(case, mesh)


@pytest.mark.parametrize("pair", [p for p in PAIRS if p[0].name in REPRO],
                         ids=_id)
def test_split_training_equals_repro(trained, pair):
    case, mesh = pair
    ref, ranks, models = _ranks(trained, case, mesh)
    cfg = case.config()
    for r, z in enumerate(ranks):
        np.testing.assert_allclose(float(z["loss"]), ref["jax_loss"],
                                   rtol=LOSS_RTOL, err_msg=f"rank {r}")
    check_routing(ranks, ref["routing"], mesh, f"{case.name} {mesh}")
    assert any(d > 0 for _, d in ref["routing"]) == (case is DROP)
    for d in range(mesh[0]):
        got = to_jax_names(cfg, join(ranks, models, mesh, "grad", d))
        assert set(got) == set(ref["jax_grads"])
        for k, exp in ref["jax_grads"].items():
            scale = float(np.abs(exp).max())
            np.testing.assert_allclose(got[k], exp, rtol=0,
                                       atol=GRAD_TOL * scale,
                                       err_msg=f"{case.name} {mesh} {k}")


@pytest.mark.parametrize("pair", [p for p in PAIRS if p[1] != (2, 1)],
                         ids=_id)
def test_split_training_equals_unsplit(trained, pair):
    case, mesh = pair
    ref, ranks, models = _ranks(trained, case, mesh)
    own = ref["own"]
    check_routing(ranks, own_routing(ref), mesh, f"{case.name} {mesh}")
    limit = own_limit(case.arch)
    worst = {}
    for r, z in enumerate(ranks):
        np.testing.assert_allclose(float(z["loss"]), float(own["loss"]),
                                   rtol=LOSS_RTOL)
    for d in range(mesh[0]):
        got = join(ranks, models, mesh, "grad", d)
        for k, v in got.items():
            worst[k] = normwise(v, own[f"grad.{k}"])
    name = max(worst, key=worst.get)
    print(f"{case.name} {mesh}: gradients normwise within "
          f"{worst[name]:.2e} ({name}) of the unsplit run's")
    assert worst[name] <= limit, (name, worst[name], limit)


@pytest.mark.parametrize("pair", PAIRS, ids=_id)
def test_train_step_over_mesh(trained, pair):
    case, mesh = pair
    ref, ranks, models = _ranks(trained, case, mesh)
    own = ref["own"]
    data, model = mesh
    limit = own_limit(case.arch)
    for d in range(data):
        grads = join(ranks, models, mesh, "grad", d)
        total = np.sqrt(sum(np.sum(np.square(g.astype(np.float64)))
                            for g in grads.values()))
        for r in range(d * model, (d + 1) * model):
            # the group's norm is the norm of the joined gradients
            np.testing.assert_allclose(float(ranks[r]["gnorm"]), total,
                                       rtol=LOSS_RTOL, err_msg=f"rank {r}")
            np.testing.assert_allclose(float(ranks[r]["gnorm"]),
                                       float(own["gnorm"]), rtol=limit)
        # the clip scale (1 / the norm) carries the norm's difference into
        # every moment, and nu squares the clipped gradient
        for prefix, factor in (("mu", 2), ("nu", 4)):
            for k, v in join(ranks, models, mesh, prefix, d).items():
                assert normwise(v, own[f"{prefix}.{k}"]) <= factor * limit, \
                    (prefix, k, normwise(v, own[f"{prefix}.{k}"]))
        for k, v in join(ranks, models, mesh, "param", d).items():
            np.testing.assert_allclose(v, own[f"param.{k}"], rtol=0,
                                       atol=STEP_ATOL, err_msg=k)
    # what each model group holds whole is the same on its ranks, bit for
    # bit; each data rank's replica is the others'
    for r, z in enumerate(ranks):
        lead = ranks[(r // model) * model]
        for name, runs in held_whole(models, r).items():
            for prefix in ("param", "mu", "nu", "err", "grad"):
                key = f"{prefix}.{name}"
                for dim, start, n in runs:
                    np.testing.assert_array_equal(
                        run_slice(z[key], dim, start, n),
                        run_slice(lead[key], dim, start, n),
                        err_msg=f"rank {r} {key}")
        replica = ranks[r % model]
        for key in z:
            if key.split(".")[0] in ("param", "mu", "nu", "err", "grad"):
                np.testing.assert_array_equal(z[key], replica[key],
                                              err_msg=f"rank {r} {key}")


def _levels(g, err, scale):
    return (g.astype(np.float64) - err) / scale


@pytest.mark.parametrize("pair", PAIRS, ids=_id)
def test_train_step_int8_residual(trained, pair):
    """With ``compress_grads`` (on the plain step's gradients):
    every joined leaf's dequantized gradient ``g - residual`` is a whole
    number of steps of the whole leaf's scale (its largest ``|g|`` over
    the group, / 127), within the residual's bf16 rounding; at least 99%
    of the elements take the unsplit run's int8 level, and there the
    residuals differ by no more than the gradients do plus a bf16
    rounding (a gradient within the split's rounding of a level's
    midpoint takes the neighbouring level: the residual then differs by
    a step); the norm of the dequantized gradients within the plain
    step's limit of the unsplit run's."""
    case, mesh = pair
    ref, ranks, models = _ranks(trained, case, mesh)
    own = ref["own"]
    limit = own_limit(case.arch)
    for z in ranks:
        np.testing.assert_allclose(float(z["gnorm_int8"]),
                                   float(own["gnorm_int8"]), rtol=limit)
    agree = n = 0
    for d in range(mesh[0]):
        grads = join(ranks, models, mesh, "grad", d)
        errs = join(ranks, models, mesh, "err", d)
        for k, g in grads.items():
            if not np.any(g):
                continue
            e, g_o, e_o = errs[k], own[f"grad.{k}"], own[f"err.{k}"]
            scale = np.abs(g).max() / 127.0
            scale_o = np.abs(g_o).max() / 127.0
            lv = _levels(g, e, scale)
            assert np.abs(lv - np.round(lv)).max() <= 0.01, k
            lv_o = np.round(_levels(g_o, e_o, scale_o))
            same = np.round(lv) == lv_o
            agree += int(same.sum())
            n += same.size
            # g - level x scale on both sides, in f32 (a few ulps of g:
            # the scale and the product are f32), rounded to bf16
            slack = np.abs(g - g_o) + np.abs(lv_o) * abs(scale - scale_o) \
                + 2 ** -21 * (np.abs(g) + np.abs(g_o)) \
                + 2 ** -7 * np.maximum(np.abs(e), np.abs(e_o))
            assert np.all((np.abs(e - e_o) <= slack)[same]), k
    print(f"{case.name} {mesh}: {agree} of {n} int8 levels the unsplit "
          f"run's")
    assert agree >= 0.99 * n


@pytest.mark.parametrize("case", [c for c in ALL
                                  if c.arch in ("deepseek-v2-236b",
                                                "deepseek-v3-671b",
                                                "jamba-v0.1-52b")],
                         ids=lambda c: c.name)
def test_partial_gradients_need_their_sum(trained, case):
    """A parameter held whole whose consumers are split: one rank's
    gradient alone misses the unsplit one by more than the limit, the sum
    over the model group meets it."""
    mesh = (1, 2)
    ref, ranks, models = _ranks(trained, case, mesh)
    own = ref["own"]
    classes = grad_classes(models[0])
    partial = [k for k, c in classes.items()
               if c.kind == PARTIAL and np.any(own[f"grad.{k}"])]
    assert partial
    for k in partial:
        exp = own[f"grad.{k}"]
        assert normwise(ranks[0][f"raw.{k}"], exp) > 0.1, k
        assert normwise(ranks[0][f"grad.{k}"], exp) <= own_limit(case.arch)


def _classes(arch, data, model, rank):
    cfg = Case(arch, arch).config()
    lay = shard_layout(cfg, DuckMesh(data, model), rank, 4, "train")
    return grad_classes(TM.abstract_params(cfg, layout=lay))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_grad_classes(arch):
    """Every parameter with an axis the layout splits is cut; a whole one
    is partial exactly where a sibling in its sub-layer is cut: MLA's
    latent projections and norms, the MoE router, GQA's ``wk``/``wv``
    where ``kv_heads`` stay whole (jamba-smoke's 2 over model=4); SSD's
    cut leaves hold ``B`` and ``C`` as runs held whole; every rank of a
    group agrees; a data-only mesh leaves everything whole."""
    for model in (2, 4):
        ranks = [_classes(arch, 1, model, r) for r in range(model)]
        for c in ranks[1:]:
            assert {k: v.kind for k, v in c.items()} == \
                {k: v.kind for k, v in ranks[0].items()}
        classes = ranks[0]
        cfg = Case(arch, arch).config()
        lay = shard_layout(cfg, DuckMesh(1, model), 0, 4, "train")
        m = TM.abstract_params(cfg, layout=lay)
        for name, axes in m.specs().items():
            cut = any(a in lay.split for a in axes)
            if m.segments(name) is not None:
                cut = cut and lay.splits("mlp") and lay.splits("heads")
            assert (classes[name].kind == CUT) == cut, (name, model)
        partial = {k.split(".", 2)[-1] for k, c in classes.items()
                   if c.kind == PARTIAL}
        expect = set()
        if cfg.mla is not None:
            expect |= {f"attn.{w}" for w in ("w_dq", "q_norm", "w_dkv",
                                             "kv_norm", "w_kr")}
        if cfg.moe is not None:
            expect.add("ffn.router")
            if cfg.moe.router == "sigmoid_bias":
                expect.add("ffn.router_bias")
        if not lay.splits("kv_heads") and lay.splits("heads"):
            expect |= {"attn.wk", "attn.wv"}
            if cfg.is_encdec:
                expect |= {"xattn.wk", "xattn.wv"}
        assert partial == expect, (model, partial, expect)
        mixed = {k.split(".", 2)[-1] for k, c in classes.items()
                 if c.whole_runs}
        assert mixed == ({"ssm.w_in", "ssm.conv_w", "ssm.conv_b"}
                         if cfg.ssm is not None and "SSD" not in lay.whole
                         else set()), mixed
    data_only = _classes(arch, 2, 1, 1)
    assert {c.kind for c in data_only.values()} == {WHOLE}


def test_train_rows_split_each_microbatch():
    """A data rank's rows are its share of each microbatch's run of the
    global batch (the JAX step's split), in order."""
    lay = shard_layout(Case("llama3-8b", "llama3-8b").config(),
                       DuckMesh(2, 1), 1, 8, "train")
    assert train_rows(lay, 8).tolist() == [4, 5, 6, 7]
    assert train_rows(lay, 8, 2).tolist() == [2, 3, 6, 7]
    assert train_rows(None, 4).tolist() == [0, 1, 2, 3]
    with pytest.raises(ValueError):
        train_rows(lay, 6, 2)
