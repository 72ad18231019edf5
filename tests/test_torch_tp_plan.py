"""The port's model sharding plan (``repro_torch.dist.plan``: ``rules_for``,
``param_rules``, ``ShardLayout``), its parameter axes and its sliced
weights, held against the JAX package's ``repro.dist.plan`` and
``Model.specs`` in one process on the CPU.

``rules_for`` and ``param_rules`` read only a mesh's ``axis_names`` and
``shape``, so both packages' functions run on the same duck-typed
``(data, model)`` meshes.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.dist import plan as RP
from repro.dist import sharding as RS
from repro.models import model as RM
from repro_torch import configs as TC
from repro_torch.dist import plan as TP
from repro_torch.dist import sharding as TS
from repro_torch.dist import tensor_parallel as TPar
from repro_torch.launch.mesh import init_process_mesh, parse_mesh
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_jax

from _torch_lm import to_flat

MESHES = ((1, 2), (1, 4), (2, 2), (2, 4), (1, 8))
DENSE = ("llama3-8b", "gemma-7b", "nemotron-4-15b", "command-r-plus-104b",
         "llava-next-mistral-7b")
NOT_SPLIT = ("deepseek-v2-236b", "deepseek-v3-671b", "mamba2-780m",
             "jamba-v0.1-52b", "whisper-base")


def duck_mesh(data, model):
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": data, "model": model})


def norm(rules):
    return {k: tuple(v) if v else () for k, v in rules.items()}


def both(arch, size):
    get = "get_config" if size == "full" else "get_smoke_config"
    return getattr(RC, get)(arch), getattr(TC, get)(arch)


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_rules_and_param_rules_match_repro(arch, size):
    """Every kind and a dividing and a non-dividing batch on every mesh;
    the decode of a ``decode_kv_shard="seq"`` config too."""
    cj, ct = both(arch, size)
    for data, model in MESHES:
        mesh = duck_mesh(data, model)
        for kind in ("train", "prefill", "decode"):
            for batch in (8, 3):
                rj = RP.rules_for(cj, mesh, kind, batch)
                rt = TP.rules_for(ct, mesh, kind, batch)
                assert norm(rt) == norm(rj), (mesh.shape, kind, batch)
            pj = RP.param_rules(rj, cj, mesh)
            pt = TP.param_rules(rt, ct, mesh)
            assert norm(pt) == norm(pj), (mesh.shape, kind)
        seq = dict(decode_kv_shard="seq")
        assert norm(TP.rules_for(dataclasses.replace(ct, **seq), mesh,
                                 "decode", 8)) \
            == norm(RP.rules_for(dataclasses.replace(cj, **seq), mesh,
                                 "decode", 8))


def test_default_rules_match_repro():
    assert TS.DEFAULT_RULES == RS.DEFAULT_RULES


@pytest.mark.parametrize("arch,demoted", [
    ("command-r-plus-104b", {"heads", "kv_heads"}),
    ("llama3-8b", {"kv_heads"}),
    ("gemma-7b", set()),
])
def test_smoke_demotions_on_model_4(arch, demoted):
    """command-r-smoke (6 heads, 2 kv heads) keeps its mixer whole on four
    ranks, llama3-smoke (4, 2) its kv heads; as the reference demotes."""
    cj, ct = both(arch, "smoke")
    mesh = duck_mesh(1, 4)
    pt = TP.param_rules(TP.rules_for(ct, mesh, "decode", 2), ct, mesh)
    pj = RP.param_rules(RP.rules_for(cj, mesh, "decode", 2), cj, mesh)
    assert {k for k in TP.MODEL_AXES if not pt[k]} == demoted \
        == {k for k in TP.MODEL_AXES if not pj[k]}
    layout = TP.shard_layout(ct, mesh, 3, 2)
    assert layout.split == set(TP.MODEL_AXES) - demoted


def repro_specs(cfg, spec_tree):
    """The JAX package's spec tree under the port's names: ``prefix.{i}``
    and each period's pattern slots as ``blocks.{i}``."""
    n_pre, n_pat = len(cfg.prefix_layers), len(cfg.pattern)
    out = {}
    for name, axes in spec_tree.items():
        if name == "pattern":
            for key, ax in axes.items():
                slot, rest = key.split(".", 1)
                s = int(slot[len("slot"):])
                for p in range(cfg.n_periods):
                    out[f"blocks.{n_pre + p * n_pat + s}.{rest}"] = ax[1:]
        elif name.startswith("prefix."):
            out["blocks." + name[len("prefix."):]] = axes
        else:
            out[name] = axes
    return out


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_param_axes_match_repro_specs(arch, size):
    cj, ct = both(arch, size)
    exp = repro_specs(cj, RM.abstract_params(cj, max_positions=16).specs)
    got = TM.abstract_params(ct, max_positions=16).specs()
    assert got == exp


@pytest.mark.parametrize("arch", DENSE)
def test_layout_slices_reassemble(arch):
    """Each rank's parameters (``init_sharded`` from one seed, and
    ``shard_model`` and ``params_from_jax(layout=)`` of the whole model)
    are its slices of the whole model: joined in rank order along the
    cut dimension they give every parameter back exactly."""
    ct = dataclasses.replace(TC.get_smoke_config(arch),
                             param_dtype="float32")
    whole = TM.init_params(torch.Generator().manual_seed(3), ct,
                           device="cpu")
    flat = to_flat(whole)
    for data, model in ((1, 2), (1, 4), (2, 2)):
        mesh = duck_mesh(data, model)
        parts = []
        for rank in range(data * model):
            lay = TP.shard_layout(ct, mesh, rank, 2)
            sh = TM.init_sharded(torch.Generator().manual_seed(3), ct, lay,
                                 device="cpu")
            assert sh.layout == lay
            for other in (TM.shard_model(whole, lay),
                          params_from_jax(flat, ct, device="cpu",
                                          layout=lay)):
                for name, p in sh.named_parameters():
                    assert torch.equal(other.get_parameter(name), p), name
            if lay.data_rank == 0:
                parts.append((lay, sh))
        specs = whole.specs()
        for name, p in whole.named_parameters():
            cuts = [lay.param_cut(p.shape, specs[name]) for lay, _ in parts]
            got = [sh.get_parameter(name) for _, sh in parts]
            if cuts[0] is None:
                assert all(c is None and torch.equal(g, p)
                           for c, g in zip(cuts, got)), name
            else:
                assert [c[1] for c in cuts] == sorted(c[1] for c in cuts)
                assert torch.equal(torch.cat(got, dim=cuts[0][0]), p), name


def test_layout_rows_heads_and_caches():
    ct = TC.get_smoke_config("llama3-8b")         # 4 heads, 2 kv heads
    lay = TP.shard_layout(ct, duck_mesh(2, 2), 3, 4)
    assert (lay.data_rank, lay.model_rank) == (1, 1)
    assert lay.rows(4) == slice(2, 4)
    assert lay.local("heads", 4) == slice(2, 4)
    assert lay.local("kv_heads", 2) == slice(1, 2)
    assert lay.local("vocab", 512) == slice(256, 512)
    batch = lay.batch({"tokens": torch.arange(8).reshape(4, 2)})
    assert batch["tokens"].tolist() == [[4, 5], [6, 7]]
    caches = TM.init_caches(ct, 4, 16, device="cpu", layout=lay)
    assert tuple(caches[0].k.shape) == (2, 16, 1, ct.head_dim)
    # a batch that does not divide the data axis is served whole
    odd = TP.shard_layout(ct, duck_mesh(2, 2), 3, 3)
    assert not odd.batch_split and odd.rows(3) == slice(0, 3)
    # kv heads the audit keeps whole: every rank's cache holds them all
    four = TP.shard_layout(ct, duck_mesh(1, 4), 2, 4)
    assert four.local("kv_heads", 2) == slice(0, 2)
    assert four.local("heads", 4) == slice(2, 3)
    assert tuple(TM.init_caches(ct, 4, 16, device="cpu",
                                layout=four)[0].k.shape)[2] == 2


@pytest.mark.parametrize("arch", NOT_SPLIT)
def test_families_not_split_raise_a15b(arch):
    """MLA, SSD, MoE and the encoder raise over a model axis, and are never
    replicated in silence; over the data axis alone they serve."""
    ct = TC.get_smoke_config(arch)
    with pytest.raises(NotImplementedError, match="A15b"):
        TP.shard_layout(ct, duck_mesh(1, 2), 0, 2)
    lay = TP.shard_layout(ct, duck_mesh(2, 1), 1, 2)
    assert lay.model == 1 and lay.rows(2) == slice(1, 2)


def test_kv_seq_rule_raises_a15b():
    ct = dataclasses.replace(TC.get_smoke_config("llama3-8b"),
                             decode_kv_shard="seq")
    with pytest.raises(NotImplementedError, match="kv_seq.*A15b"):
        TP.shard_layout(ct, duck_mesh(1, 2), 0, 2, kind="decode")
    TP.shard_layout(ct, duck_mesh(1, 2), 0, 2, kind="prefill")


def test_one_model_rank_runs_no_collective():
    """With one model rank the helpers are the single-card code: no
    process group is needed."""
    ct = TC.get_smoke_config("llama3-8b")
    lay = TP.shard_layout(ct, duck_mesh(2, 1), 0, 4)
    x = torch.randn(2, 3, 8)
    assert TPar.all_reduce_sum(x, lay) is x
    assert TPar.all_gather(x, lay) is x
    emb = torch.randn(10, 8)
    tok = torch.tensor([[1, 9]])
    assert torch.equal(TPar.vocab_embed(tok, emb, lay), emb[tok])
    assert torch.equal(TPar.vocab_logits(x, emb.T, lay), x @ emb.T)
    a, b = torch.randn(5, 8).bfloat16(), torch.randn(8, 3).bfloat16()
    np.testing.assert_allclose(TPar.f32_product(a, b).numpy(),
                               (a.double() @ b.double()).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_process_mesh_arguments():
    assert parse_mesh("data=2,model=2") == (2, 2)
    assert parse_mesh("model=4") == (1, 4)
    with pytest.raises(ValueError):
        parse_mesh("model=x")
    with pytest.raises(ValueError, match="backend"):
        init_process_mesh(1, 2, None, "cpu")
    with pytest.raises(ValueError, match="nccl"):
        init_process_mesh(1, 2, "nccl", "cpu")
    one = init_process_mesh(1, 1, None, "cpu")
    assert one.size == 1 and one.backend is None and one.coords == (0, 0)
