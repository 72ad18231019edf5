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
    """MLA, SSD, MoE and the encoder split over a model axis (they raised
    before they were ported): every layout of the smoke config on
    ``(1, 2)``, ``(1, 4)`` and ``(2, 2)`` cuts ``heads``, ``mlp`` and
    ``vocab`` and holds nothing whole; over the data axis alone they
    serve whole."""
    ct = TC.get_smoke_config(arch)
    for data, model in ((1, 2), (1, 4), (2, 2)):
        for rank in range(data * model):
            lay = TP.shard_layout(ct, duck_mesh(data, model), rank, 2)
            assert {"heads", "mlp", "vocab"} <= lay.split
            assert lay.whole == frozenset() and not lay.kv_seq
            if ct.moe is not None:
                assert "experts" in lay.split
    lay = TP.shard_layout(ct, duck_mesh(2, 1), 1, 2)
    assert lay.model == 1 and lay.rows(2) == slice(1, 2)
    assert lay.split == frozenset()


def test_kv_seq_rule_raises_a15b():
    """The ``kv_seq`` rule (it raised before it was ported) holds in a
    decode layout over a model axis: each rank's run of the cache length
    (``ceil(n / model)``, the last run cut short), for every kv head; a
    prefill layout has no such rule, nor a layout of one model rank."""
    ct = dataclasses.replace(TC.get_smoke_config("llama3-8b"),
                             decode_kv_shard="seq")
    runs = []
    for rank in range(4):
        lay = TP.shard_layout(ct, duck_mesh(1, 4), rank, 2, kind="decode")
        assert lay.kv_seq and "kv_seq" in lay.report()
        runs.append(lay.seq_range(62))
        caches = TM.init_caches(ct, 2, 62, device="cpu", layout=lay)
        assert tuple(caches[0].k.shape) == (2, 16, ct.n_kv_heads,
                                            ct.head_dim)
    assert runs == [slice(0, 16), slice(16, 32), slice(32, 48),
                    slice(48, 62)]
    assert not TP.shard_layout(ct, duck_mesh(1, 2), 0, 2,
                               kind="prefill").kv_seq
    assert not TP.shard_layout(ct, duck_mesh(2, 1), 0, 2).kv_seq


def test_kv_seq_cache_update_writes_owned_positions():
    """``cache_update`` with an offset writes only the new positions of
    the run it holds."""
    from repro_torch.models.attention import cache_update, init_kv_cache
    k = torch.arange(2 * 6 * 1 * 2, dtype=torch.float32).reshape(2, 6, 1, 2)
    for offset, lo, hi in ((0, 3, 4), (4, 4, 8), (8, 8, 9), (12, 0, 0)):
        cache = init_kv_cache(2, 4, 1, 2, device="cpu")
        cache = cache_update(cache, k, -k, 3, offset)
        assert cache.length == 6
        want = torch.zeros(2, 4, 1, 2)
        if hi > lo:
            want[:, lo - offset:hi - offset] = k[:, lo - 3:hi - 3]
        assert torch.equal(cache.k.float(), want), offset
        assert torch.equal(cache.v.float(), -want), offset


@pytest.mark.parametrize("arch", ["mamba2-780m", "jamba-v0.1-52b"])
def test_ssd_segment_cuts(arch):
    """An SSD's ``w_in`` is cut by segments: each rank holds its heads'
    ``z``, ``x`` and ``dt`` columns and all of ``B`` and ``C``; its conv
    its ``x`` channels and all of ``B`` and ``C``; its ``a_log``,
    ``dt_bias``, ``d_skip``, ``out_norm`` and ``w_out`` its heads'. The
    three ways to a rank's weights agree, and the parts give the whole
    back."""
    ct = dataclasses.replace(TC.get_smoke_config(arch),
                             param_dtype="float32")
    s = ct.ssm
    di, n = s.expand * ct.d_model, s.d_state
    nh = di // s.head_dim
    whole = TM.init_params(torch.Generator().manual_seed(3), ct,
                           device="cpu")
    flat = to_flat(whole)
    name = next(k for k in whole.specs() if k.endswith("ssm.w_in"))
    pre = name[:-len("w_in")]
    for model in (2, 4):
        parts = []
        for rank in range(model):
            lay = TP.shard_layout(ct, duck_mesh(1, model), rank, 2)
            sh = TM.init_sharded(torch.Generator().manual_seed(3), ct, lay,
                                 device="cpu")
            for other in (TM.shard_model(whole, lay),
                          params_from_jax(flat, ct, device="cpu",
                                          layout=lay)):
                for key, p in sh.named_parameters():
                    assert torch.equal(other.get_parameter(key), p), key
            parts.append(sh)
        k, h = di // model, nh // model
        w_in = whole.get_parameter(name)
        z, x, b, c, dt = torch.split(w_in, [di, di, n, n, nh], dim=1)
        for r, sh in enumerate(parts):
            got = sh.get_parameter(name)
            assert tuple(got.shape) == (ct.d_model, 2 * k + 2 * n + h)
            want = torch.cat([z[:, r * k:(r + 1) * k], x[:, r * k:(r + 1) * k],
                              b, c, dt[:, r * h:(r + 1) * h]], dim=1)
            assert torch.equal(got, want)
            conv = whole.get_parameter(pre + "conv_w")
            assert torch.equal(sh.get_parameter(pre + "conv_w"), torch.cat(
                [conv[:, r * k:(r + 1) * k], conv[:, di:]], dim=1))
        for leaf, dim in (("a_log", 0), ("out_norm", 0), ("w_out", 0)):
            assert torch.equal(torch.cat([sh.get_parameter(pre + leaf)
                                          for sh in parts], dim),
                               whole.get_parameter(pre + leaf))


def test_ssd_held_whole_where_the_audit_demotes_heads():
    """jamba-smoke on ``model=8``: its 4 attention heads do not divide 8,
    so the audit demotes ``heads`` and keeps ``mlp``; its SSD is then
    held whole on every rank (named in the layout's report), and its 4
    experts, demoted too, leave the MoE cut over ``mlp``: every rank
    holds every expert's ``mlp`` columns (the plan alone, no
    processes)."""
    ct = TC.get_smoke_config("jamba-v0.1-52b")
    lay = TP.shard_layout(ct, duck_mesh(1, 8), 5, 2)
    assert lay.split == {"mlp", "vocab"}
    assert lay.whole == {"SSD"} and "whole=['SSD']" in lay.report()
    sh = TM.abstract_params(ct, layout=lay)
    whole = TM.abstract_params(ct)
    for key, p in sh.named_parameters():
        if ".ssm." in key or ".attn." in key:
            assert p.shape == whole.get_parameter(key).shape, key
    moe = next(k for k in whole.specs() if k.endswith("ffn.w_gate")
               and whole.get_parameter(k).dim() == 3)
    e, d, f = whole.get_parameter(moe).shape
    assert tuple(sh.get_parameter(moe).shape) == (e, d, f // 8)
    caches = TM.init_caches(ct, 2, 16, device="cpu", layout=lay)
    ssm = next(c for c in caches if type(c).__name__ == "SSMCache")
    di = ct.ssm.expand * ct.d_model
    assert ssm.conv.shape[-1] == di + 2 * ct.ssm.d_state


def test_whisper_vocab_kept_whole():
    """whisper-base's vocabulary of 51,865 divides neither 2 nor 4: the
    audit keeps it whole (embedding and logits on every rank), as the
    reference's audit does, and splits the rest."""
    cj, ct = both("whisper-base", "full")
    for model in (2, 4):
        mesh = duck_mesh(1, model)
        lay = TP.shard_layout(ct, mesh, 0, 2)
        assert "vocab" not in lay.split
        assert {"heads", "kv_heads", "mlp"} <= lay.split
        pj = RP.param_rules(RP.rules_for(cj, mesh, "decode", 2), cj, mesh)
        assert not pj["vocab"]
        sh = TM.abstract_params(ct, layout=lay)
        assert tuple(sh.embed.shape) == (51865, ct.d_model)


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
