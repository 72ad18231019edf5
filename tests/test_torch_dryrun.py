"""The port's dry run (``repro_torch.launch.dryrun``) and what it reads
(``configs.input_specs``, the production meshes, ``dist.collectives``,
``launch.report.render``), held against the JAX package's plan on the
CPU.

The JAX package's ``launch/dryrun.py`` sets ``XLA_FLAGS`` (512 host
devices) when it is imported; the import below restores the variable at
once, so that nothing else in this process sees it. Its per-card shapes
come from ``repro.dist.plan`` over a ``jax.sharding.AbstractMesh``: no
compile, no device.

Every dry run here starts and ends its own "fake" process group
(``dryrun.fake_mesh``); the ``no_group_left`` fixture holds that none
outlives a test.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro import configs as RC
from repro.dist import plan as RP
from repro.models import model as RM
from repro.serve import step as RSS
from repro.train import optimizer as RO
from repro_torch import configs as TC
from repro_torch.dist import plan as TP
from repro_torch.dist.collectives import CollectiveCounter, summarize
from repro_torch.launch import dryrun as D
from repro_torch.launch import report as TR
from repro_torch.launch.mesh import H100, MeshShape, make_production_mesh
from repro_torch.models import model as TM
from repro_torch.tools.tp_train import step_flops

_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as RD  # noqa: E402  (sets XLA_FLAGS)
if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

ARCHS = TC.ARCH_IDS
SHAPES = list(TC.SHAPES)
SSD_ARCHS = ("jamba-v0.1-52b", "mamba2-780m")
DENSE = ("llama3-8b", "gemma-7b", "nemotron-4-15b", "command-r-plus-104b",
         "llava-next-mistral-7b")
# the JAX package's production meshes -> the port's shapes of them
PRODUCTION = {"single": ((16, 16), ("data", "model")),
              "multi": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(autouse=True)
def no_group_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized(), "a dry run left its process group"


def tdtype(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def test_production_meshes():
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    multi = make_production_mesh(multi_pod=True)
    assert multi.shape == {"data": 32, "model": 16} and multi.size == 512
    # the two pods split the batch as one data axis of 32
    am = AbstractMesh(*PRODUCTION["multi"])
    for arch in ARCHS:
        for kind in ("train", "prefill", "decode"):
            rj = RP.rules_for(RC.get_config(arch), am, kind, 128)
            rt = TP.rules_for(TC.get_config(arch), multi, kind, 128)
            assert (tuple(rj["batch"]) != ()) == (tuple(rt["batch"]) != ())
    assert H100["peak_flops_bf16"] == 989e12 and H100["hbm_bw"] == 3.35e12


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_repro(arch):
    cj, ct = RC.get_config(arch), TC.get_config(arch)
    for shape in SHAPES:
        for batch in (None, 3):
            want = RC.input_specs(cj, shape, batch_override=batch)
            got = TC.input_specs(ct, shape, batch_override=batch)
            assert list(got) == list(want), shape
            for k, t in got.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == want[k].shape, (shape, k)
                assert tdtype(t) == str(want[k].dtype), (shape, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_rules_match_repro(arch):
    """Applicability (and its reason), microbatches, the optimizer and
    ``model_flops`` for every shape."""
    for shape in SHAPES:
        assert TC.cell_is_applicable(arch, shape) \
            == RC.cell_is_applicable(arch, shape)
        assert D.default_microbatches(arch, shape) \
            == RD.default_microbatches(arch, shape)
        assert D.model_flops(arch, shape) == RD.model_flops(arch, shape)
    oj = RD.opt_config_for(RC.get_config(arch))
    ot = D.opt_config_for(TC.get_config(arch))
    assert (ot.moment_dtype, ot.master_weights) \
        == (oj.moment_dtype, oj.master_weights)


def repro_card_bytes(arch: str, mesh: str):
    """(parameter bytes, moment bytes) a card of the JAX package's plan on
    its production ``mesh`` for ``train_4k``: each leaf's shard shape (the
    learned decoder positions, where the config has them, sized as its
    dry run sizes them)."""
    am = AbstractMesh(*PRODUCTION[mesh])
    cfg = RC.get_config(arch)
    model = RM.abstract_params(
        cfg, max_positions=4096 + 8 if cfg.norm == "layernorm" else 0)
    prules = RP.param_rules(RP.rules_for(cfg, am, "train", 256), cfg, am)
    shard = jax.tree.leaves(RP.param_shardings(model.specs, prules, am))
    params = jax.tree.leaves(model.params)
    opt = RO.abstract_opt_state(model.params, RD.opt_config_for(cfg))
    moments = jax.tree.leaves(opt.mu) + jax.tree.leaves(opt.nu)

    def nbytes(leaves):
        return sum(int(np.prod(s.shard_shape(x.shape))) * x.dtype.itemsize
                   for s, x in zip(shard * (len(leaves) // len(shard)),
                                   leaves))

    return nbytes(params), nbytes(moments)


def ssd_cut_bytes(cfg, model: int, itemsize: int) -> int:
    """The bytes a rank holds beyond an even cut of each SSD layer: the
    port holds ``B`` and ``C`` (``d_state`` columns each) whole in
    ``w_in`` (d rows), ``conv_w`` (``d_conv`` rows) and ``conv_b``,
    where the JAX package cuts the whole dimension evenly."""
    s = cfg.ssm
    n_ssd = sum(m == "ssm" for m, _ in cfg.layer_specs)
    cols = 2 * s.d_state * (model - 1)
    rows = cfg.d_model + s.d_conv + 1
    assert cols * rows * itemsize % model == 0
    return n_ssd * cols * rows * itemsize // model


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_moment_bytes_match_repro(arch, mesh):
    """A card's parameter and AdamW moment bytes at full width on the
    production mesh equal the JAX package's shard shapes to the byte;
    for jamba and mamba2 the difference is exactly the SSD's B and C
    columns the port's segment cut holds whole (ROADMAP section C)."""
    cfg = TC.get_config(arch)
    tm = make_production_mesh(multi_pod=mesh == "multi")
    layout = TP.shard_layout(cfg, tm, 0, 256, "train")
    cell = D.build_cell(cfg, "train_4k", layout, batch=256, seq=4096)
    got = D.cell_bytes(cell)
    want_p, want_m = repro_card_bytes(arch, mesh)
    extra_p = extra_m = 0
    if arch in SSD_ARCHS:
        opt = D.opt_config_for(cfg)
        moment = 4 if opt.moment_dtype == "float32" else 2
        extra_p = ssd_cut_bytes(cfg, tm.model, 2)
        extra_m = 2 * ssd_cut_bytes(cfg, tm.model, moment)
        assert extra_p > 0
    assert got["param_bytes"] == want_p + extra_p
    # the optimizer state's step counter is one int32
    assert got["opt_bytes"] == want_m + extra_m + 4


def count_cache_bytes(cfg, layout, batch: int, max_len: int) -> int:
    """A card's cache bytes, counted from the config and the layout's
    splits, independently of ``init_caches``."""
    rows = layout.rows(batch)
    b = rows.stop - rows.start
    m = layout.model
    total = 0
    for mixer, _ in cfg.layer_specs:
        if mixer == "attn":
            heads, length = cfg.n_kv_heads, max_len
            if layout.kv_seq:
                length = -(-max_len // m)
            elif layout.splits("kv_heads"):
                heads //= m
            n = b * length * heads
            total += 2 * n * cfg.head_dim * (
                1 if cfg.kv_cache_dtype == "int8" else 2)
            if cfg.kv_cache_dtype == "int8":
                total += 2 * n * 2          # bf16 scales
        elif mixer == "mla":
            total += b * max_len * (cfg.mla.kv_lora + cfg.mla.rope_dim) * 2
        elif mixer == "ssm":
            s = cfg.ssm
            parts = m if layout.splits("mlp") and layout.splits("heads") \
                else 1
            di = s.expand * cfg.d_model // parts
            total += b * (s.d_conv - 1) * (di + 2 * s.d_state) * 2
            total += b * (di // s.head_dim) * s.d_state * s.head_dim * 4
    return total


def repro_cache_bytes(arch: str, shape: str, mesh: str) -> int:
    """A card's cache bytes under the JAX package's plan: its caches are
    split over the batch alone (``repro.dist.plan.cache_shardings``). Its
    fill lengths (int32 arrays; the port's are Python ints) aside."""
    seq, batch, kind = RC.SHAPES[shape]
    am = AbstractMesh(*PRODUCTION[mesh])
    cfg = RC.shape_overrides(RC.get_config(arch), shape)
    max_len = seq + 8 if kind == "prefill" else seq
    caches = RSS.abstract_caches(cfg, batch, max_len)
    shard = RP.cache_shardings(cfg, RP.rules_for(cfg, am, kind, batch), am)
    return sum(int(np.prod(s.shard_shape(x.shape))) * x.dtype.itemsize
               for s, x in zip(jax.tree.leaves(shard),
                               jax.tree.leaves(caches))
               if x.dtype != np.int32)


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_bytes(arch, mesh):
    """A card's caches at full width in every serving cell: the bytes of
    ``build_cell``'s caches equal an independent count of the port's own
    layout (its kv heads, or under ``kv_seq`` its positions; SSD's heads
    and x channels; MLA's latent whole). The JAX package splits caches
    over the batch only: on a mesh of the same data ranks and one model
    rank the port's bytes equal its."""
    tm = make_production_mesh(multi_pod=mesh == "multi")
    for shape in ("prefill_32k", "decode_32k", "long_500k"):
        if not TC.cell_is_applicable(arch, shape)[0]:
            continue
        seq, batch, kind = TC.SHAPES[shape]
        cfg = TC.shape_overrides(TC.get_config(arch), shape)
        max_len = seq + 8 if kind == "prefill" else seq
        for m in (tm, MeshShape(tm.data, 1)):
            layout = TP.shard_layout(cfg, m, 0, batch, kind)
            cell = D.build_cell(cfg, shape, layout, batch=batch, seq=seq)
            got = D.cell_bytes(cell)["cache_bytes"]
            enc = 0
            if kind == "decode" and cfg.is_encdec:
                rows = layout.rows(batch)
                enc = (rows.stop - rows.start) * cfg.enc_seq \
                    * cfg.d_model * 2
            assert got == count_cache_bytes(cfg, layout, batch, max_len) \
                + enc, (shape, m)
            if m.model == 1:
                assert got - enc == repro_cache_bytes(arch, shape, mesh), \
                    shape


# the smoke cells held meta against CPU: few enough positions that no MoE
# expert overflows (at most 32 tokens an MoE call, the least capacity),
# so that the CPU's routing keeps every slot, as meta assumes
SMOKE_SEQ, SMOKE_BATCH = 16, 2
COUNTS = ("flops_bf16", "flops_f32", "hbm_bytes_accessed", "peak_bytes",
          "argument_bytes", "temp_bytes", "output_bytes")


def smoke_cell(arch, shape, device, **kw):
    return D.lower_cell(arch, shape, MeshShape(1, 1),
                        cfg=TC.get_smoke_config(arch), seq=SMOKE_SEQ,
                        batch=SMOKE_BATCH, device=device, **kw)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-v2-236b"])
def test_meta_counts_equal_cpu_counts(arch, shape):
    """FLOPs, bytes accessed and the live bytes (peak, arguments,
    temporaries, outputs) counted on ``meta`` equal those counted on CPU
    tensors of the same step: the dense GQA family and the MoE + MLA
    family, at model=1; the train step in 2 microbatches."""
    kw = {"microbatches": 2} if shape == "train_4k" else {}
    meta = smoke_cell(arch, shape, "meta", **kw)
    cpu = smoke_cell(arch, shape, "cpu", **kw)
    for key in COUNTS:
        assert meta[key] == cpu[key], key
    assert meta["flops_bf16"] > 0 and meta["flops_f32"] > 0
    assert meta["peak_bytes"] > meta["argument_bytes"] > 0


@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-v2-236b"])
def test_first_microbatch_stands_for_the_rest(arch):
    """The dry run runs a train step's first microbatch and counts it
    ``microbatches`` times: its FLOPs, bytes and peak equal those of the
    whole step of 2 microbatches run on CPU tensors, and its FLOPs those
    of one microbatch of both's rows."""
    cfg = TC.get_smoke_config(arch)
    with D.fake_mesh(1, 1) as pm:
        layout = pm.layout(cfg, 2 * SMOKE_BATCH, "train")
        cell = D.build_cell(cfg, "train_4k", layout, batch=2 * SMOKE_BATCH,
                            seq=SMOKE_SEQ, device="cpu")
        counter = D.StepCounter()
        counter.adopt((list(cell.model.parameters()), cell.inputs,
                       tuple(cell.opt_state)))
        from repro_torch.train.step import make_train_step
        with counter:
            make_train_step(cfg, cell.opt_cfg, microbatches=2)(
                cell.model, cell.opt_state, cell.inputs)
    got = D.lower_cell(arch, "train_4k", MeshShape(1, 1), cfg=cfg,
                       seq=SMOKE_SEQ, batch=2 * SMOKE_BATCH, device="cpu",
                       microbatches=2)
    assert got["flops_bf16"] == counter.flops["bf16"]
    assert got["flops_f32"] == counter.flops["f32"]
    assert got["hbm_bytes_accessed"] == counter.bytes
    assert got["peak_bytes"] == counter.peak
    if arch == "llama3-8b":   # no capacity buffers: FLOPs follow the rows
        one = D.lower_cell(arch, "train_4k", MeshShape(1, 1), cfg=cfg,
                           seq=SMOKE_SEQ, batch=2 * SMOKE_BATCH,
                           microbatches=1)
        assert (one["flops_bf16"], one["flops_f32"]) \
            == (got["flops_bf16"], got["flops_f32"])


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_collective_bytes_by_hand(shape):
    """One dense smoke layer (llama3-8b, one period) on a fake (2, 2)
    mesh, 2 rows a data rank: each rank's collectives are, over its model
    group, the vocabulary-parallel embedding's f32 sum, the attention's
    and the FFN's row-parallel f32 sums of (rows, positions, d), and the
    gathered bf16 logits of the last position over the whole vocabulary;
    nothing over the data group."""
    cfg = TC.get_smoke_config("llama3-8b")
    seq = 16
    st = D.lower_cell("llama3-8b", shape, MeshShape(2, 2), cfg=cfg,
                      n_periods=1, seq=seq, batch=4)
    rows = 2
    pos = seq if shape == "prefill_32k" else 1
    dt = torch.finfo(TM.torch_dtype(cfg.dtype)).bits // 8
    sums = 3 * rows * pos * cfg.d_model * 4
    logits = rows * 1 * cfg.vocab * dt
    assert st["collective_kinds"] == {"all-reduce": sums,
                                      "all-gather": logits}
    assert st["collective_groups"] == {"model": sums + logits}
    assert st["collective_bytes"] == sums + logits


def test_collective_counter_kinds_and_groups():
    """Each c10d op the port's collectives make, its result's bytes and
    its group, on a fake (2, 4) mesh."""
    from repro_torch.dist import tensor_parallel as TPar
    with D.fake_mesh(2, 4) as pm:
        layout = TP.ShardLayout(data=2, model=4, batch_split=True,
                                split=frozenset({"vocab"}),
                                group=pm.model_group,
                                data_group=pm.data_group)
        x = torch.empty((3, 5), device="meta")
        counter = CollectiveCounter({"model": pm.model_group,
                                     "data": pm.data_group})
        with counter:
            TPar.all_reduce_sum(x, layout)
            TPar.all_gather(x, layout, dim=1)
            TPar.data_sum(x, layout)
            TPar.gather_rows(x, layout)
            with counter.repeating(3):
                TPar.all_reduce_max(x, layout)
    n = 15 * 4
    assert [(e.kind, e.nbytes, e.group) for e in counter.events] == [
        ("all-reduce", n, "model"), ("all-gather", 4 * n, "model"),
        ("all-reduce", n, "data"), ("all-gather", 2 * n, "data"),
        ("all-reduce", 3 * n, "model")]
    assert summarize(counter) == (11 * n, {"all-reduce": 5 * n,
                                           "all-gather": 6 * n})
    assert D.link_bw(D.group_ranks(MeshShape(2, 4), "model")) \
        == H100["nvlink_bw"]
    assert D.link_bw(D.group_ranks(MeshShape(16, 16), "model")) \
        == H100["net_bw"]


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_train_flops_against_step_flops(arch):
    """The smoke train cells (remat ``full``, 4 rows of 64 positions, a
    multiple of every smoke config's attention chunk) against
    ``tools/tp_train.step_flops``, the reckoning of a dense decoder.

    Dense GQA: the f32 attention FLOPs equal; the bf16 FLOPs equal
    ``step_flops``'s less what it counts and nothing runs: 8 x the
    blocks' norm weights a position (no product), each period's last
    product in the recompute (``w_down``: ``torch.utils.checkpoint``
    stops recomputing once its saved tensors are back) and, for llava,
    the patches' gradient through the projector (the patches need none).
    At 16 positions, not a multiple of the chunks, ``step_flops``
    counts the padded chunks (32 queries x 64 keys) and the dry run the
    16 x 16 that run. The other families within a band, each with its
    cause: MoE's capacity buffers (``E x capacity`` slots, where
    ``step_flops`` counts every expert on every token), SSD's scan and
    the encoder, which ``step_flops`` does not model; their bf16 FLOPs lie
    within 0.6-1.0 of its."""
    cfg = dataclasses.replace(TC.get_smoke_config(arch), remat="full")
    seq, b = 64, 4
    if cfg.frontend == "vision":
        seq = cfg.n_patches + 64
    st = D.lower_cell(arch, "train_4k", MeshShape(1, 1), cfg=cfg, seq=seq,
                      batch=b, microbatches=1)
    model = TM.abstract_params(cfg, seq + 8 if cfg.norm == "layernorm"
                               else 0)
    bf16, f32 = step_flops(model, cfg, TP.ShardLayout(), b, seq)
    t = b * seq
    if arch not in DENSE:
        assert 0.6 * bf16 <= st["flops_bf16"] <= bf16
        return
    vectors = sum(p.numel() for p in model.blocks.parameters()
                  if p.dim() == 1)
    unrun = 8 * vectors * t \
        + 2 * t * sum(blk.ffn.w_down.numel() for blk in model.blocks)
    if model.vis_proj1 is not None:
        unrun += 2 * model.vis_proj1.numel() * b * cfg.n_patches
    assert st["flops_bf16"] == bf16 - unrun
    assert st["flops_f32"] == f32
    if cfg.frontend != "vision":
        short = D.lower_cell(arch, "train_4k", MeshShape(1, 1), cfg=cfg,
                             seq=16, batch=b, microbatches=1)
        _, f32_16 = step_flops(model, cfg, TP.ShardLayout(), b, 16)
        qc, kc = cfg.attn_chunk // 2, cfg.attn_chunk
        assert short["flops_f32"] * -(-16 // qc) * qc * -(-16 // kc) * kc \
            == f32_16 * 16 * 16


def test_render_reads_both_files(tmp_path):
    """``render`` reads the port's rows (bytes a card) and the JAX
    package's (bytes of the whole mesh), a skip and a failure; a cell
    over 80 GB is marked."""
    import json
    st = D.cell_stats("llama3-8b", "decode_32k", MeshShape(2, 2))
    assert st["roofline"]["bound_s"] > 0 and st["useful_flop_frac"] > 0
    big = dict(st, arch="deepseek-v3-671b", peak_bytes=100e9)
    ref = {"arch": "gemma-7b", "shape": "train_4k", "mesh": "16x16",
           "n_chips": 256, "compile_s": 1.0, "flops": 1e15,
           "flops_model": 1e15, "hbm_bytes_accessed_model": 1e12,
           "collective_bytes_model": 1e10, "temp_bytes": 256 * 2 ** 30,
           "argument_bytes": 512 * 2 ** 30}
    rows = [st, big, ref,
            {"arch": "llama3-8b", "shape": "long_500k", "skipped": "why"},
            {"arch": "gemma-7b", "shape": "decode_32k", "mesh": "16x16",
             "error": "boom"}]
    path = tmp_path / "dryrun.json"
    path.write_text(json.dumps(rows))
    text = TR.render(str(path))
    lines = text.splitlines()
    assert sum("llama3-8b | decode_32k | 2x2" in l for l in lines) == 2
    assert "**over 80 GB**" in next(l for l in lines if "deepseek" in l)
    assert "| 2.00GiB | 1.00GiB |" in next(
        l for l in lines if "gemma-7b | train_4k" in l)
    assert "SKIP: why" in text and "| FAIL |" in text
    assert f"**{st['roofline']['dominant']}**" in text
