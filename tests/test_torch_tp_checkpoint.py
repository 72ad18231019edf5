"""Checkpoints of a model split over gloo processes on the CPU, restored
onto other layouts (the JAX package's ``test_elastic_remesh_restore``:
saved on 8 devices, restored onto 4), and the train launcher resumed on
another mesh.

* llama3-8b's and jamba's smoke configs (bf16 parameters; AdamW with an
  f32 master copy and int8 compression, so that every leaf of the state
  is there: bf16, f32 and int32; jamba's SSD leaves cut in runs with
  ``B`` and ``C`` held whole), one train step over ``(1, 2)``, saved by
  both ranks: restored in one process, every leaf equals the ranks'
  joined slices bit for bit, and ``step`` is 1.
* The same step taken in one process and saved there: restored onto
  each rank's layout of a ``(2, 2)`` mesh (in this process: a restore
  needs no process group), its leaves are the rank's ``Cut.take`` of
  the whole, bit for bit.
* ``launch.train.main`` as users run it (llama3-8b's smoke config in
  f32), 4 steps over ``--mesh model=2`` saving every 2, its step-4
  checkpoint removed, then ``--resume auto`` over ``--mesh data=2``:
  steps 2-3 run again from the step-2 checkpoint, and every loss is
  within rtol 1e-5 of an uninterrupted one-process run's.
"""
import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.dist.plan import shard_layout
from repro_torch.launch import train as LT
from repro_torch.models import model as TM
from repro_torch.train.checkpoint import (latest_step, restore_checkpoint,
                                         save_checkpoint)
from repro_torch.train.optimizer import (AdamWConfig, abstract_opt_state,
                                        init_opt_state)
from repro_torch.train.step import make_train_step, train_rows

from _torch_multiproc import collect, parse_result, spawn
from _torch_tp_train import (LOSS_RTOL, Case, DuckMesh, batch_arrays, join,
                             rank_models, torch_batch)

ARCHS = ("llama3-8b", "jamba-v0.1-52b")
LAUNCH = ["--arch", "llama3-8b", "--smoke", "--device", "cpu", "--steps",
          "4", "--batch", "4", "--seq", "16", "--log-every", "1",
          "--save-every", "2"]

_PRELUDE = """
import dataclasses
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.launch import train as LT
from repro_torch.launch.mesh import init_process_mesh, shutdown_process_mesh
from repro_torch.models import model as TM
from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.train.optimizer import abstract_opt_state

from test_torch_tp_checkpoint import OPT, one_step, raw

torch.set_num_threads(1)
root = Path({root!r})
"""

_SAVE = _PRELUDE + """
pm = init_process_mesh({data}, {model}, "gloo", "cpu", timeout_s=60)
for arch in {archs!r}:
    cfg = get_smoke_config(arch)
    lay = pm.layout(cfg, 2, "train")
    tree, m = one_step(cfg, lay)
    save_checkpoint(str(root / arch), 1, tree, m)
    np.savez(root / f"{{arch}}-saved-rank{{pm.rank}}.npz", **raw(tree))
shutdown_process_mesh(pm)
emit({{"rank": pm.rank}})
"""

_LAUNCH = _PRELUDE + """
f32 = dict(dtype="float32", param_dtype="float32")
LT.get_smoke_config = lambda arch: dataclasses.replace(
    get_smoke_config(arch), **f32)
run = LT.main({argv!r})
emit({{"start": run.start, "losses": run.losses}})
"""


OPT = AdamWConfig(lr=1e-3, master_weights=True, compress_grads=True)


def one_step(cfg, layout):
    """A model of ``cfg`` (``layout``'s slice) drawn from seed 0 after one
    train step on a batch of 2 rows: (the tree {"params", "opt"}, the
    model)."""
    model = TM.init_sharded(torch.Generator().manual_seed(0), cfg, layout,
                            "cpu")
    params = dict(model.named_parameters())
    state = init_opt_state(params, OPT)
    batch = torch_batch(batch_arrays(cfg, 24), train_rows(layout, 2))
    _, state, _ = make_train_step(cfg, OPT)(model, state, batch)
    return {"params": params, "opt": state}, model


def raw(tree) -> dict:
    """Each tensor leaf's bits as a numpy array (bf16 as int16), keyed
    ``<prefix>.<name>`` as ``_torch_tp_train.join`` reads them."""
    out = {"step": tree["opt"].step.numpy()}
    for prefix, leaves in (("param", tree["params"]),
                           ("mu", tree["opt"].mu), ("nu", tree["opt"].nu),
                           ("master", tree["opt"].master),
                           ("err", tree["opt"].error)):
        for k, t in leaves.items():
            t = t.detach()
            out[f"{prefix}.{k}"] = (t.view(torch.int16) if t.dtype ==
                                    torch.bfloat16 else t).numpy()
    return out


PREFIXES = ("param", "mu", "nu", "master", "err")


def _start(code, n, **fmt):
    return spawn(code.format(**fmt), n, init_timeout=60)


def _finish(procs, timeout=180):
    outs = collect(procs, timeout=timeout)
    for r, (rc, out) in enumerate(outs):
        assert rc == 0, f"rank {r} failed (rc={rc}):\n{out[-4000:]}"
    return [parse_result(out) for _, out in outs]


def _f32_smoke(arch):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32",
                               param_dtype="float32")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_ckpt")
    ck_split, ck_one = root / "launch-split", root / "launch-one"
    split_argv = LAUNCH + ["--mesh", "model=2", "--dist-backend", "gloo",
                           "--ckpt-dir", str(ck_split)]
    first = {"save": _start(_SAVE, 2, root=str(root), data=1, model=2,
                            archs=ARCHS),
             "launch": _start(_LAUNCH, 2, root=str(root), argv=split_argv)}
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))  # beside the ranks
    try:
        # meanwhile: the same step in one process, saved there, and the
        # launcher's uninterrupted run
        whole = {}
        for arch in ARCHS:
            tree, model = one_step(get_smoke_config(arch), None)
            save_checkpoint(str(root / f"{arch}-one"), 1, tree, model)
            whole[arch] = raw(tree)
        smoke = LT.get_smoke_config
        LT.get_smoke_config = _f32_smoke
        try:
            one = LT.main(LAUNCH + ["--ckpt-dir", str(ck_one)])
        finally:
            LT.get_smoke_config = smoke
    finally:
        torch.set_num_threads(threads)
        got = {k: _finish(v) for k, v in first.items()}
    steps = sorted(os.listdir(ck_split))
    shutil.rmtree(ck_split / "step_00000004")
    resume_argv = LAUNCH + ["--mesh", "data=2", "--dist-backend", "gloo",
                            "--ckpt-dir", str(ck_split), "--resume", "auto"]
    resume = _start(_LAUNCH, 2, root=str(root), argv=resume_argv)
    try:
        # meanwhile: the one-process checkpoints restored onto each rank's
        # layout of a (2, 2) mesh (a restore needs no process group)
        restored = {arch: [raw(_restore_onto(root, arch, lay)) for lay in
                           _layouts(arch, (2, 2))] for arch in ARCHS}
    finally:
        got["resume"] = _finish(resume)
    return dict(root=root, whole=whole, one=one, steps=steps,
                restored=restored, latest=latest_step(str(ck_split)), **got)


def _layouts(arch, mesh):
    cfg = get_smoke_config(arch)
    return [shard_layout(cfg, DuckMesh(*mesh), r, 2, "train")
            for r in range(mesh[0] * mesh[1])]


def _restore_onto(root, arch, layout):
    """The one-process checkpoint of ``arch`` (under ``root``) restored
    onto ``layout``'s slice."""
    m = TM.abstract_params(get_smoke_config(arch), layout=layout)
    params = dict(m.named_parameters())
    return restore_checkpoint(str(root / f"{arch}-one"), 1, {
        "params": params, "opt": abstract_opt_state(params, OPT)},
        layout=layout)


def _target(arch):
    cfg = get_smoke_config(arch)
    m = TM.abstract_params(cfg)
    params = dict(m.named_parameters())
    return {"params": params, "opt": abstract_opt_state(params, OPT)}


@pytest.mark.parametrize("arch", ARCHS)
def test_split_checkpoint_restores_in_one_process(runs, arch):
    root = runs["root"]
    ranks = [np.load(root / f"{arch}-saved-rank{r}.npz") for r in range(2)]
    models = rank_models(Case(arch, arch), (1, 2))
    got = raw(restore_checkpoint(str(root / arch), 1, _target(arch)))
    assert int(got["step"]) == 1 == int(ranks[0]["step"])
    for prefix in PREFIXES:
        for k, v in join(ranks, models, (1, 2), prefix).items():
            key = f"{prefix}.{k}"
            assert got[key].dtype == v.dtype, key
            np.testing.assert_array_equal(got[key], v, err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_process_checkpoint_restores_onto_2x2(runs, arch):
    whole = runs["whole"][arch]
    models = rank_models(Case(arch, arch), (2, 2))
    for r in range(4):
        z = runs["restored"][arch][r]
        assert int(z["step"]) == 1
        for key in whole:
            if key == "step":
                continue
            name = key.split(".", 1)[1]
            cut = models[r].cut_of(name)
            want = whole[key] if cut is None else cut.take(whole[key])
            assert z[key].dtype == want.dtype, key
            np.testing.assert_array_equal(z[key], want,
                                          err_msg=f"rank {r} {key}")


def test_one_process_checkpoint_keeps_its_format(runs):
    """A one-process checkpoint is one file a leaf, in the JAX package's
    manifest format, bf16 as its uint16 view, each parameter's logical
    axes beside it."""
    arch = ARCHS[0]
    path = runs["root"] / f"{arch}-one" / "step_00000001" / "manifest.json"
    leaves = json.loads(path.read_text())["leaves"]
    embed = leaves["params/embed"]
    assert embed["dtype"] == "bfloat16" and embed["axes"] == ["vocab",
                                                              "embed"]
    assert embed["file"] == "params_embed.npy" and "pieces" not in embed
    assert leaves["opt/step"]["dtype"] == "int32"
    assert "axes" not in leaves["opt/step"]


def test_launcher_resumes_on_another_mesh(runs):
    one = runs["one"]
    assert runs["steps"] == ["step_00000002", "step_00000004"]
    assert runs["latest"] == 4
    first = runs["launch"]
    again = runs["resume"]
    assert all(res["start"] == 0 for res in first)
    assert all(res["start"] == 2 for res in again)
    for res in first:
        got = {int(k): v for k, v in res["losses"].items()}
        assert sorted(got) == [0, 1, 2, 3]
        for i, loss in got.items():
            np.testing.assert_allclose(loss, one.losses[i], rtol=LOSS_RTOL)
    for res in again:
        got = {int(k): v for k, v in res["losses"].items()}
        assert sorted(got) == [2, 3]
        for i, loss in got.items():
            np.testing.assert_allclose(loss, one.losses[i], rtol=LOSS_RTOL,
                                       err_msg=f"step {i}")
