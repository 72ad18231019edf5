"""The gradient of the GPipe forward over 4 gloo stages on the CPU
(``train.step.make_pipelined_forward`` under autograd), held against
``jax.grad`` of the JAX package's.

Each case takes a smoke config with 4 periods in f32, ``remat="none"``
in the reference, a batch of 8 rows of 16 positions in 4 microbatches,
weights from ``key(0)`` (the setup of ``repro``'s own pipeline test),
and the loss ``sum(logits * ct)`` with a fixed cotangent ``ct``; tokens
and ``ct`` come from numpy with a seed. Every
stage takes that loss of its logits and runs its backward. Its
gradients, each stage's periods joined with the whole leaves of stage 0,
are held within ``GRAD_TOL`` of each leaf's largest |value| against:

* llama3-8b: ``jax.grad`` through the JAX package's own pipeline,
  ``shard_map``ped over an Auto-axis mesh of 4 forced host devices, as
  ``tests/test_distribution.py::test_pipeline_parallel_forward`` runs it
  (in a subprocess, while the stages run);
* gemma-7b (its embedding tied to the head), mamba2-780m (SSD) and
  jamba-v0.1-52b (SSD, attention and MoE): the sum over the microbatches
  of ``jax.grad`` of the JAX package's plain forward (``_embed_inputs`` +
  ``_run_stack`` + ``_logits``) of each, which is the function the
  pipeline computes (MoE routes each microbatch on its own, in both).

In every case the embedding, head and final norm are bit-identical on
every stage, ``remat="full"`` gives the same gradients bit for bit,
two backward passes of one forward (``"full"``) leave exactly twice the
gradient, and the logits under ``torch.no_grad()`` are those of the
forward under autograd (and, ``tests/test_torch_gpipe.py``, the port's
plain forward).
"""
import dataclasses
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import model as RM
from repro_torch import configs as TC
from repro_torch.tools.tp_train import microbatch_logits

from _multiproc import _env
from _torch_lm import jax_flat, load, normwise, to_flat
from _torch_tp import jax_params
from _torch_multiproc import collect, parse_result, spawn

STAGES, B, S, MICRO = 4, 8, 16, 4
ARCHS = ("llama3-8b", "gemma-7b", "mamba2-780m", "jamba-v0.1-52b")
THROUGH_JAX_PIPELINE = "llama3-8b"
# against the port's own backward of the same microbatches on one process
# in the pipeline's order of sums: each leaf within this share of its
# largest |value| (measured 0; 5.3e-7 against each microbatch's backward
# summed first to last)
GRAD_TOL = 1e-5
# against repro, normwise over every leaf: PERF.md's f32 training limit.
# With 4 periods, no final norm (logits near 155) and a random cotangent
# these gradients are ill-conditioned: repro's compiled and op-by-op
# gradients differ from each other by 9e-6-2.2e-4 normwise (per leaf up to
# 3e-4 of its largest |value|), and jamba's by 5.6e-3 (8.1e-3, its SSD
# dt_bias), more than a limit of 1e-5 of each leaf's largest leaves room
# for; the port's unsplit backward measured 6.7e-5-7.2e-4 (jamba 1.3e-2)
REPRO_NORM = {"jamba-v0.1-52b": 3e-2}
REPRO_NORM_DEFAULT = 1e-3
WHOLE = ("embed", "lm_head", "final_norm.w")

_CHILD = """
import dataclasses
from pathlib import Path

import numpy as np
import torch

from repro_torch import configs as TC
from repro_torch.launch.mesh import init_process_mesh, shutdown_process_mesh
from repro_torch.models.convert import params_from_jax
from repro_torch.train.step import make_pipelined_forward, stage_model

torch.set_num_threads(1)
root = Path({root!r})
pm = init_process_mesh(1, {stages}, "gloo", "cpu", timeout_s=60)


def grads(stage):
    return {{k: (p.grad if p.grad is not None else torch.zeros_like(p))
             .clone().numpy() for k, p in stage.named_parameters()}}


for arch in {archs!r}:
    z = np.load(root / f"{{arch}}.npz")
    flat = {{k[2:]: z[k] for k in z.files if k.startswith("w.")}}
    batch = {{"tokens": torch.from_numpy(z["tokens"])}}
    ct = torch.from_numpy(z["ct"])
    out = {{}}
    for remat in ("none", "full"):
        cfg = dataclasses.replace(
            TC.get_smoke_config(arch), n_periods={stages}, remat=remat,
            dtype="float32", param_dtype="float32")
        stage = stage_model(params_from_jax(flat, cfg, device="cpu"),
                            {stages}, pm.rank)
        stage.requires_grad_(True)
        pipe = make_pipelined_forward(cfg, {stages})
        logits = pipe(stage, batch, {micro})
        loss = (logits * ct).sum()
        loss.backward(retain_graph=remat == "full")
        out[f"{{remat}}.grad"] = grads(stage)
        out[f"{{remat}}.logits"] = logits.detach().numpy()
        if remat == "full":
            loss.backward()
            out["full.twice"] = grads(stage)
        else:
            with torch.no_grad():
                out["none.no_grad"] = pipe(stage, batch, {micro}).numpy()
    np.savez(root / f"{{arch}}-rank{{pm.rank}}.npz",
             **{{f"{{k}}:{{n}}": v for k, tree in out.items()
                 for n, v in (tree.items() if isinstance(tree, dict)
                              else [("", tree)])}})
shutdown_process_mesh(pm)
emit({{"rank": pm.rank}})
"""

# jax.grad through the JAX package's shard_mapped pipeline, on 4 forced
# host devices and an Auto-axis mesh
_JAX_PIPELINE = """
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
try:
    from jax import shard_map          # jax >= 0.5
    sm_kw = {{"check_vma": False}}
except ImportError:
    from jax.experimental.shard_map import shard_map
    sm_kw = {{"check_rep": False}}

from repro.configs import get_smoke_config
from repro.models.model import init_params
from repro.train.step import make_pipelined_forward

cfg = dataclasses.replace(get_smoke_config({arch!r}), n_periods={stages},
                          remat="none", dtype="float32",
                          param_dtype="float32")
params = init_params(jax.random.key(0), cfg).params
z = np.load({path!r})
batch = {{"tokens": jnp.asarray(z["tokens"])}}
ct = jnp.asarray(z["ct"])
mesh = Mesh(np.array(jax.devices()[:{stages}]), ("stage",))
specs = ({{k: jax.tree.map(lambda _: P("stage"), v) if k == "pattern"
          else P() for k, v in params.items()}}, {{"tokens": P()}})
f = shard_map(partial(make_pipelined_forward(cfg, n_stages={stages}),
                      n_microbatches={micro}), mesh=mesh, in_specs=specs,
              out_specs=P(), **sm_kw)
g = jax.jit(jax.grad(lambda p: jnp.sum(f(p, batch) * ct)))(params)
flat = {{}}
for k, v in g.items():
    if k == "pattern":
        flat.update({{f"pattern.{{kk}}": np.asarray(vv, np.float32)
                     for kk, vv in v.items()}})
    else:
        flat[k] = np.asarray(v, np.float32)
np.savez({out!r}, **flat)
print("JAX_PIPELINE_GRAD_OK")
"""


def _configs(arch, package=RC):
    return dataclasses.replace(
        package.get_smoke_config(arch), n_periods=STAGES, remat="none",
        dtype="float32", param_dtype="float32")


def _plain_grads(cj, params, tokens, ct):
    """The sum over the microbatches of ``jax.grad`` of ``sum(logits *
    ct)`` of the JAX package's plain forward of each."""
    n = B // MICRO
    pos = jnp.broadcast_to(jnp.arange(S)[None], (n, S))

    def loss(p, toks, c):
        x = RM._embed_inputs(p, cj, {"tokens": toks})
        h, _, _ = RM._run_stack(p, cj, x, pos)
        return jnp.sum(RM._logits(p, cj, h) * c)

    grad = jax.jit(jax.grad(loss))
    total = None
    for i in range(MICRO):
        g = jax_flat(grad(params, jnp.asarray(tokens[i * n:(i + 1) * n]),
                          jnp.asarray(ct[i * n:(i + 1) * n])))
        total = g if total is None else {k: total[k] + v
                                         for k, v in g.items()}
    return total


def _port_grads(cfg, flat, tokens, ct):
    """The port's unsplit backward of the same microbatches on one
    process, in the pipeline's order of sums (``microbatch_logits``),
    under the JAX package's flat names."""
    model = load(flat, cfg)
    model.requires_grad_(True)
    (microbatch_logits(model, torch.from_numpy(tokens), MICRO)
     * torch.from_numpy(ct)).sum().backward()
    return to_flat(model, {k: p.grad if p.grad is not None
                           else torch.zeros_like(p)
                           for k, p in model.named_parameters()})


def _rank_trees(path):
    """``{key: {parameter: array}}`` of one stage's saved arrays."""
    z = np.load(path)
    out = {}
    for name in z.files:
        key, _, param = name.partition(":")
        out.setdefault(key, {})[param] = z[name]
    return out


def _joined(cfg, ranks, key):
    """The stages' ``key`` gradients as one model's, under the JAX
    package's flat names: each stage's periods in place, the whole leaves
    of stage 0."""
    per = cfg.n_periods // STAGES * len(cfg.pattern)
    whole = {}
    for r, tree in enumerate(ranks):
        for k, v in tree[key].items():
            if k.startswith("blocks."):
                _, i, rest = k.split(".", 2)
                whole[f"blocks.{int(i) + r * per}.{rest}"] = v
            elif r == 0:
                whole[k] = v
    return to_flat(types.SimpleNamespace(cfg=cfg),
                   {k: torch.from_numpy(v) for k, v in whole.items()})


@pytest.fixture(scope="module")
def piped(tmp_path_factory):
    root = tmp_path_factory.mktemp("gpipe_grad")
    ref_path = root / "jax-pipeline.npz"
    data = {}
    for i, arch in enumerate(ARCHS):
        rng = np.random.default_rng(i)
        vocab = _configs(arch).vocab
        data[arch] = (rng.integers(0, vocab, (B, S)).astype(np.int32),
                      rng.normal(0, 1, (B, S, vocab)).astype(np.float32))
    np.savez(root / "ref-batch.npz", tokens=data[THROUGH_JAX_PIPELINE][0],
             ct=data[THROUGH_JAX_PIPELINE][1])
    # repro's pipeline draws its own weights from key(0)
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX_PIPELINE.format(
            arch=THROUGH_JAX_PIPELINE, stages=STAGES, micro=MICRO,
            path=str(root / "ref-batch.npz"), out=str(ref_path)))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env(STAGES))
    flats = {}
    for arch in ARCHS:
        flats[arch] = jax_flat(RM.init_params(jax.random.key(0),
                                              _configs(arch)).params)
        np.savez(root / f"{arch}.npz", tokens=data[arch][0],
                 ct=data[arch][1],
                 **{"w." + k: v for k, v in flats[arch].items()})
    procs = spawn(_CHILD.format(root=str(root), stages=STAGES, archs=ARCHS,
                                micro=MICRO), STAGES)
    # meanwhile: the plain references, repro's and the port's
    exp, own = {}, {}
    try:
        for arch in ARCHS:
            own[arch] = _port_grads(_configs(arch, TC), flats[arch],
                                    *data[arch])
            if arch != THROUGH_JAX_PIPELINE:
                exp[arch] = _plain_grads(_configs(arch),
                                         jax_params(flats[arch]),
                                         *data[arch])
    finally:
        *outs, (rc, log) = collect(procs + [ref], timeout=240)
    for r, (rc_r, out) in enumerate(outs):
        assert rc_r == 0, f"stage {r} failed (rc={rc_r}):\n{out[-4000:]}"
        parse_result(out)
    assert rc == 0 and "JAX_PIPELINE_GRAD_OK" in log, log[-4000:]
    z = np.load(ref_path)
    exp[THROUGH_JAX_PIPELINE] = {k: z[k] for k in z.files}
    got = {arch: [_rank_trees(root / f"{arch}-rank{r}.npz")
                  for r in range(STAGES)] for arch in ARCHS}
    return got, exp, own


def _gaps(got, exp):
    """Each leaf's largest difference over its largest |value|."""
    return {k: float(np.abs(got[k] - e).max()) / (float(np.abs(e).max())
                                                   or 1.0)
            for k, e in exp.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_pipeline_gradients_equal_the_unsplit_backward(piped, arch):
    got, _, own = piped
    joined = _joined(_configs(arch), got[arch], "none.grad")
    assert set(joined) == set(own[arch])
    gaps = _gaps(joined, own[arch])
    k = max(gaps, key=gaps.get)
    print(f"{arch}: against the port's unsplit backward, largest gap "
          f"{gaps[k]:.3g} of the leaf's largest |value| ({k})")
    for k, e in own[arch].items():
        np.testing.assert_allclose(
            joined[k], e, rtol=0, atol=GRAD_TOL * float(np.abs(e).max()),
            err_msg=f"{arch} gradient of {k}")


@pytest.mark.parametrize("arch", ARCHS)
def test_pipeline_gradients_equal_repro(piped, arch):
    got, exp, _ = piped
    joined = _joined(_configs(arch), got[arch], "none.grad")
    assert set(joined) == set(exp[arch])
    gaps = _gaps(joined, exp[arch])
    k = max(gaps, key=gaps.get)
    total = normwise(joined, exp[arch])
    limit = REPRO_NORM.get(arch, REPRO_NORM_DEFAULT)
    print(f"{arch}: against repro{' (its pipeline)' if arch == THROUGH_JAX_PIPELINE else ''} "
          f"normwise {total:.3g} (limit {limit:g}), largest gap "
          f"{gaps[k]:.3g} of the leaf's largest |value| ({k})")
    assert total <= limit, (arch, total)


@pytest.mark.parametrize("arch", ARCHS)
def test_whole_leaves_are_bit_identical_on_every_stage(piped, arch):
    got = piped[0]
    for key in ("none.grad", "full.grad"):
        for name in WHOLE:
            if name not in got[arch][0][key]:
                continue
            for r in range(1, STAGES):
                np.testing.assert_array_equal(
                    got[arch][r][key][name], got[arch][0][key][name],
                    err_msg=f"{arch} {key} {name}: stage {r}")
    # the head's gradient is not empty, the final norm's is (the pipeline
    # takes its logits without it, as the JAX package's does)
    head = "embed" if _configs(arch).tie_embeddings else "lm_head"
    assert np.any(got[arch][0]["none.grad"][head])
    assert not np.any(got[arch][0]["none.grad"]["final_norm.w"])


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_full_gives_the_same_gradients_bit_for_bit(piped, arch):
    got = piped[0]
    for r, tree in enumerate(got[arch]):
        for k, g in tree["none.grad"].items():
            np.testing.assert_array_equal(tree["full.grad"][k], g,
                                          err_msg=f"{arch} stage {r} {k}")


@pytest.mark.parametrize("arch", ARCHS)
def test_two_backward_passes_leave_twice_the_gradient(piped, arch):
    got = piped[0]
    for r, tree in enumerate(got[arch]):
        for k, g in tree["full.grad"].items():
            np.testing.assert_array_equal(tree["full.twice"][k], 2 * g,
                                          err_msg=f"{arch} stage {r} {k}")


@pytest.mark.parametrize("arch", ARCHS)
def test_no_grad_forward_equals_the_forward_under_autograd(piped, arch):
    got = piped[0]
    first = got[arch][0]["none.logits"][""]
    assert first.shape == (B, S, _configs(arch).vocab)
    assert np.all(np.isfinite(first))
    for r, tree in enumerate(got[arch]):
        for key in ("none.no_grad", "full.logits"):
            np.testing.assert_array_equal(tree[key][""], first,
                                          err_msg=f"{arch} stage {r} {key}")
