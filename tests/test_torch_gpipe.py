"""The GPipe forward over 4 gloo stages on the CPU
(``train.step.make_pipelined_forward``), held against the JAX package's
plain forward on the setup of its own pipeline test
(``tests/test_distribution.py::test_pipeline_parallel_forward``):
llama3-8b's smoke config with 4 periods, ``remat="none"``, a batch of 8
rows of 16 positions in 4 microbatches, weights from ``key(0)``.

Each stage holds one period (``stage_model``) with the embedding and
head. The logits of every stage (the last stage's outputs, broadcast)
are equal, bit for bit, to the port's plain forward of the whole model
(``_embed_inputs`` + ``_run_stack`` + ``_logits``), and in f32 within
1e-4 of the largest |logit| of ``repro``'s, run op by op as the port
runs its periods (``jax.disable_jit``). Without the final norm, as the
JAX pipeline computes them, the logits reach about 155, so the limit
scales with them. The tokens come
from numpy with a seed. Configs the stages would change raise: prefix
layers (the JAX stages drop them), an encoder, periods that do not
divide.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import model as RM
from repro_torch import configs as TC
from repro_torch.models import model as TM
from repro_torch.train.step import make_pipelined_forward, stage_config

from _torch_lm import f32, jax_flat, load
from _torch_multiproc import collect, parse_result, spawn

STAGES, B, S, MICRO = 4, 8, 16, 4
DTYPES = ("float32",)

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
for dtype in {dtypes!r}:
    cfg = dataclasses.replace(TC.get_smoke_config("llama3-8b"),
                              n_periods={stages}, remat="none", dtype=dtype,
                              param_dtype=dtype)
    z = np.load(root / f"{{dtype}}.npz")
    flat = {{k[2:]: z[k] for k in z.files if k.startswith("w.")}}
    stage = stage_model(params_from_jax(flat, cfg, device="cpu"), {stages},
                        pm.rank)
    pipe = make_pipelined_forward(cfg, {stages})
    logits = pipe(stage, {{"tokens": torch.from_numpy(z["tokens"])}},
                  {micro})
    np.save(root / f"{{dtype}}-rank{{pm.rank}}.npy", logits.float().numpy())
shutdown_process_mesh(pm)
emit({{"rank": pm.rank, "periods": len(stage.blocks)}})
"""


def _configs(dtype):
    kw = dict(n_periods=STAGES, remat="none", dtype=dtype, param_dtype=dtype)
    return (dataclasses.replace(RC.get_smoke_config("llama3-8b"), **kw),
            dataclasses.replace(TC.get_smoke_config("llama3-8b"), **kw))


@pytest.fixture(scope="module")
def piped(tmp_path_factory):
    root = tmp_path_factory.mktemp("gpipe")
    tokens = np.random.default_rng(0).integers(
        0, RC.get_smoke_config("llama3-8b").vocab, (B, S)).astype(np.int32)
    models = {}
    for dtype in DTYPES:
        cj, _ = _configs(dtype)
        models[dtype] = RM.init_params(jax.random.key(0), cj)
        np.savez(root / f"{dtype}.npz", tokens=tokens,
                 **{"w." + k: v for k, v in jax_flat(
                     models[dtype].params).items()})
    procs = spawn(_CHILD.format(root=str(root), stages=STAGES,
                                dtypes=DTYPES, micro=MICRO), STAGES)
    # meanwhile: repro's plain forward and the port's
    exp, plain = {}, {}
    try:
        for dtype in DTYPES:
            cj, ct = _configs(dtype)
            params = models[dtype].params
            with jax.disable_jit():
                x = RM._embed_inputs(params, cj, {"tokens": jnp.asarray(
                    tokens)})
                h, _, _ = RM._run_stack(params, cj, x, jnp.broadcast_to(
                    jnp.arange(S)[None], (B, S)))
                exp[dtype] = f32(RM._logits(params, cj, h))
            model = load(jax_flat(params), ct)
            with torch.no_grad():
                x = TM._embed_inputs(model, {"tokens": torch.from_numpy(
                    tokens)})
                h, _ = TM._run_stack(model, x, torch.arange(S)[None].expand(
                    B, S))
                plain[dtype] = f32(TM._logits(model, h))
    finally:
        outs = collect(procs, timeout=120)
    for r, (rc, out) in enumerate(outs):
        assert rc == 0, f"stage {r} failed (rc={rc}):\n{out[-4000:]}"
    res = [parse_result(out) for _, out in outs]
    got = {d: [np.load(root / f"{d}-rank{r}.npy") for r in range(STAGES)]
           for d in DTYPES}
    return res, got, exp, plain


@pytest.mark.parametrize("dtype", DTYPES)
def test_pipelined_forward_equals_repro(piped, dtype):
    res, got, exp, plain = piped
    assert [r["periods"] for r in res] == [1] * STAGES
    for r, logits in enumerate(got[dtype]):
        assert logits.shape == (B, S, exp[dtype].shape[-1])
        np.testing.assert_array_equal(logits, plain[dtype],
                                      err_msg=f"stage {r}")
    top = float(np.abs(exp[dtype]).max())
    limit = 1e-4 * top
    gap = float(np.abs(got[dtype][0] - exp[dtype]).max())
    print(f"{dtype}: largest |logit| {top:.4g}, largest difference from "
          f"repro {gap:.4g} (limit {limit:.4g})")
    assert gap <= limit


@pytest.mark.parametrize("arch,why", [
    ("deepseek-v2-236b", "prefix layers"),
    ("deepseek-v3-671b", "prefix layers"),
    ("whisper-base", "no encoder"),
    ("llama3-8b", "do not split")])
def test_configs_the_stages_would_change_raise(arch, why):
    cfg = TC.get_smoke_config(arch)
    if why == "do not split":
        cfg = dataclasses.replace(cfg, n_periods=3)
    with pytest.raises(ValueError, match=why.split()[-1]):
        stage_config(cfg, STAGES)
    with pytest.raises(ValueError):
        make_pipelined_forward(cfg, STAGES)
