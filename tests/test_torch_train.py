"""The port's training path (``repro_torch.models.model.forward_train``,
``repro_torch.train.step``, ``repro_torch.launch.train``) against the
JAX package's, on the CPU, at smoke size.

Weights come from ``repro``'s ``init_params(jax.random.key(1), cfg)``
through ``params_from_jax``; batches (tokens, labels with -100 masks,
bf16 patches or frames) from numpy with a seed. Tolerances, from the
measured gaps:

* ``forward_train`` in f32 (``dtype`` and ``param_dtype``), each of the
  ten smoke configs (``_torch_lm.check_f32``; the MoE, MLA, SSD and
  encoder-decoder archs in ``test_torch_train_families.py``): the loss
  within ``rtol=1e-5``; every gradient leaf within ``GRAD_F32`` x its
  largest |value| (measured up to 5.0e-4, deepseek-v3's MTP head and
  MoE); jamba and whisper within ``GRAD_F32_LOOSE`` (measured 1.5e-3
  and 8.3e-4: their forwards already differ most from the reference,
  ``test_torch_ssm.py`` and ``test_torch_encdec.py``);
* ``remat="none"`` against ``"full"``, and the attention block's
  autograd-safe form against the in-place one: equal, bit for bit;
* one ``make_train_step`` step in f32 (llama3 smoke, AdamW's defaults
  but ``lr=1e-3``), ``microbatches`` 1 and 2: the loss within
  ``rtol=1e-5``, the grad norm within ``rtol=1e-4``, the parameters
  within ``atol=STEP_ATOL`` (AdamW's first step moves each weight by
  about ``lr`` x the sign of its gradient, so a gradient within rounding
  of zero moves it by up to 2 x lr the other way: measured 0 of 426,624
  weights beyond 1e-6); the moments within 2e-3 of each leaf's largest.
"""
import dataclasses
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.train import optimizer as RO
from repro.train import step as RS
from repro_torch import configs as TC
from repro_torch.launch import train as LT
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.train import optimizer as TO
from repro_torch.train import step as TS

from _torch_lm import (both_models, check_f32, jax_flat, load,
                       port_loss_and_grads, to_flat, train_batches)

F32 = dict(dtype="float32", param_dtype="float32")
STEP_ATOL = 2e-3


DENSE = ["llama3-8b", "llava-next-mistral-7b", "command-r-plus-104b",
         "gemma-7b", "nemotron-4-15b"]


@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_every_gradient_match_repro_in_f32(arch):
    """The dense and VLM archs (the others:
    ``test_torch_train_families.py``)."""
    check_f32(arch)


@pytest.mark.parametrize("arch", TC.ARCH_IDS)
def test_remat_gives_the_same_gradients_bit_for_bit(arch):
    """``remat="full"`` (the default: each prefix layer and each period
    checkpointed) against ``"none"``; ``"dots"`` runs as ``"full"``, as
    the JAX package's ``jax.checkpoint`` without a policy does."""
    ct = TC.get_smoke_config(arch)
    flat = to_flat(TM.init_params(torch.Generator().manual_seed(0), ct,
                                  device="cpu"))
    _, bt = train_batches(ct)
    out = {}
    for remat in ("none", "full", "dots"):
        tm = load(flat, dataclasses.replace(ct, remat=remat))
        out[remat] = port_loss_and_grads(tm, bt)
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        for k, g in out["none"][2].items():
            np.testing.assert_array_equal(out[remat][2][k], g,
                                          err_msg=f"{arch} {remat} {k}")
    n_pre, n_pat = len(ct.prefix_layers), len(ct.pattern)
    groups = TM.remat_groups(tm)
    assert [len(g) for g in groups] == [1] * n_pre + [n_pat] * ct.n_periods


@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_autograd_attention_block_equals_the_in_place_one(softcap):
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 16, 4, 8), generator=g)
    k = torch.randn((2, 24, 2, 8), generator=g)
    v = torch.randn((2, 24, 2, 8), generator=g)
    mask = torch.rand((2, 16, 24), generator=g) < 0.7
    mask[0, 3] = False  # a query row that sees no key
    with torch.no_grad():
        served = TA._attend_block(q, k, v, mask, softcap)
    qg = q.clone().requires_grad_(True)
    trained = TA._attend_block(qg, k, v, mask, softcap)
    for a, b in zip(trained, served):
        assert torch.equal(a.detach(), b)
    sum(t.sum() for t in trained).backward()
    assert torch.isfinite(qg.grad).all()


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_repro(microbatches):
    cj, ct, m, tm = both_models("llama3-8b", **F32)
    bj, bt = train_batches(cj)
    ocfg = dict(lr=1e-3)
    jstep = jax.jit(RS.make_train_step(cj, RO.AdamWConfig(**ocfg),
                                       microbatches=microbatches))
    pj, sj, mj = jstep(m.params, RO.init_opt_state(m.params,
                                                   RO.AdamWConfig(**ocfg)),
                       bj)
    params = dict(tm.named_parameters())
    tstep = TS.make_train_step(ct, TO.AdamWConfig(**ocfg),
                               microbatches=microbatches)
    tm, st, mt = tstep(tm, TO.init_opt_state(params, TO.AdamWConfig(**ocfg)),
                       bt)
    assert int(st.step) == int(sj.step) == 1
    assert set(mt) == set(mj)
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(mt["grad_norm"]),
                               float(mj["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(float(mt["lr"]), float(mj["lr"]), rtol=1e-6)
    got, exp = to_flat(tm), jax_flat(pj)
    off = sum(int((np.abs(got[k] - exp[k]) > 1e-6).sum()) for k in exp)
    n = sum(v.size for v in exp.values())
    print(f"microbatches={microbatches}: {off} of {n} weights differ by "
          f"more than 1e-6")
    for k in exp:
        np.testing.assert_allclose(got[k], exp[k], rtol=0, atol=STEP_ATOL,
                                   err_msg=k)
    for name, a, b in (("mu", st.mu, sj.mu), ("nu", st.nu, sj.nu)):
        fa = to_flat(tm, a)
        fb = jax_flat(b)
        for k in fb:
            scale = float(np.abs(fb[k]).max())
            np.testing.assert_allclose(fa[k], fb[k], rtol=0,
                                       atol=2e-3 * scale + 1e-12,
                                       err_msg=f"{name} {k}")


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def test_launcher_trains_checkpoints_and_resumes_on_the_cpu(tmp_path, capsys):
    argv = ["--arch", "llama3-8b", "--smoke", "--steps", "3", "--batch", "4",
            "--seq", "32", "--microbatches", "2", "--save-every", "2",
            "--log-every", "1", "--device", "cpu", "--ckpt-dir",
            str(tmp_path), "--jpeg-stream", "1"]
    first = LT.main(argv)
    out = capsys.readouterr().out
    assert "decode" in out.lower() and "stragglers=0" in out
    assert first.start == 0 and sorted(first.losses) == [0, 1, 2]
    assert all(np.isfinite(v) for v in first.losses.values())
    assert sorted(os.listdir(tmp_path)) == ["step_00000002",
                                            "step_00000003"]
    # the job dies after the save at step 2; --resume auto picks it up
    shutil.rmtree(tmp_path / "step_00000003")
    again = LT.main(argv[:-2] + ["--resume", "auto"])
    assert "resumed from step 2" in capsys.readouterr().out
    assert again.start == 2 and sorted(again.losses) == [2]
    assert again.losses[2] == first.losses[2]
    for a, b in zip(again.model.parameters(), first.model.parameters()):
        assert torch.equal(a, b)
    assert int(again.opt_state.step) == 3


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "whisper-base",
                                  "deepseek-v3-671b"])
def test_launcher_feeds_every_family(arch, capsys):
    """The VLM gets zero patches, the encoder-decoder zero frames, as the
    JAX launcher feeds them; deepseek-v3 adds its MTP loss."""
    run = LT.main(["--arch", arch, "--smoke", "--steps", "2", "--batch", "2",
                   "--seq", "16", "--device", "cpu"])
    assert sorted(run.losses) == [0, 1]
    assert all(np.isfinite(v) for v in run.losses.values())
    assert f"arch={run.model.cfg.name}" in capsys.readouterr().out


def test_launcher_scales_to_100m():
    cfg = LT.scale_to_100m(TC.get_config("llama3-8b"))
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab, cfg.n_periods, cfg.attn_chunk) == (
        512, 8, 8, 64, 2048, 32000, 8, 512)
    from repro.launch import train as RL
    from repro import configs as RC
    ref = RL.scale_to_100m(RC.get_config("llama3-8b"))
    assert cfg.param_count() == ref.param_count()


def test_launcher_needs_a_card_without_device_cpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    built = []
    monkeypatch.setattr(LT, "init_sharded", lambda *a, **k: built.append(1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LT.main(["--arch", "llama3-8b", "--smoke", "--steps", "1"])
    assert not built
