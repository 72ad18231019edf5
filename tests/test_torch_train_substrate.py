"""The port's training substrate against the JAX package's, on the CPU:
AdamW (``repro_torch.train.optimizer``), the LR schedules, checkpoints,
the token data and the fault monitors; and the reference's own substrate
tests (``tests/test_train_substrate.py``) mirrored on the port.

Tolerances against ``repro`` on the same numpy arrays, from the measured
gaps over 4 steps: the schedules equal, bit for bit; ``_compress_int8``
equal, bit for bit (ties round half to even on both); parameters and the
master copy within ``rtol=1e-6`` (measured 1.04e-7); f32 moments within
``rtol=1e-4`` of each value plus 1e-6 of the leaf's largest (gradients
spanning 7 decades; measured 3.9e-5); bf16 moments within one bf16
step of the value, ``rtol=2**-7`` (a last-bit difference before the
rounding flips it); the bf16 residual likewise, plus ``2**-16`` of the
leaf's largest (where the dequantised gradient cancels the input, a
last-bit difference of the dequantised value is all that is left:
measured 2.4e-7 against 0); the grad norm within
``rtol=1e-6`` (measured 1.6e-7, the two libraries' sums in another
order).
"""
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import tokens as RT
from repro.train import optimizer as RO
from repro.train import schedule as RSch
from repro_torch.configs import get_smoke_config
from repro_torch.data.tokens import Prefetcher, SyntheticTokens
from repro_torch.dist.fault import StepTimer, StragglerMonitor
from repro_torch.models.model import init_params
from repro_torch.train import optimizer as TO
from repro_torch.train import schedule as TSch
from repro_torch.train.checkpoint import (latest_step, restore_checkpoint,
                                          save_checkpoint)
from repro_torch.train.optimizer import (AdamWConfig, abstract_opt_state,
                                         adamw_update, global_norm,
                                         init_opt_state)
from repro_torch.train.step import make_eval_step, make_train_step

BF16_STEP = 2.0 ** -7
SHAPES = {"w": (37, 19), "b": (19,), "e": (5, 3, 7)}


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def trees(dtype: str, seed=0, steps=4):
    """(JAX params, port params, JAX grads a step, port grads a step) from
    numpy: weights N(0, 1), gradients N(0, 1) scaled by 10**U(-6, 1)."""
    rng = np.random.default_rng(seed)
    p = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in SHAPES.items()}
    gs = [{k: (rng.normal(0, 1, s) * 10 ** rng.uniform(-6, 1, s)).astype(
        np.float32) for k, s in SHAPES.items()} for _ in range(steps)]
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = getattr(torch, dtype)
    return ({k: jnp.asarray(v, jd) for k, v in p.items()},
            {k: torch.from_numpy(v).to(td) for k, v in p.items()},
            [{k: jnp.asarray(v, jd) for k, v in g.items()} for g in gs],
            [{k: torch.from_numpy(v).to(td) for k, v in g.items()}
             for g in gs])


def quad_params():
    return {"w": torch.tensor([2.0, -3.0]), "b": torch.tensor([0.5])}


def quad_grads(p):
    return {k: 2 * v for k, v in p.items()}


def quad_loss(p):
    return float(sum(torch.sum(v ** 2) for v in p.values()))


# ---------------------------------------------------------------------------
# Against repro on the same arrays
# ---------------------------------------------------------------------------

OPT_CASES = {
    "defaults": dict(),
    "bf16-moments": dict(moment_dtype="bfloat16"),
    "master-weights": dict(master_weights=True),
    "compress-grads": dict(compress_grads=True),
    "clipping": dict(clip_norm=0.5),
    "no-clip-no-decay": dict(clip_norm=1e9, weight_decay=0.0),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(OPT_CASES))
def test_adamw_update_matches_repro(case, dtype):
    kw = OPT_CASES[case]
    pj, pt, gj, gt = trees(dtype)
    cj, ct = RO.AdamWConfig(**kw), AdamWConfig(**kw)
    sj, st = RO.init_opt_state(pj, cj), init_opt_state(pt, ct)
    upd = jax.jit(lambda p, g, s, l: RO.adamw_update(p, g, s, cj, l))
    for i in range(len(gj)):
        lj = RSch.warmup_cosine(sj.step, warmup=2, total=10)
        lt = TSch.warmup_cosine(st.step, warmup=2, total=10)
        pj, sj, mj = upd(pj, gj[i], sj, lj)
        pt, st, mt = adamw_update(pt, gt[i], st, ct, lt)
        assert int(st.step) == int(sj.step) == i + 1
        assert f32(mt["lr"]) == f32(mj["lr"])
        np.testing.assert_allclose(f32(mt["grad_norm"]), f32(mj["grad_norm"]),
                                   rtol=1e-6)
        pairs = [("params", pt, pj, 1e-6), ("mu", st.mu, sj.mu, None),
                 ("nu", st.nu, sj.nu, None)]
        if ct.master_weights:
            pairs.append(("master", st.master, sj.master, 1e-6))
        if ct.compress_grads:
            pairs.append(("error", st.error, sj.error, "residual"))
        for name, a, b, rtol in pairs:
            for k in b:
                got, exp = f32(a[k]), f32(b[k])
                assert a[k].dtype == getattr(torch, str(b[k].dtype))
                if rtol == "residual":
                    tol = dict(rtol=BF16_STEP,
                               atol=2.0 ** -16 * float(np.abs(exp).max()))
                elif rtol is None:  # the moments
                    bf16 = a[k].dtype == torch.bfloat16
                    tol = dict(rtol=BF16_STEP, atol=0) if bf16 else dict(
                        rtol=1e-4, atol=1e-6 * float(np.abs(exp).max()))
                elif a[k].dtype == torch.bfloat16:
                    tol = dict(rtol=BF16_STEP, atol=0)
                else:
                    tol = dict(rtol=rtol, atol=0)
                np.testing.assert_allclose(got, exp, **tol,
                                           err_msg=f"{case} step {i} {name} "
                                                   f"{k}")
    assert (st.master is None) == (sj.master is None)
    assert (st.error is None) == (sj.error is None)


def test_compress_int8_matches_repro_bit_for_bit():
    """Ties at .5 after the scale round half to even on both sides."""
    rng = np.random.default_rng(3)
    g = rng.normal(0, 1, (64,)).astype(np.float32)
    g[:6] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5]  # scale 1: exact ties
    err = (rng.normal(0, 1e-3, (64,))).astype(np.float32)
    err[:6] = 0
    for gg, ee in ((g, err), (g * 1e-4, err * 1e-4)):
        dj, rj = RO._compress_int8(jnp.asarray(gg, jnp.bfloat16),
                                   jnp.asarray(ee, jnp.bfloat16))
        dt, rt = TO._compress_int8(torch.from_numpy(gg).to(torch.bfloat16),
                                   torch.from_numpy(ee).to(torch.bfloat16))
        assert dt.dtype == rt.dtype == torch.bfloat16
        np.testing.assert_array_equal(f32(dt), f32(dj))
        np.testing.assert_array_equal(f32(rt), f32(rj))
    assert f32(dt)[:0].size == 0 and list(f32(
        TO._compress_int8(torch.tensor(g[:6]), torch.zeros(6))[0])) == [
        127.0, 2.0, -4.0, 0.0, -0.0, 2.0]


@pytest.mark.parametrize("name", ["cosine", "rsqrt", "constant"])
def test_schedules_match_repro_bit_for_bit(name):
    kw = {"cosine": dict(warmup=7, total=40, min_ratio=0.2),
          "rsqrt": dict(warmup=7), "constant": dict()}[name]
    steps = np.arange(0, 60, dtype=np.int32)
    got = TSch.SCHEDULES[name](torch.from_numpy(steps), **kw)
    exp = RSch.SCHEDULES[name](jnp.asarray(steps), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    for s in (0, 7, 39, 59):  # a 0-d step, as the optimizer state holds it
        one = TSch.SCHEDULES[name](torch.tensor(s, dtype=torch.int32), **kw)
        assert one.shape == () and float(one) == float(exp[s])


@pytest.mark.parametrize("shard,n_shards", [(0, 1), (1, 2), (3, 4)])
def test_synthetic_tokens_equal_repro(shard, n_shards):
    for step in (0, 5):
        got = SyntheticTokens(1000, 16, 8, seed=7).batch_at(step, shard,
                                                            n_shards)
        exp = RT.SyntheticTokens(1000, 16, 8, seed=7).batch_at(step, shard,
                                                               n_shards)
        assert got.keys() == exp.keys()
        for k in exp:
            assert got[k].dtype == exp[k].dtype
            np.testing.assert_array_equal(got[k], exp[k])


def test_abstract_opt_state_allocates_nothing():
    params = dict(init_params(None, get_smoke_config("llama3-8b"),
                              device="meta").named_parameters())
    cfg = AdamWConfig(moment_dtype="bfloat16", master_weights=True,
                      compress_grads=True)
    st = abstract_opt_state(params, cfg)
    assert st.step.device.type == "meta" and st.step.dtype == torch.int32
    for tree, dt in ((st.mu, torch.bfloat16), (st.nu, torch.bfloat16),
                     (st.master, torch.float32), (st.error, torch.bfloat16)):
        assert tree.keys() == params.keys()
        for k, p in params.items():
            assert tree[k].device.type == "meta" and tree[k].dtype == dt
            assert tree[k].shape == p.shape


# ---------------------------------------------------------------------------
# The reference's substrate tests, on the port
# ---------------------------------------------------------------------------

class TestOptimizer:
    def test_adamw_converges_quadratic(self):
        params = quad_params()
        cfg = AdamWConfig(lr=0.1, weight_decay=0.0, clip_norm=1e9)
        state = init_opt_state(params, cfg)
        for _ in range(200):
            params, state, _ = adamw_update(params, quad_grads(params), state,
                                            cfg, torch.tensor(1.0))
        assert quad_loss(params) < 1e-3

    def test_clipping(self):
        params = quad_params()
        cfg = AdamWConfig(lr=0.0, clip_norm=1.0)
        state = init_opt_state(params, cfg)
        g = {k: 100.0 * torch.ones_like(p) for k, p in params.items()}
        _, _, m = adamw_update(params, g, state, cfg, torch.tensor(1.0))
        assert float(m["grad_norm"]) > 100.0  # raw norm reported
        assert float(m["grad_norm"]) == pytest.approx(
            float(global_norm(g)))

    def test_bf16_moments(self):
        params = quad_params()
        state = init_opt_state(params, AdamWConfig(moment_dtype="bfloat16"))
        assert state.mu["w"].dtype == torch.bfloat16
        assert state.nu["b"].dtype == torch.bfloat16

    def test_compressed_grads_converge(self):
        params = quad_params()
        cfg = AdamWConfig(lr=0.05, weight_decay=0.0, compress_grads=True)
        state = init_opt_state(params, cfg)
        for _ in range(300):
            params, state, _ = adamw_update(params, quad_grads(params), state,
                                            cfg, torch.tensor(1.0))
        assert quad_loss(params) < 1e-2  # error feedback preserves signal

    def test_master_copy_is_its_own_tensor(self):
        params = quad_params()
        state = init_opt_state(params, AdamWConfig(master_weights=True))
        assert all(state.master[k] is not p
                   and state.master[k].data_ptr() != p.data_ptr()
                   for k, p in params.items())

    def test_schedule_shape(self):
        s = TSch.warmup_cosine(torch.tensor(0), warmup=10, total=100)
        e = TSch.warmup_cosine(torch.tensor(100), warmup=10, total=100)
        m = TSch.warmup_cosine(torch.tensor(10), warmup=10, total=100)
        assert float(s) == 0.0 and float(m) == pytest.approx(1.0)
        assert float(e) == pytest.approx(0.1, abs=1e-3)


class TestTrainStep:
    def _setup(self, microbatches=1):
        cfg = get_smoke_config("llama3-8b")
        model = init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
        opt_cfg = AdamWConfig(lr=1e-3)
        state = init_opt_state(dict(model.named_parameters()), opt_cfg)
        step = make_train_step(cfg, opt_cfg, microbatches=microbatches)
        batch = {k: torch.from_numpy(v) for k, v in
                 SyntheticTokens(cfg.vocab, 32, 4).batch_at(0).items()}
        return model, state, step, batch

    def test_loss_decreases(self):
        model, state, step, batch = self._setup()
        losses = []
        for _ in range(8):
            model, state, metrics = step(model, state, batch)
            losses.append(float(metrics["loss"]))
        assert losses[-1] < losses[0]
        assert all(p.grad is None for p in model.parameters())
        assert all(p.requires_grad for p in model.parameters())

    def test_grad_accum_equivalent(self):
        """microbatches=2 must produce (nearly) the same update as 1."""
        m1, s1, step1, batch = self._setup(1)
        m2, s2, step2, _ = self._setup(2)
        m1, _, met1 = step1(m1, s1, batch)
        m2, _, met2 = step2(m2, s2, batch)
        assert set(met2) == {"loss", "grad_norm", "lr"}
        assert {"loss", "tokens", "grad_norm", "lr"} <= set(met1)
        d = max(float((a.detach().float() - b.detach().float()).abs().max())
                for a, b in zip(m1.parameters(), m2.parameters()))
        assert d < 0.05  # bf16 params: one quantum of drift allowed

    def test_eval_step_leaves_no_gradient(self):
        model, state, step, batch = self._setup()
        metrics = make_eval_step(model.cfg)(model, batch)
        assert set(metrics) == {"loss", "tokens"}
        assert all(p.grad is None for p in model.parameters())


class TestCheckpoint:
    def test_save_restore_roundtrip(self, tmp_path):
        tree = {"a": torch.arange(6).reshape(2, 3),
                "b": {"c": torch.tensor([1.0, -2.5, 3e-3, 7e4],
                                        dtype=torch.bfloat16)},
                "n": None,
                "o": TO.OptState(torch.tensor(3, dtype=torch.int32),
                                 {"w": torch.ones(2)}, {"w": torch.zeros(2)},
                                 None, None)}
        save_checkpoint(str(tmp_path), 5, tree)
        assert latest_step(str(tmp_path)) == 5
        out = restore_checkpoint(str(tmp_path), 5, tree)
        assert torch.equal(out["a"], tree["a"])
        assert out["b"]["c"].dtype == torch.bfloat16
        assert torch.equal(out["b"]["c"].view(torch.int16),
                           tree["b"]["c"].view(torch.int16))
        assert out["n"] is None
        assert isinstance(out["o"], TO.OptState) and out["o"].master is None
        assert int(out["o"].step) == 3
        import json
        with open(tmp_path / "step_00000005" / "manifest.json") as f:
            leaves = json.load(f)["leaves"]
        assert leaves["n"] is None and leaves["o/master"] is None
        assert leaves["b/c"]["dtype"] == "bfloat16"
        assert leaves["o/step"] == {"file": "o_step.npy", "shape": [],
                                    "dtype": "int32"}

    def test_restore_onto_meta_targets(self, tmp_path):
        tree = {"w": torch.randn(3, 4).to(torch.bfloat16)}
        save_checkpoint(str(tmp_path), 1, tree)
        out = restore_checkpoint(str(tmp_path), 1,
                                 {"w": torch.empty(3, 4, device="meta")})
        assert out["w"].device.type == "cpu"
        assert torch.equal(out["w"], tree["w"])

    def test_atomicity_keeps_previous_on_gc(self, tmp_path):
        tree = {"a": torch.zeros(3)}
        for s in (1, 2, 3, 4):
            save_checkpoint(str(tmp_path), s, tree)
        os.makedirs(tmp_path / "step_00000009.tmp")  # a save cut short
        assert latest_step(str(tmp_path)) == 4
        kept = sorted(os.listdir(tmp_path))
        assert [d for d in kept if not d.endswith(".tmp")] == [
            "step_00000002", "step_00000003", "step_00000004"]

    def test_resume_training(self, tmp_path):
        cfg = get_smoke_config("llama3-8b")
        opt_cfg = AdamWConfig()
        model = init_params(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
        state = init_opt_state(dict(model.named_parameters()), opt_cfg)
        step = make_train_step(cfg, opt_cfg)
        src = SyntheticTokens(cfg.vocab, 32, 4)

        def batch(i):
            return {k: torch.from_numpy(v) for k, v in
                    src.batch_at(i).items()}

        for i in range(3):
            model, state, _ = step(model, state, batch(i))
        params = dict(model.named_parameters())
        save_checkpoint(str(tmp_path), 3, {"params": params, "opt": state})
        # crash + restart
        m2 = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
        p2 = dict(m2.named_parameters())
        restored = restore_checkpoint(
            str(tmp_path), 3, {"params": p2, "opt": init_opt_state(
                p2, opt_cfg)})
        assert int(restored["opt"].step) == 3
        for k, p in params.items():
            assert torch.equal(restored["params"][k], p.detach())
            assert torch.equal(restored["opt"].mu[k], state.mu[k])
            assert torch.equal(restored["opt"].nu[k], state.nu[k])
        # the next step from the restored state equals the uninterrupted one
        with torch.no_grad():
            for k, p in p2.items():
                p.copy_(restored["params"][k])
        model, state, m_a = step(model, state, batch(3))
        m2, _, m_b = step(m2, restored["opt"], batch(3))
        assert float(m_a["loss"]) == float(m_b["loss"])
        for a, b in zip(model.parameters(), m2.parameters()):
            assert torch.equal(a, b)

    def test_shape_mismatch_rejected(self, tmp_path):
        save_checkpoint(str(tmp_path), 1, {"a": torch.zeros((2, 2))})
        with pytest.raises(ValueError, match="shape"):
            restore_checkpoint(str(tmp_path), 1,
                               {"a": torch.empty((3, 3), device="meta")})


class TestData:
    def test_deterministic_batches(self):
        src = SyntheticTokens(1000, 16, 8, seed=7)
        a = src.batch_at(3)
        b = src.batch_at(3)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        c = src.batch_at(4)
        assert not np.array_equal(a["tokens"], c["tokens"])

    def test_sharded_batches_disjoint_rng(self):
        src = SyntheticTokens(1000, 16, 8, seed=7)
        s0 = src.batch_at(0, shard=0, n_shards=2)
        s1 = src.batch_at(0, shard=1, n_shards=2)
        assert s0["tokens"].shape[0] == 4
        assert not np.array_equal(s0["tokens"], s1["tokens"])

    def test_labels_shift(self):
        src = SyntheticTokens(1000, 16, 2)
        b = src.batch_at(0)
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])

    def test_prefetcher(self):
        """Each wait with a timeout: the queue's own ``get``."""
        src = SyntheticTokens(100, 8, 2)
        pf = Prefetcher(src, start_step=5, depth=2)
        try:
            s, batch = pf.q.get(timeout=30)
            assert s == 5
            np.testing.assert_array_equal(batch["tokens"],
                                          src.batch_at(5)["tokens"])
            s2, _ = pf.q.get(timeout=30)
            assert s2 == 6
        finally:
            pf.close()
        assert not pf._thread.is_alive()


class TestFault:
    def test_straggler_detection(self):
        mon = StragglerMonitor(factor=2.0, window=8)
        for _ in range(6):
            assert not mon.record(1.0)
        assert mon.record(5.0)
        assert mon.slow_steps == 1
        assert mon.baseline == 1.0  # the slow step stays out of it
        assert mon.record(5.0) and mon.slow_steps == 2

    def test_step_timer(self):
        with StepTimer() as t:
            time.sleep(0.01)
        assert 0.01 <= t.seconds < 5.0
