"""The port's sort-based capacity MoE (``repro_torch.models.ffn``) against
the JAX package's ``moe_ffn``, on the CPU, and the MoE archs' routing in
the whole model.

Every MoE parameter is drawn from a numpy seed (the router bias nonzero)
and given to both packages. Tolerances, from the measured gaps:

* the routing (each token's k experts), ``dropped_frac`` and the
  capacity: equal (in the whole model ``dropped_frac`` within 1e-7: the
  compiled reference divides by n as a product with 1/n);
* f32 output ``rtol=1e-5, atol=1e-6``; ``router_entropy`` ``rtol=1e-6``;
* bf16 output: bit-identical (the k contributions of a token summed in
  the reference's sorted order, one rounding an add);
* the whole model (deepseek-v2/v3, jamba, f32): the experts of every
  token of every MoE layer equal at prefill and at each decode step, and
  ``dropped_frac`` equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ffn as RF
from repro.models import model as RM
from repro.models.config import ModelConfig, MoEConfig
from repro_torch.configs import get_smoke_config
from repro_torch.models import ffn as TF
from repro_torch.models import model as TM
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.models.config import MoEConfig as TMoEConfig
from repro_torch.models.layers import ParamBuilder

from _torch_lm import BF16_TOL, F32_TOL, ROUNDED_CACHE_TOL, serve_both


def moe_configs(router="softmax", n_shared=0, cf=1.25, activation="swiglu"):
    kw = dict(name="t", d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
              d_ff=64, vocab=16, activation=activation)
    mk = dict(n_experts=8, top_k=3, expert_ff=48, n_shared=n_shared,
              shared_ff=40, router=router, capacity_factor=cf)
    return (ModelConfig(**kw, moe=MoEConfig(**mk)),
            TModelConfig(**kw, moe=TMoEConfig(**mk)))


def moe_params(ct, dtype, seed=0):
    """(JAX params under ``ffn.``, the port's ``MoEFFN``): every tensor
    drawn from a numpy seed, the router at a scale that gives close
    probabilities."""
    p = TF.MoEFFN(ParamBuilder(None, dtype, "meta"), ct)
    rng = np.random.default_rng(seed)
    state, flat = {}, {}
    for k, t in p.state_dict().items():
        scale = 0.3 if k == "router" else 1 / np.sqrt(t.shape[-2]) \
            if t.dim() > 1 else 0.5
        v = (rng.normal(size=tuple(t.shape)) * scale).astype(np.float32)
        state[k] = torch.from_numpy(v).to(dtype)
        flat[f"ffn.{k}"] = jnp.asarray(v, jnp.float32 if dtype ==
                                       torch.float32 else jnp.bfloat16)
    p.load_state_dict(state, assign=True)
    return flat, p


def run_both(router, n_shared, cf, dtype, t=(3, 40), seed=0, x=None):
    cj, ct = moe_configs(router, n_shared, cf)
    flat, p = moe_params(ct, dtype, seed)
    if x is None:
        x = np.random.default_rng(seed + 1).normal(
            size=t + (cj.d_model,)).astype(np.float32)
    xt = torch.from_numpy(x).to(dtype)
    xj = jnp.asarray(x, jnp.float32 if dtype == torch.float32
                     else jnp.bfloat16)
    yj, auxj = RF.moe_ffn(flat, cj, "ffn", xj)
    yt, auxt = TF.moe_ffn(p, ct, xt)
    # the reference's selection, from its own router product
    xf = xj.reshape(-1, cj.d_model)
    logits = (xf @ flat["ffn.router"]).astype(jnp.float32)
    if router == "sigmoid_bias":
        sel = jax.nn.sigmoid(logits) + flat["ffn.router_bias"].astype(
            jnp.float32)[None]
    else:
        sel = jax.nn.softmax(logits, axis=-1)
    return yj, auxj, yt, auxt, np.asarray(jax.lax.top_k(sel, cj.moe.top_k)[1])


CASES = [(r, ns, cf) for r in ("softmax", "sigmoid_bias")
         for ns in (0, 2) for cf in (1.25, 0.3)]


@pytest.mark.parametrize("router,n_shared,cf", CASES,
                         ids=[f"{r}-shared{ns}-cf{cf}" for r, ns, cf in CASES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_matches_repro(router, n_shared, cf, dtype):
    dt = getattr(torch, dtype)
    yj, auxj, yt, auxt, idx = run_both(router, n_shared, cf, dt)
    np.testing.assert_array_equal(auxt["idx"].numpy(), idx)
    assert float(auxt["dropped_frac"]) == float(auxj["dropped_frac"])
    if cf < 1:
        assert float(auxj["dropped_frac"]) > 0.2  # slots did drop
    np.testing.assert_allclose(float(auxt["router_entropy"]),
                               float(auxj["router_entropy"]), rtol=1e-6)
    got = yt.float().numpy()
    exp = np.asarray(yj.astype(jnp.float32))
    assert yt.dtype == dt and got.shape == exp.shape
    if dt == torch.bfloat16:
        np.testing.assert_array_equal(got, exp)
    else:
        np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-6)


def test_moe_gelu_experts_match_repro():
    """A non-swiglu config's experts use gelu, as the reference's do."""
    cj, ct = moe_configs(activation="geglu")
    flat, p = moe_params(ct, torch.float32)
    x = np.random.default_rng(3).normal(size=(2, 16, 32)).astype(np.float32)
    yj, _ = RF.moe_ffn(flat, cj, "ffn", jnp.asarray(x))
    yt, _ = TF.moe_ffn(p, ct, torch.from_numpy(x))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-6)


def test_routing_ties_take_the_lower_expert():
    """Equal router outputs: the lower expert index first, as
    ``jax.lax.top_k`` takes it, in selection and in the combine."""
    x = np.zeros((2, 6, 32), np.float32)  # every expert's logit 0
    x[1, :3] = np.random.default_rng(5).normal(size=(3, 32))
    for router in ("softmax", "sigmoid_bias"):
        yj, auxj, yt, auxt, idx = run_both(router, 0, 1.25, torch.float32,
                                           x=x)
        if router == "softmax":
            np.testing.assert_array_equal(idx[:6], [[0, 1, 2]] * 6)
        np.testing.assert_array_equal(auxt["idx"].numpy(), idx)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                                   atol=1e-6)
    vals = torch.tensor([[1.0, 3.0, 3.0, 0.5, 3.0]])
    v, i = TF.top_k(vals, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(vals.numpy()), 3)
    assert i.tolist() == np.asarray(ji).tolist() == [[1, 2, 4]]
    assert v.tolist() == np.asarray(jv).tolist()


@pytest.mark.parametrize("tokens", [1, 4, 24, 100, 2048, 8192])
def test_capacity_matches_repro(tokens):
    """The capacity the reference's buffer has: ``max(1, int(cf * T * k /
    E))`` rounded up to a multiple of 32."""
    for cf in (1.25, 0.3):
        cj, ct = moe_configs(cf=cf)
        flat, p = moe_params(ct, torch.float32)
        x = jnp.zeros((1, tokens, 32))
        # the reference's buffer shape shows in its dispatch: trace it
        jaxpr = jax.make_jaxpr(lambda a: RF.moe_ffn(flat, cj, "ffn", a))(x)
        shapes = {tuple(v.aval.shape) for e in jaxpr.eqns
                  for v in e.outvars if hasattr(v.aval, "shape")}
        cap = TF.capacity(ct, tokens)
        assert cap % 32 == 0 and (8, cap, 32) in shapes
    full = dataclasses.replace(ct, moe=dataclasses.replace(
        ct.moe, n_experts=160, top_k=6, capacity_factor=1.25))
    assert TF.capacity(full, 4) == 32 and TF.capacity(full, 2048) == 96


# ---------------------------------------------------------------------------
# the MoE archs in the whole model
# ---------------------------------------------------------------------------

F32 = dict(dtype="float32", param_dtype="float32")


@pytest.mark.parametrize("case", ["f32", "f32 bf16-cache", "bf16"])
def test_deepseek_v3_prefill_decode_match_repro(case):
    """deepseek-v3 (the sigmoid_bias router, the MTP head's weights
    carried across): prefill and 4 decode steps."""
    if case == "f32":
        serve_both("deepseek-v3-671b", F32_TOL, f32_caches=True, **F32)
    elif case == "f32 bf16-cache":
        serve_both("deepseek-v3-671b", ROUNDED_CACHE_TOL, **F32)
    else:
        serve_both("deepseek-v3-671b", BF16_TOL)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "deepseek-v3-671b",
                                  "jamba-v0.1-52b"])
def test_model_routing_matches_repro(arch, monkeypatch):
    """Each MoE layer's experts for every token, and its dropped_frac,
    equal the reference's at prefill and at every decode step (f32)."""
    got, exp = [], []
    tm_moe, rm_moe = TM.moe_ffn, RM.moe_ffn

    def torch_moe(p, cfg, x, layout=None):
        y, aux = tm_moe(p, cfg, x, layout)
        got.append((aux["idx"].numpy(), float(aux["dropped_frac"])))
        return y, aux

    def jax_moe(params, cfg, name, x):
        y, aux = rm_moe(params, cfg, name, x)
        m = cfg.moe
        logits = (x.reshape(-1, x.shape[-1])
                  @ params[f"{name}.router"]).astype(jnp.float32)
        if m.router == "sigmoid_bias":
            sel = jax.nn.sigmoid(logits) + params[
                f"{name}.router_bias"].astype(jnp.float32)[None]
        else:
            sel = jax.nn.softmax(logits, axis=-1)
        idx = jax.lax.top_k(sel, m.top_k)[1]
        jax.debug.callback(lambda i, d: exp.append((np.asarray(i),
                                                    float(d))),
                           idx, aux["dropped_frac"], ordered=True)
        return y, aux

    monkeypatch.setattr(TM, "moe_ffn", torch_moe)
    monkeypatch.setattr(RM, "moe_ffn", jax_moe)
    serve_both(arch, dict(rtol=1e-3, atol=1e-3), f32_caches=True, **F32)
    n_moe = sum(f == "moe" for _, f in
                get_smoke_config(arch).layer_specs)
    assert len(got) == len(exp) == 5 * n_moe
    for (gi, gd), (ei, ed) in zip(got, exp):
        np.testing.assert_array_equal(gi, ei)
        # compiled, XLA divides the mean by n as a product with 1/n: a
        # 1 - 1.00000003 of -3e-8 where nothing dropped
        assert abs(gd - ed) <= 1e-7
