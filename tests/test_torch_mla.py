"""The port's MLA (``repro_torch.models.attention``: ``MLA``,
``mla_forward``, ``init_mla_cache``) against the JAX package's, on the
CPU, and deepseek-v2 served whole.

Every MLA parameter is drawn from a numpy seed (the norms nonzero) and
given to both packages. Tolerances, from the measured gaps:

* f32, both branches (the absorbed form over a cache, prefill then
  decode steps; the cache-free form through ``chunked_attention``):
  ``rtol=1e-4, atol=1e-4`` (largest gap 2.3e-5 on outputs up to 20), the
  latent cache in f32 on both sides; with
  the reference's bf16 latent cache ``rtol=1e-4, atol=1e-3`` (the f32
  latents are rounded to bf16, and a last-bit difference flips a
  rounding);
* bf16: ``rtol=0.02, atol=0.02`` (the bf16 products of the two CPU
  libraries round in another order);
* deepseek-v2's logits as ``tests/test_torch_models.py`` holds the dense
  archs': f32 ``1e-4`` with every cache in f32, ``rtol=1e-4, atol=2e-2``
  with its own caches, bf16 ``rtol=0.08, atol=0.15``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as RA
from repro_torch import configs as TC
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models.layers import ParamBuilder

from _torch_lm import (BF16_TOL, F32_TOL, ROUNDED_CACHE_TOL, configs,
                       jax_flat, jax_model, load, serve_both, to_flat)

F32 = dict(dtype="float32", param_dtype="float32")


def mla_params(ct, dtype, seed=0):
    """(JAX params under ``attn.``, the port's ``MLA``), drawn from a
    numpy seed."""
    p = TA.MLA(ParamBuilder(None, dtype, "meta"), ct)
    rng = np.random.default_rng(seed)
    state, flat = {}, {}
    for k, t in p.state_dict().items():
        scale = 1 / np.sqrt(t.shape[-2]) if t.dim() > 1 else 0.3
        v = (rng.normal(size=tuple(t.shape)) * scale).astype(np.float32)
        state[k] = torch.from_numpy(v).to(dtype)
        flat[f"attn.{k}"] = jnp.asarray(
            v, jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
    p.load_state_dict(state, assign=True)
    return flat, p


def f32(a):
    return np.asarray(a.astype(jnp.float32)) if isinstance(a, jax.Array) \
        else a.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cache", ["f32", "bf16"])
def test_mla_absorbed_with_cache_matches_repro(dtype, cache):
    """The absorbed branch: a prefill of 20 positions into a cache of 32,
    then 3 decode steps; the cache is written in place."""
    cj, ct = configs("deepseek-v2-236b", dtype=dtype, param_dtype=dtype)
    dt = getattr(torch, dtype)
    flat, p = mla_params(ct, dt)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 23, cj.d_model)).astype(np.float32)
    jdt = jnp.float32 if dt == torch.float32 else jnp.bfloat16
    cj_ = RA.init_mla_cache(2, 32, cj)
    ct_ = TA.init_mla_cache(2, 32, ct, device="cpu")
    if cache == "f32":
        cj_ = cj_._replace(c_kv=cj_.c_kv.astype(jnp.float32),
                           k_rope=cj_.k_rope.astype(jnp.float32))
        ct_ = ct_._replace(c_kv=ct_.c_kv.float(), k_rope=ct_.k_rope.float())
    tol = (dict(rtol=1e-4, atol=1e-4) if cache == "f32" else
           dict(rtol=1e-4, atol=1e-3)) if dt == torch.float32 else \
        dict(rtol=0.02, atol=0.02)
    steps = [(0, 20), (20, 21), (21, 22), (22, 23)]
    for s0, s1 in steps:
        pos = np.broadcast_to(np.arange(s0, s1)[None], (2, s1 - s0))
        oj, cj_ = RA.mla_forward(flat, cj, "attn", jnp.asarray(
            x[:, s0:s1], jdt), jnp.asarray(pos), cache=cj_, cache_pos=s0)
        kept = ct_.c_kv
        ot, ct_ = TA.mla_forward(p, ct, torch.from_numpy(
            x[:, s0:s1]).to(dt), torch.from_numpy(pos.copy()), cache=ct_,
            cache_pos=s0)
        assert ct_.c_kv is kept and ct_.length == int(cj_.length) == s1
        assert ot.dtype == dt
        np.testing.assert_allclose(f32(ot), f32(oj), **tol,
                                   err_msg=f"positions {s0}:{s1}")
        np.testing.assert_allclose(f32(ct_.c_kv), f32(cj_.c_kv), **tol)
        np.testing.assert_allclose(f32(ct_.k_rope), f32(cj_.k_rope), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [20, 150])
def test_mla_cache_free_matches_repro(dtype, s):
    """The cache-free branch: keys and values expanded per head through
    ``chunked_attention(scale=)``; 150 positions span several query and
    key chunks (attn_chunk 64)."""
    cj, ct = configs("deepseek-v2-236b", dtype=dtype, param_dtype=dtype)
    dt = getattr(torch, dtype)
    flat, p = mla_params(ct, dt, seed=2)
    x = np.random.default_rng(3).normal(
        size=(2, s, cj.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None], (2, s)).copy()
    jdt = jnp.float32 if dt == torch.float32 else jnp.bfloat16
    oj, none_j = RA.mla_forward(flat, cj, "attn", jnp.asarray(x, jdt),
                                jnp.asarray(pos))
    ot, none_t = TA.mla_forward(p, ct, torch.from_numpy(x).to(dt),
                                torch.from_numpy(pos))
    assert none_j is None and none_t is None
    tol = dict(rtol=1e-4, atol=1e-4) if dt == torch.float32 else \
        dict(rtol=0.02, atol=0.02)
    np.testing.assert_allclose(f32(ot), f32(oj), **tol)


def test_mla_cache_refuses_int8_and_is_bf16():
    cfg = TC.get_smoke_config("deepseek-v2-236b")
    with pytest.raises(NotImplementedError, match="int8 MLA cache"):
        TA.init_mla_cache(1, 8, cfg, "int8", device="cpu")
    c = TA.init_mla_cache(2, 8, cfg, device="cpu")
    cj = RA.init_mla_cache(2, 8, cfg)
    assert c.c_kv.dtype == c.k_rope.dtype == torch.bfloat16
    assert tuple(c.c_kv.shape) == cj.c_kv.shape == (2, 8, 32)
    assert tuple(c.k_rope.shape) == cj.k_rope.shape == (2, 8, 16)
    assert c.length == 0
    # the model's caches ignore kv_cache_dtype for MLA, as the JAX
    # package's init_caches does
    int8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    assert all(x.c_kv.dtype == torch.bfloat16
               for x in TM.init_caches(int8, 1, 8, device="meta"))


@pytest.mark.parametrize("case", ["f32", "f32 bf16-cache", "bf16"])
def test_deepseek_v2_prefill_decode_match_repro(case):
    if case == "f32":
        serve_both("deepseek-v2-236b", F32_TOL, f32_caches=True, **F32)
    elif case == "f32 bf16-cache":
        serve_both("deepseek-v2-236b", ROUNDED_CACHE_TOL, **F32)
    else:
        serve_both("deepseek-v2-236b", BF16_TOL)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "deepseek-v3-671b"])
def test_params_from_jax_round_trip(arch):
    """Every weight (the MoE experts, the MTP head's) carries across and
    back unchanged."""
    cj, ct = configs(arch)
    flat = jax_flat(jax_model(cj).params)
    tm = load(flat, ct)
    back = to_flat(tm)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    assert (tm.mtp is not None) == cj.mtp
    if cj.mtp:
        np.testing.assert_array_equal(tm.mtp.proj.float().numpy(),
                                      flat["mtp.proj"])
    np.testing.assert_array_equal(
        tm.blocks[-1].ffn.w_gate.float().numpy(),
        flat["pattern.slot0.ffn.w_gate"][-1])
    with pytest.raises(ValueError, match="shape"):
        load(dict(flat, **{"pattern.slot0.ffn.router":
                           flat["pattern.slot0.ffn.router"][..., :4]}), ct)
    with pytest.raises(ValueError, match="no parameter"):
        load(dict(flat, **{"mtp.block.attn.w_uq": np.zeros((2, 2))}), ct)


def test_full_width_deepseek_v2_on_meta():
    """deepseek-v2-236b at its published widths, depth cut to n_periods=6
    (the dense prefix layer + 6 MoE layers, 7 of 60): 25.22 B parameters,
    50.4 GB in bf16; the latent caches of 4 requests at max_len 552."""
    cfg = dataclasses.replace(TC.get_config("deepseek-v2-236b"),
                              n_periods=6)
    tm = TM.abstract_params(cfg)
    n = sum(p.numel() for p in tm.parameters())
    # param_count leaves out the norms inside MLA (q_norm, kv_norm) and the
    # final norm
    m = cfg.mla
    assert n == cfg.param_count() + cfg.n_layers * (m.q_lora + m.kv_lora) \
        + cfg.d_model
    assert cfg.param_count() == 25_219_241_984
    assert 2 * n / 1e9 == pytest.approx(50.44, abs=0.01)
    assert len(tm.blocks) == 7 and tm.blocks[0].ffn_kind == "dense"
    assert tuple(tm.blocks[1].ffn.w_gate.shape) == (160, 5120, 1536)
    caches = TM.init_caches(cfg, 4, 552, device="meta")
    assert all(c.c_kv.is_meta and c.c_kv.shape == (4, 552, 512)
               and c.k_rope.shape == (4, 552, 64) for c in caches)
    nbytes = sum(2 * (c.c_kv.numel() + c.k_rope.numel()) for c in caches)
    assert nbytes == 7 * 4 * 552 * 576 * 2  # 17.8 MB
