"""The port's LM/VLM substrate (``repro_torch.models``, ``repro_torch.
configs``) against the JAX package's, on the CPU, at smoke size.

Weights come from ``repro``'s ``init_params(jax.random.key(1), cfg)``
through ``params_from_jax``; prompts from numpy with a seed. Tolerances:

* f32 prefill and decode logits: ``rtol=1e-4, atol=1e-4``, with the KV
  cache held in f32 on both sides (largest difference measured 3.5e-5);
* f32 with the configs' bf16 cache, or an int8 one: ``rtol=1e-4,
  atol=2e-2``. The f32 keys and values are rounded to bf16 (or int8)
  before attention, and the last-bit differences of the two CPU matmul
  libraries flip some of those roundings: the largest difference
  measured is 6.3e-3 with the bf16 cache and 1.4e-4 with the int8 one,
  and an int8 step is wider than a bf16 one;
* bf16: ``rtol=0.08, atol=0.15``, the JAX package's own tolerance for
  decode against prefill (``tests/test_models.py``);
* ``chunked_attention`` in f32: ``atol=2e-5``; norms and rope in f32:
  ``rtol=atol=1e-6``; the int8 quantisation and the bf16 activations:
  bit-identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import model as RM
from repro_torch import configs as TC
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

from _torch_lm import (BF16_TOL, F32_TOL, ROUNDED_CACHE_TOL, configs, f32,
                       jax_flat, load, serve_both, to_flat)

DENSE_ARCHS = ["llava-next-mistral-7b", "llama3-8b", "command-r-plus-104b",
               "gemma-7b", "nemotron-4-15b"]


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_prefill_decode_f32_match_repro(arch):
    serve_both(arch, F32_TOL, f32_caches=True, dtype="float32",
               param_dtype="float32")


@pytest.mark.parametrize("arch", DENSE_ARCHS)
@pytest.mark.parametrize("case", ["bf16", "f32 bf16-cache", "f32 int8-cache"])
def test_prefill_decode_bf16_match_repro(arch, case):
    kw, tol = {"bf16": ({}, BF16_TOL),
               "f32 bf16-cache": (dict(dtype="float32",
                                       param_dtype="float32"),
                                  ROUNDED_CACHE_TOL),
               "f32 int8-cache": (dict(dtype="float32", param_dtype="float32",
                                       kv_cache_dtype="int8"),
                                  ROUNDED_CACHE_TOL)}[case]
    serve_both(arch, tol, **kw)


# ---------------------------------------------------------------------------
# attention core and cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(causal=True),
    dict(causal=True, sliding_window=24),
    dict(causal=True, softcap=5.0),
    dict(causal=False, softcap=5.0),
    dict(causal=True, q_offset=8),
], ids=["causal", "window", "softcap", "bidir-softcap", "offset"])
def test_chunked_attention_matches_repro(kw):
    rng = np.random.default_rng(3)
    b, sq, sk, h, hkv, d = 2, 40, 40, 4, 2, 16
    if kw.get("q_offset"):
        sk = sq + kw["q_offset"]
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in
               ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d)))
    exp = RA.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               q_chunk=16, kv_chunk=16, **kw)
    got = TA.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), q_chunk=16, kv_chunk=16,
                               **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=0,
                               atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_quantize_bit_identical(dtype):
    rng = np.random.default_rng(4)
    x = rng.normal(0, 3, (3, 7, 2, 32)).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero row takes the 1e-8 floor
    x[1, 2, 1, :4] = [127.5, -0.5, 1.5, 2.5]  # round-half-even cases
    xj = jnp.asarray(x, getattr(jnp, dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    qj, sj = RA._quantize(xj)
    qt, st = TA._quantize(xt)
    assert qt.dtype == torch.int8 and st.dtype == torch.bfloat16
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(f32(st), f32(sj))
    np.testing.assert_array_equal(TA._dequantize(qt, st).numpy(),
                                  np.asarray(RA._dequantize(qj, sj)))


def test_cache_update_in_place_matches_repro():
    rng = np.random.default_rng(5)
    new = rng.normal(size=(2, 3, 2, 8)).astype(np.float32)
    for dt in ("bfloat16", "int8"):
        cj = RA.cache_update(RA.init_kv_cache(2, 10, 2, 8, dt),
                             jnp.asarray(new), jnp.asarray(new), 4)
        ct = TA.init_kv_cache(2, 10, 2, 8, dt, device="cpu")
        ct2 = TA.cache_update(ct, torch.from_numpy(new),
                              torch.from_numpy(new), 4)
        assert ct2.k is ct.k and ct2.length == int(cj.length) == 3
        for a, b in zip(TA.cache_kv(ct2), RA.cache_kv(cj)):
            np.testing.assert_array_equal(f32(a), f32(b))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_apply_rope_matches_repro(theta):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 9, 3, 32)).astype(np.float32)
    pos = np.stack([np.arange(9), np.arange(100, 109)]).astype(np.int32)
    exp = RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-6,
                               atol=1e-6)


def test_norms_match_repro():
    rng = np.random.default_rng(7)
    x, w, b = (rng.normal(size=s).astype(np.float32)
               for s in ((4, 5, 64), (64,), (64,)))
    np.testing.assert_allclose(
        TL.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(RL.rmsnorm(jnp.asarray(x), jnp.asarray(w))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        TL.layernorm(*map(torch.from_numpy, (x, w, b))).numpy(),
        np.asarray(RL.layernorm(*map(jnp.asarray, (x, w, b)))),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["gelu", "silu", "relu", "sqrelu"])
def test_activations_match_repro(name):
    x = np.random.default_rng(8).normal(0, 3, 20_000).astype(np.float32)
    ref = {"silu": jax.nn.silu}.get(name) or RL.activation_fn(name)
    # bf16: every step rounds where JAX's does, so bit-identical
    got = TL.activation_fn(name)(torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_array_equal(f32(got),
                                  f32(ref(jnp.asarray(x, jnp.bfloat16))))
    np.testing.assert_allclose(TL.activation_fn(name)(
        torch.from_numpy(x)).numpy(), np.asarray(ref(jnp.asarray(x))),
        rtol=1e-6, atol=1e-6)


def test_gelu_is_the_tanh_approximation():
    x = torch.linspace(-6, 6, 1001)
    torch.testing.assert_close(TL.gelu(x), torch.nn.functional.gelu(
        x, approximate="tanh"), rtol=1e-6, atol=1e-6)
    assert (TL.gelu(x) - torch.nn.functional.gelu(x)).abs().max() > 1e-4


def test_param_builder_init_rule():
    """Fan-in is shape[-2]: wq (d, h, dh) is scaled by 1/sqrt(h); drawn in
    f32 and cast; norms zeros, LayerNorm's weight ones."""
    g = torch.Generator().manual_seed(0)
    b = TL.ParamBuilder(g, torch.bfloat16, "cpu")
    wq = b.add((256, 4, 64), ("embed", "heads", None))
    assert wq.dtype == torch.bfloat16 and not wq.requires_grad
    assert abs(wq.float().std().item() - 0.5) < 0.01
    g2 = torch.Generator().manual_seed(0)
    exp = (torch.randn((256, 4, 64), generator=g2) * 0.5).to(torch.bfloat16)
    assert torch.equal(wq, exp)
    assert torch.equal(b.add((8,), (None,), init="zeros"),
                       torch.zeros(8, dtype=wq.dtype))
    assert b.axes_of(wq) == ("embed", "heads", None)
    assert TL.ParamBuilder(None, torch.float32, "meta").add(
        (3, 4), (None, None)).device.type == "meta"
    with pytest.raises(ValueError, match="Generator"):
        TL.ParamBuilder(None, torch.float32, "cpu")


# ---------------------------------------------------------------------------
# weights across packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_params_from_jax_round_trip(arch):
    cj, ct = configs(arch)
    flat = jax_flat(RM.init_params(jax.random.key(1), cj).params)
    tm = load(flat, ct)
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    back = to_flat(tm)
    assert sorted(back) == sorted(flat)
    for k in flat:
        assert back[k].shape == flat[k].shape, k
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    # period p, slot s of the pattern is block len(prefix) + p * L + s
    wq = flat["pattern.slot0.attn.wq"]
    np.testing.assert_array_equal(
        tm.blocks[ct.n_periods - 1].attn.wq.float().numpy(), wq[-1])
    assert sum(p.numel() for p in tm.parameters()) == sum(
        v.size for v in flat.values())


def test_params_from_jax_refuses_foreign_names_and_shapes():
    cj, ct = configs("llama3-8b")
    flat = jax_flat(RM.init_params(jax.random.key(1), cj).params)
    with pytest.raises(ValueError, match="no parameter"):
        load(dict(flat, **{"vis_proj1": np.zeros((1024, 128))}),
                        ct)
    with pytest.raises(ValueError, match="no parameter"):
        load(dict(flat, **{"pattern.slot0.attn.bq":
                                      np.zeros((2, 4))}), ct)
    with pytest.raises(ValueError, match="no slot"):
        load(dict(flat, **{"pattern.slot1.attn.wq":
                                      flat["pattern.slot0.attn.wq"]}), ct)
    bad = dict(flat, embed=flat["embed"][:, :64])
    with pytest.raises(ValueError, match="shape"):
        load(bad, ct)
    short = {k: v for k, v in flat.items() if k != "final_norm.w"}
    with pytest.raises(ValueError, match="no value"):
        load(short, ct)


# ---------------------------------------------------------------------------
# configs and the families outside this slice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_configs_match_repro(arch):
    for get in ("get_config", "get_smoke_config"):
        cj, ct = getattr(RC, get)(arch), getattr(TC, get)(arch)
        assert dataclasses.asdict(ct) == dataclasses.asdict(cj)
        assert ct.param_count() == cj.param_count()
        assert ct.active_param_count() == cj.active_param_count()
    for shape in RC.SHAPES:
        assert TC.cell_is_applicable(arch, shape) == \
            RC.cell_is_applicable(arch, shape)
        assert dataclasses.asdict(TC.shape_overrides(TC.get_config(arch),
                                                     shape)) == \
            dataclasses.asdict(RC.shape_overrides(RC.get_config(arch), shape))
    assert TC.ARCH_IDS == RC.ARCH_IDS and TC.SHAPES == RC.SHAPES
    assert TC.SUBQUADRATIC == RC.SUBQUADRATIC


@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_every_arch_builds_and_serves(arch):
    """Every arch's smoke config builds from a generator on the CPU and
    serves: a prefill and 2 greedy decode steps, finite logits, every
    block's cache of its mixer's kind (None for none), and for the
    encoder-decoder the encoding on the caches."""
    cfg = TC.get_smoke_config(arch)
    TM.check_served(cfg)
    tm = TM.init_params(torch.Generator().manual_seed(0), cfg,
                        max_positions=40, device="cpu")
    assert len(tm.blocks) == cfg.n_layers
    nv = cfg.n_patches if cfg.frontend == "vision" else 0
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 12), generator=g)}
    if nv:
        batch["patches"] = torch.randn(2, nv, 1024, generator=g).to(
            torch.bfloat16)
    if cfg.is_encdec:
        batch["frames"] = torch.randn(2, cfg.enc_seq, 128, generator=g).to(
            torch.bfloat16)
    caches = TM.init_caches(cfg, 2, 16 + nv, device="cpu")
    kinds = {"attn": TA.KVCache, "mla": TA.MLACache,
             "ssm": TM.SSMCache}
    for (mixer, _), c in zip(cfg.layer_specs, caches):
        assert isinstance(c, kinds[mixer])
    logits, caches = TM.forward_prefill(tm, batch, caches)
    assert (caches.enc_out is not None) == cfg.is_encdec
    for i in range(2):
        tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
        logits, caches = TM.forward_decode(tm, tok, 12 + nv + i, caches)
        assert logits.shape == (2, 1, cfg.vocab)
        assert bool(torch.isfinite(logits).all())


def test_check_served_refuses_an_unknown_layer():
    cfg = dataclasses.replace(TC.get_smoke_config("llama3-8b"),
                              pattern=(("attn_cross", "dense"),))
    with pytest.raises(ValueError, match="attn_cross"):
        TM.abstract_params(cfg)


def test_full_width_llava_on_meta():
    """The full-width model and caches without allocating: 7.24 B
    parameters by param_count, plus the 21 M of the vision projector and
    the final norm's 4,096 (7.26 B); a 1.56 GB bf16 KV cache at batch 4
    and max_len 2,984."""
    cfg = TC.get_config("llava-next-mistral-7b")
    tm = TM.abstract_params(cfg)
    n = sum(p.numel() for p in tm.parameters())
    assert n == cfg.param_count() + 1024 * 4096 + 4096 * 4096 + 4096
    assert all(p.device.type == "meta" and p.dtype == torch.bfloat16
               for p in tm.parameters())
    assert len(tm.blocks) == 32
    caches = TM.init_caches(cfg, 4, 2984, device="meta")
    kv = sum(c.k.numel() * c.k.element_size() * 2 for c in caches)
    assert kv == 32 * 2 * 4 * 2984 * 8 * 128 * 2  # 1.56 GB
