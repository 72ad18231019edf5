"""The port's encoder-decoder pieces against the JAX package's, on the
CPU: GQA cross-attention (``kv_x``) and bidirectional attention,
``_encode``, and whisper served whole.

Tolerances, from the measured gaps:

* ``gqa_forward`` in f32: ``rtol=1e-4, atol=5e-4`` (outputs up to 20,
  largest gap 1.2e-4); in bf16 ``rtol=0.02, atol=0.02``;
* ``_encode`` on whisper's smoke weights: f32 ``rtol=1e-4, atol=1e-4``
  (largest gap 1.1e-5); bf16 bit-identical;
* whisper's logits as the dense archs' (f32 ``1e-4`` with every cache in
  f32, ``rtol=1e-4, atol=2e-2`` with its own, bf16 ``rtol=0.08,
  atol=0.15``), the bf16 case against the reference run op by op
  (``jax.disable_jit``): there the port's logits are within 8e-6 of it,
  where the compiled reference's scan over the decoder layers fuses bf16
  steps and differs from its own op-by-op form by up to 0.19.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as RA
from repro.models import model as RM
from repro_torch import configs as TC
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models.layers import ParamBuilder

from _torch_lm import (B, BF16_TOL, F32_TOL, ROUNDED_CACHE_TOL, both_models,
                       configs, jax_flat, jax_model, load, prompts,
                       serve_both, to_flat)

F32 = dict(dtype="float32", param_dtype="float32")


def f32(a):
    return np.asarray(a.astype(jnp.float32)) if isinstance(a, jax.Array) \
        else a.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["cross", "bidir", "bidir-norope"])
def test_gqa_cross_and_bidirectional_match_repro(kind, dtype):
    """Cross-attention over 37 encoder states (no rope, no mask); and
    bidirectional self-attention (``causal=False``) with and without
    rope, over 3 key chunks."""
    cj, ct = configs("whisper-base", dtype=dtype, param_dtype=dtype,
                     n_kv_heads=2)
    dt = getattr(torch, dtype)
    jdt = jnp.float32 if dt == torch.float32 else jnp.bfloat16
    p = TA.GQA(ParamBuilder(None, dt, "meta"), ct)
    rng = np.random.default_rng(4)
    state, flat = {}, {}
    for k, t in p.state_dict().items():
        v = (rng.normal(size=tuple(t.shape)) / np.sqrt(t.shape[-2])).astype(
            np.float32)
        state[k], flat[f"x.{k}"] = torch.from_numpy(v).to(dt), \
            jnp.asarray(v, jdt)
    p.load_state_dict(state, assign=True)
    x = rng.normal(size=(2, 70, cj.d_model)).astype(np.float32)
    enc = rng.normal(size=(2, 37, cj.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(70)[None], (2, 70)).copy()
    kw = {"cross": dict(kv_x=enc, use_rope=False),
          "bidir": dict(causal=False),
          "bidir-norope": dict(causal=False, use_rope=False)}[kind]
    jkw = {k: (jnp.asarray(v, jdt) if k == "kv_x" else v)
           for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(v).to(dt) if k == "kv_x" else v)
           for k, v in kw.items()}
    oj, cj_ = RA.gqa_forward(flat, cj, "x", jnp.asarray(x, jdt),
                             jnp.asarray(pos), **jkw)
    ot, ct_ = TA.gqa_forward(p, ct, torch.from_numpy(x).to(dt),
                             torch.from_numpy(pos), **tkw)
    assert cj_ is None and ct_ is None and ot.dtype == dt
    tol = dict(rtol=1e-4, atol=5e-4) if dt == torch.float32 else \
        dict(rtol=0.02, atol=0.02)
    np.testing.assert_allclose(f32(ot), f32(oj), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_repro(dtype):
    """The encoder (frame projection, learned positions, bidirectional
    blocks with rope, final norm) on whisper's smoke weights."""
    cj, ct, m, tm = both_models("whisper-base", dtype=dtype,
                                param_dtype=dtype)
    bj, bt = prompts(cj)
    ej = RM._encode(m.params, cj, bj["frames"])
    et = TM._encode(tm, bt["frames"])
    assert et.shape == ej.shape == (B, cj.enc_seq, cj.d_model)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(f32(et), f32(ej))
    else:
        np.testing.assert_allclose(f32(et), f32(ej), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", ["f32", "f32 own-caches", "bf16"])
def test_whisper_prefill_decode_match_repro(case):
    if case == "f32":
        serve_both("whisper-base", F32_TOL, f32_caches=True, **F32)
    elif case == "f32 own-caches":
        serve_both("whisper-base", ROUNDED_CACHE_TOL, **F32)
    else:
        serve_both("whisper-base", BF16_TOL, eager=True)


def test_decode_reads_the_prefills_encoding():
    """The prefill leaves the encoder's output on the caches, and each
    decode step attends to it (other frames give other logits)."""
    cj, ct, m, tm = both_models("whisper-base", **F32)
    _, bt = prompts(cj)
    caches = TM.init_caches(ct, B, 32, device="cpu")
    assert caches.enc_out is None
    logits, caches = TM.forward_prefill(tm, bt, caches)
    np.testing.assert_allclose(caches.enc_out.numpy(),
                               TM._encode(tm, bt["frames"]).numpy(),
                               rtol=0, atol=0)
    tok = logits[:, -1].argmax(-1)[:, None].to(torch.int32)
    kv = [c.k.clone() for c in caches]
    l1, c1 = TM.forward_decode(tm, tok, 24, caches)
    assert c1.enc_out is caches.enc_out
    other = TM.Caches(caches)
    other.enc_out = caches.enc_out + 1
    for c, k in zip(caches, kv):  # undo the first step's cache writes
        c.k.copy_(k)
    l2, _ = TM.forward_decode(tm, tok, 24, other)
    assert not torch.allclose(l1, l2)


def test_params_from_jax_round_trip():
    cj, ct = configs("whisper-base")
    flat = jax_flat(jax_model(cj).params)
    tm = load(flat, ct)
    back = to_flat(tm)
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    assert {"aud_proj", "enc_pos", "enc_norm.w", "enc.1.attn.wq",
            "pattern.slot0.xattn.wo"} <= set(flat)
    np.testing.assert_array_equal(tm.enc[1].attn.wq.float().numpy(),
                                  flat["enc.1.attn.wq"])
    with pytest.raises(ValueError, match="no parameter"):
        load(dict(flat, **{"enc.2.attn.wq": flat["enc.1.attn.wq"]}), ct)
    with pytest.raises(ValueError, match="shape"):
        load(dict(flat, enc_pos=flat["enc_pos"][:8]), ct)


def test_full_width_whisper_on_meta():
    """whisper-base whole: 97.2 M parameters by param_count, plus the
    frame projection, the encoder's positions, the decoder's positions
    at max_len 104 and the norms' biases it leaves out; the decoder's KV
    caches at batch 4."""
    cfg = TC.get_config("whisper-base")
    tm = TM.abstract_params(cfg, max_positions=104)
    n = sum(p.numel() for p in tm.parameters())
    d = cfg.d_model
    norms = (2 * cfg.n_enc_layers + 3 * cfg.n_layers + 2) * 2 * d \
        - 2 * d * (cfg.n_enc_layers + cfg.n_layers)
    assert cfg.param_count() == 97_162_240
    assert n == cfg.param_count() + 128 * d + 1500 * d + 104 * d + norms
    assert len(tm.enc) == 6 and len(tm.blocks) == 6
    assert all(b.xattn is not None for b in tm.blocks)
    assert all(b.xattn is None for b in tm.enc)
    caches = TM.init_caches(cfg, 4, 104, device="meta")
    assert all(c.k.shape == (4, 104, 8, 64) for c in caches)
