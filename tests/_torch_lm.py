"""Shared helpers of the LM tests: the JAX package's models and the port's
on the same weights and prompts, on the CPU, at smoke size.

Weights come from ``repro``'s ``init_params(jax.random.key(1), cfg)``
through ``params_from_jax``; prompts (and the encoder-decoder's frames)
from numpy with a seed. Each JAX model is built once per config.
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as RC
from repro.models import model as RM
from repro_torch import configs as TC
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_jax

F32_TOL = dict(rtol=1e-4, atol=1e-4)
ROUNDED_CACHE_TOL = dict(rtol=1e-4, atol=2e-2)  # f32, bf16 or int8 cache
BF16_TOL = dict(rtol=0.08, atol=0.15)
B, S, MAX_LEN, STEPS = 2, 24, 64, 4


def jax_flat(params) -> dict:
    """``init_params(...).params`` as ``params_from_jax`` takes it."""
    flat = {}
    for k, v in params.items():
        if k == "pattern":
            flat.update({f"pattern.{kk}": np.asarray(vv.astype(jnp.float32))
                         for kk, vv in v.items()})
        else:
            flat[k] = np.asarray(v.astype(jnp.float32))
    return flat


def load(flat, cfg):
    """``params_from_jax`` on the CPU."""
    return params_from_jax(flat, cfg, device="cpu")


def configs(arch, **kw):
    return (dataclasses.replace(RC.get_smoke_config(arch), **kw),
            dataclasses.replace(TC.get_smoke_config(arch), **kw))


@functools.lru_cache(maxsize=None)
def jax_model(cj):
    """The JAX package's model of ``cj`` with ``key(1)``, built once. Its
    builder draws each tensor in f32 and casts it, so a bf16 model is the
    f32 model's weights cast to bf16."""
    if cj.param_dtype == "bfloat16":
        m = jax_model(dataclasses.replace(cj, param_dtype="float32"))
        return m._replace(params=jax.tree.map(
            lambda a: a.astype(jnp.bfloat16), m.params))
    return RM.init_params(jax.random.key(1), cj)


def both_models(arch, **kw):
    """(JAX config, port config, JAX model, the port's model on its
    weights)."""
    cj, ct = configs(arch, **kw)
    m = jax_model(cj)
    return cj, ct, m, load(jax_flat(m.params), ct)


def prompts(cfg, seed=0):
    """(JAX batch, torch batch): S positions, the VLM's patches first; the
    encoder-decoder's frames (B, enc_seq, 128) after the tokens."""
    rng = np.random.default_rng(seed)
    nv = cfg.n_patches if cfg.frontend == "vision" else 0
    toks = rng.integers(0, cfg.vocab, (B, S - nv)).astype(np.int32)
    bj, bt = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if nv:
        p = rng.normal(0, 1, (B, nv, 1024)).astype(np.float32)
        bj["patches"] = jnp.asarray(p, jnp.bfloat16)
        bt["patches"] = torch.from_numpy(p).to(torch.bfloat16)
    if cfg.is_encdec:
        f = rng.normal(0, 1, (B, cfg.enc_seq, 128)).astype(np.float32)
        bj["frames"] = jnp.asarray(f, jnp.bfloat16)
        bt["frames"] = torch.from_numpy(f).to(torch.bfloat16)
    return bj, bt


def f32(a) -> np.ndarray:
    return np.asarray(a.astype(jnp.float32)) if isinstance(a, jax.Array) \
        else a.float().numpy()


def f32_leaves_jax(caches):
    """Every floating leaf of the JAX package's caches in f32."""
    return jax.tree.map(lambda a: a.astype(jnp.float32)
                        if jnp.issubdtype(a.dtype, jnp.floating) else a,
                        caches)


def f32_leaves(caches):
    """Every floating tensor of the port's caches in f32."""
    def one(c):
        if c is None:
            return None
        return type(c)(*(t.float() if isinstance(t, torch.Tensor)
                         and t.is_floating_point() else t for t in c))
    return TM.Caches(one(c) for c in caches)


def serve_both(arch, tol, f32_caches=False, eager=False, check=None, **kw):
    """Prefill, then STEPS greedy decode steps on both packages (each fed
    the JAX package's token); every step's logits held at ``tol``. With
    ``f32_caches`` every floating cache leaf is f32 on both sides; with
    ``eager`` the JAX functions run op by op (``jax.disable_jit``: its
    ``lax.scan`` over the periods a Python loop, as the port runs them,
    where XLA would compile the scan's body and fuse its bf16 steps).
    ``check(got, exp, err_msg)`` replaces the comparison at ``tol``.
    Returns the largest |logit difference| of each step."""
    cj, ct, m, tm = both_models(arch, **kw)
    bj, bt = prompts(cj)
    caj = RM.init_caches(cj, B, MAX_LEN)
    cat = TM.init_caches(ct, B, MAX_LEN, device="cpu")
    if f32_caches:
        caj, cat = f32_leaves_jax(caj), f32_leaves(cat)
    mode = jax.disable_jit if eager else contextlib.nullcontext
    with mode():
        lj, caj = RM.forward_prefill(m.params, cj, bj, caj)
    lt, cat = TM.forward_prefill(tm, bt, cat)
    worst = []
    for i in range(STEPS + 1):
        assert lt.shape == lj.shape == (B, 1, cj.vocab)
        if check is None:
            np.testing.assert_allclose(f32(lt), f32(lj), **tol,
                                       err_msg=f"{arch} step {i}")
        else:
            check(f32(lt), f32(lj), f"{arch} step {i}")
        worst.append(float(np.abs(f32(lt) - f32(lj)).max()))
        if i == STEPS:
            break
        tok = jnp.argmax(lj[:, -1], -1)[:, None].astype(jnp.int32)
        with mode():
            lj, caj = RM.forward_decode(m.params, cj, tok, S + i, caj)
        lt, cat = TM.forward_decode(tm, torch.from_numpy(np.array(tok)),
                                    S + i, cat)
    print(f"{arch} {kw} f32_caches={f32_caches} eager={eager}: largest |logit "
          f"difference| by step {worst}")
    return worst


def to_flat(model) -> dict:
    """The inverse of ``params_from_jax``: the model's weights as f32
    arrays under the JAX package's flat names."""
    cfg = model.cfg
    n_pre, n_pat = len(cfg.prefix_layers), len(cfg.pattern)
    flat, stacked = {}, {}
    for key, t in model.state_dict().items():
        v = t.float().numpy()
        if not key.startswith("blocks."):
            flat[key] = v
            continue
        _, i, rest = key.split(".", 2)
        if int(i) < n_pre:
            flat[f"prefix.{i}.{rest}"] = v
        else:
            p, slot = divmod(int(i) - n_pre, n_pat)
            stacked.setdefault(f"pattern.slot{slot}.{rest}", {})[p] = v
    for name, by_period in stacked.items():
        flat[name] = np.stack([by_period[p] for p in range(cfg.n_periods)])
    return flat
