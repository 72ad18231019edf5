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
import pytest
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


def prompts(cfg, seed=0, s=S):
    """(JAX batch, torch batch): ``s`` positions, the VLM's patches first;
    the encoder-decoder's frames (B, enc_seq, 128) after the tokens."""
    rng = np.random.default_rng(seed)
    nv = cfg.n_patches if cfg.frontend == "vision" else 0
    toks = rng.integers(0, cfg.vocab, (B, s - nv)).astype(np.int32)
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


def to_flat(model, tensors=None) -> dict:
    """The inverse of ``params_from_jax``: the model's weights (or
    ``tensors``, keyed by its parameter names: its gradients) as f32
    arrays under the JAX package's flat names."""
    cfg = model.cfg
    n_pre, n_pat = len(cfg.prefix_layers), len(cfg.pattern)
    flat, stacked = {}, {}
    if tensors is None:
        tensors = model.state_dict()
    for key, t in tensors.items():
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


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def train_batches(cfg, seed=0):
    """(JAX batch, torch batch) for ``forward_train``: tokens and their
    next-token labels over S positions (the VLM's patches first, in bf16;
    the encoder-decoder's frames in bf16), the first 3 labels of row 0
    masked (-100)."""
    rng = np.random.default_rng(seed)
    nv = cfg.n_patches if cfg.frontend == "vision" else 0
    toks = rng.integers(0, cfg.vocab, (B, S - nv + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -100
    arrays = {"tokens": toks[:, :-1], "labels": labels}
    if nv:
        arrays["patches"] = rng.normal(0, 1, (B, nv, 1024)).astype(
            np.float32)
    if cfg.is_encdec:
        arrays["frames"] = rng.normal(0, 1, (B, cfg.enc_seq, 128)).astype(
            np.float32)
    bf16 = ("patches", "frames")
    bj = {k: jnp.asarray(v, jnp.bfloat16 if k in bf16 else None)
          for k, v in arrays.items()}
    bt = {k: torch.from_numpy(v).to(torch.bfloat16) if k in bf16
          else torch.from_numpy(v) for k, v in arrays.items()}
    return bj, bt


def jax_loss_and_grads(cj, params, bj, eager=False):
    """``jax.value_and_grad`` of the JAX package's ``forward_train``:
    ((loss, metrics), grads); compiled, or op by op with ``eager``."""
    fn = jax.value_and_grad(lambda p: RM.forward_train(p, cj, bj),
                            has_aux=True)
    if eager:
        with jax.disable_jit():
            return fn(params)
    return jax.jit(fn)(params)


def port_loss_and_grads(tm, bt):
    """(loss, metrics, every gradient as f32 arrays under the JAX
    package's flat names, zeros where autograd gave none) of the port's
    ``forward_train``."""
    tm.requires_grad_(True)
    tm.zero_grad(set_to_none=True)
    loss, metrics = TM.forward_train(tm, bt)
    loss.backward()
    grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
             for k, p in tm.named_parameters()}
    return loss.detach(), metrics, to_flat(tm, grads)


def normwise(got: dict, exp: dict) -> float:
    """||got - exp|| / ||exp|| over every leaf of ``exp``."""
    num = sum(float(np.sum((got[k] - exp[k]) ** 2)) for k in exp)
    den = sum(float(np.sum(exp[k] ** 2)) for k in exp)
    return (num / den) ** 0.5


F32_TRAIN = dict(dtype="float32", param_dtype="float32")
GRAD_F32 = 1e-3
GRAD_F32_LOOSE = {"jamba-v0.1-52b": 4e-3, "whisper-base": 4e-3}
BF16_LOSS_RTOL = 1e-3
BF16_GLOBAL = 0.15
BF16_LEAF = 0.5
# the routed archs op by op (deepseek-v3, jamba): routing near-ties
BF16_GLOBAL_ROUTED = 0.3


def check_bf16(arch, eager=False, loss_rtol=BF16_LOSS_RTOL,
               global_tol=BF16_GLOBAL, leaf_tol=BF16_LEAF):
    """The loss and gradients of ``arch``'s own (bf16) smoke config,
    port against reference (compiled, or op by op with ``eager``): the
    loss within ``loss_rtol``, the gradients normwise within
    ``global_tol`` over all leaves and ``leaf_tol`` over each."""
    cj, ct, m, tm = both_models(arch)
    assert cj.dtype == cj.param_dtype == "bfloat16"
    bj, bt = train_batches(cj)
    (lj, _), gj = jax_loss_and_grads(cj, m.params, bj, eager=eager)
    lt, _, gt = port_loss_and_grads(tm, bt)
    gj = jax_flat(gj)
    leaf = {k: normwise({k: gt[k]}, {k: v}) for k, v in gj.items()
            if np.any(v)}
    total = normwise(gt, gj)
    worst = max(leaf, key=leaf.get)
    print(f"{arch} bf16 ({'op by op' if eager else 'compiled'}): loss "
          f"{float(lt):.6f} / {float(lj):.6f}, gradients {total:.4f} over "
          f"all leaves, worst leaf {worst} {leaf[worst]:.4f}")
    np.testing.assert_allclose(float(lt), float(lj), rtol=loss_rtol)
    assert total <= global_tol, (arch, total)
    assert leaf[worst] <= leaf_tol, (arch, worst, leaf[worst])


def check_f32(arch):
    """``forward_train``'s loss, metrics and every gradient of ``arch``'s
    smoke config in f32, port against reference (compiled)."""
    cj, ct, m, tm = both_models(arch, **F32_TRAIN)
    bj, bt = train_batches(cj)
    (lj, mj), gj = jax_loss_and_grads(cj, m.params, bj)
    lt, mt, gt = port_loss_and_grads(tm, bt)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    assert float(mt["loss"].detach()) == pytest.approx(float(mj["loss"]),
                                                       rel=1e-5)
    assert int(mt["tokens"]) == int(mj["tokens"])
    assert ("mtp" in mt) == ("mtp" in mj) == cj.mtp
    gj = jax_flat(gj)
    assert set(gt) == set(gj)
    tol = GRAD_F32_LOOSE.get(arch, GRAD_F32)
    for k, exp in gj.items():
        scale = float(np.abs(exp).max())
        np.testing.assert_allclose(gt[k], exp, rtol=0, atol=tol * scale,
                                   err_msg=f"{arch} gradient of {k}")
