"""Tensor-parallel serving of the dense GQA archs across processes on the
CPU, held against the JAX package's unsharded forward and the port's own.

For each of the five dense GQA archs' smoke configs, in f32 (every cache
tensor in f32) and in bf16, the parent runs ``repro``'s prefill and 4
greedy decode steps and the port's unsharded forward on the same weights
(``repro``'s ``init_params(key(1))``) and prompts. Then ranks of a
``(data, model)`` process mesh over gloo (``tests/_torch_multiproc.py``:
one run a mesh, every arch in it, under a hard timeout), each with its
slice of the weights from ``params_from_jax(layout=)`` and its rows of
the prompts, run the prefill and the 4 steps fed ``repro``'s tokens.
Weights, prompts and results travel as npz through ``tmp_path``.

Limits: f32 logits within 1e-4 of ``repro`` and of the port's unsharded
forward of the same requests, and normwise within 1e-5 of the latter
(``OWN_TOL``); bf16 within rtol 0.08, atol 0.15 of ``repro``; every
rank of a model group holds the same logits bit for bit; greedy tokens
equal ``repro``'s (in bf16 where its top-2 margin exceeds the limit);
the ranks' caches, joined by kv heads and rows, equal the unsharded
caches as the f32 logits do.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as RM
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import model as TM

from _torch_lm import (B, BF16_TOL, F32_TOL, MAX_LEN, S, STEPS, configs, f32,
                       f32_leaves, f32_leaves_jax, jax_flat, jax_model, load,
                       prompts)
from _torch_multiproc import SRC, collect, parse_result, spawn

DENSE = ("llama3-8b", "gemma-7b", "nemotron-4-15b", "command-r-plus-104b",
         "llava-next-mistral-7b")
MESHES = ((1, 2), (1, 4), (2, 2))
DTYPES = {"f32": dict(dtype="float32", param_dtype="float32"), "bf16": {}}
# f32 against the port's unsharded forward of the same requests: normwise
# (a step's logits). Element by element the two differ by up to 2e-5 at
# logits of 4 (the split products round in another order, and these
# random weights make attention sharp), as much as the port and repro
# differ unsharded; held there within F32_TOL.
OWN_TOL = 1e-5

_CHILD = """
import dataclasses
from pathlib import Path

import numpy as np
import torch

from repro_torch import configs as TC
from repro_torch.launch.mesh import init_process_mesh, shutdown_process_mesh
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_jax

torch.set_num_threads(1)  # ten ranks share the machine's cores
root = Path({root!r})
pm = init_process_mesh({data}, {model}, "gloo", "cpu", timeout_s=60)
split = {{}}
for arch in {archs!r}:
    for dt, kw in {dtypes!r}.items():
        z = np.load(root / f"{{arch}}-{{dt}}.npz")
        cfg = dataclasses.replace(TC.get_smoke_config(arch), **kw)
        lay = pm.layout(cfg, {b})
        split[arch] = sorted(lay.split)
        flat = {{k[2:]: z[k] for k in z.files if k.startswith("w.")}}
        model = params_from_jax(flat, cfg, device="cpu", layout=lay)
        batch = {{"tokens": torch.from_numpy(z["tokens"])}}
        if "patches" in z.files:
            batch["patches"] = torch.from_numpy(z["patches"]).bfloat16()
        caches = TM.init_caches(cfg, {b}, {max_len}, "cpu", lay)
        if dt == "f32":
            caches = TM.Caches(type(c)(*(t.float() if isinstance(
                t, torch.Tensor) else t for t in c)) for c in caches)
        logits, caches = TM.forward_prefill(model, lay.batch(batch), caches)
        out = [logits[:, -1].float()]
        feed = torch.from_numpy(z["feed"])[lay.rows({b})]
        for i in range({steps}):
            logits, caches = TM.forward_decode(model, feed[:, i:i + 1],
                                               {s} + i, caches)
            out.append(logits[:, -1].float())
        kv = {{f"{{n}}{{i}}": getattr(c, n).float().numpy()
              for i, c in enumerate(caches) for n in ("k", "v")}}
        np.savez(root / f"{{arch}}-{{dt}}-{tag}-rank{{pm.rank}}.npz",
                 logits=torch.stack(out).numpy(), **kv)
shutdown_process_mesh(pm)
emit({{"rank": pm.rank, "coords": list(pm.coords), "split": split}})
"""


@functools.lru_cache(maxsize=None)
def _jitted(cfg):
    """repro's prefill and decode step of ``cfg``, each compiled once."""
    prefill = jax.jit(lambda p, b, c: RM.forward_prefill(p, cfg, b, c))
    decode = jax.jit(lambda p, t, pos, c: RM.forward_decode(p, cfg, t, pos,
                                                            c))
    return prefill, decode


def _tag(mesh):
    return f"d{mesh[0]}m{mesh[1]}"


def _port_unsharded(tm, ct, bt, feed, rows, f32_caches):
    """The port's unsharded prefill and steps over the requests ``rows``,
    fed ``feed``: (logits of each step, the caches)."""
    cat = TM.init_caches(ct, rows.stop - rows.start, MAX_LEN, device="cpu")
    if f32_caches:
        cat = f32_leaves(cat)
    lt, cat = TM.forward_prefill(tm, {k: v[rows] for k, v in bt.items()},
                                 cat)
    out = [f32(lt)[:, -1]]
    for i in range(STEPS):
        lt, cat = TM.forward_decode(tm, torch.tensor(feed[rows, i:i + 1]),
                                    S + i, cat)
        out.append(f32(lt)[:, -1])
    return np.stack(out), cat


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """Per (arch, dtype): repro's logits of the prefill and each step and
    its greedy tokens; in f32, the port's unsharded logits and caches
    (the requests of each data rank of 1 and 2 served on their own). The
    weights, prompts and tokens are written for the ranks."""
    root = tmp_path_factory.mktemp("tp_serve")
    out = {}
    for arch in DENSE:
        for dt, kw in DTYPES.items():
            cj, ct = configs(arch, **kw)
            m = jax_model(cj)
            flat = jax_flat(m.params)
            bj, bt = prompts(cj)
            caj = RM.init_caches(cj, B, MAX_LEN)
            if dt == "f32":
                caj = f32_leaves_jax(caj)
            prefill, decode = _jitted(cj)
            lj, caj = prefill(m.params, bj, caj)
            exp, feed = [f32(lj)[:, -1]], []
            for i in range(STEPS):
                tok = jnp.argmax(lj[:, -1], -1)[:, None].astype(jnp.int32)
                feed.append(np.asarray(tok))
                lj, caj = decode(m.params, tok, jnp.int32(S + i), caj)
                exp.append(f32(lj)[:, -1])
            arrays = {"w." + k: v for k, v in flat.items()}
            arrays["tokens"] = bt["tokens"].numpy()
            if "patches" in bt:
                arrays["patches"] = bt["patches"].float().numpy()
            arrays["feed"] = feed = np.concatenate(feed, axis=1)
            np.savez(root / f"{arch}-{dt}.npz", **arrays)
            ref = out[arch, dt] = dict(jax=np.stack(exp), feed=feed)
            if dt != "f32":
                continue
            tm = load(flat, ct)
            for data in (1, 2):
                n = B // data
                parts = [_port_unsharded(tm, ct, bt, feed,
                                         slice(d * n, (d + 1) * n), True)
                         for d in range(data)]
                ref["own", data] = np.concatenate([p[0] for p in parts],
                                                  axis=1)
                ref["caches", data] = [
                    tuple(np.concatenate([getattr(p[1][i], n).float().numpy()
                                          for p in parts])
                          for n in ("k", "v"))
                    for i in range(len(parts[0][1]))]
    return root, out


@pytest.fixture(scope="module")
def runs(refs):
    """Each mesh's ranks, all three meshes at once; each rank's result."""
    root, _ = refs
    started = {}
    for mesh in MESHES:
        code = _CHILD.format(root=str(root), data=mesh[0], model=mesh[1],
                             archs=DENSE, dtypes=DTYPES, b=B,
                             max_len=MAX_LEN, steps=STEPS, s=S,
                             tag=_tag(mesh))
        started[mesh] = spawn(code, mesh[0] * mesh[1], init_timeout=60)
    got = {}
    for mesh, procs in started.items():
        outs = collect(procs, timeout=150)
        for r, (rc, out) in enumerate(outs):
            assert rc == 0, f"{mesh} rank {r} failed (rc={rc}):\n" \
                f"{out[-4000:]}"
        got[mesh] = [parse_result(out) for _, out in outs]
    return got


def _rank_arrays(root, arch, dt, mesh):
    return [np.load(root / f"{arch}-{dt}-{_tag(mesh)}-rank{r}.npz")
            for r in range(mesh[0] * mesh[1])]


def _margin_clear(exp, tol):
    top2 = np.sort(exp, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) > tol["atol"] \
        + tol["rtol"] * np.abs(top2[..., 1])


@pytest.mark.parametrize("mesh", MESHES, ids=_tag)
@pytest.mark.parametrize("arch", DENSE)
def test_sharded_serving_equals_unsharded(refs, runs, arch, mesh):
    root, ref = refs
    data, model = mesh
    rows = B // data
    for r, res in enumerate(runs[mesh]):
        assert res["rank"] == r and tuple(res["coords"]) == divmod(r, model)
    for dt in DTYPES:
        want = ref[arch, dt]
        ranks = _rank_arrays(root, arch, dt, mesh)
        for r, z in enumerate(ranks):
            d, m = divmod(r, model)
            at = slice(d * rows, (d + 1) * rows)
            got, exp = z["logits"], want["jax"][:, at]
            # the logits are gathered: every rank of the group holds them
            np.testing.assert_array_equal(got, ranks[d * model]["logits"])
            tol = F32_TOL if dt == "f32" else BF16_TOL
            np.testing.assert_allclose(got, exp, **tol,
                                       err_msg=f"{arch} {dt} rank {r}")
            toks = np.argmax(got, axis=-1)
            clear = np.ones(toks.shape, bool) if dt == "f32" \
                else _margin_clear(exp, tol)
            want_toks = np.argmax(exp, axis=-1)
            assert np.array_equal(toks[clear], want_toks[clear]), (dt, r)
            assert np.array_equal(want_toks[:-1].T, want["feed"][at])
            if dt == "f32":
                own = want["own", data][:, at]
                np.testing.assert_allclose(got, own, **F32_TOL)
                for step, (g, o) in enumerate(zip(got, own)):
                    assert np.linalg.norm(g - o) <= OWN_TOL * \
                        np.linalg.norm(o), (arch, r, step)


@pytest.mark.parametrize("mesh", MESHES, ids=_tag)
@pytest.mark.parametrize("arch", DENSE)
def test_sharded_caches_join_to_unsharded(refs, runs, arch, mesh):
    """Each block's k and v, joined over the model ranks' kv heads (where
    the layout splits them) and the data ranks' rows, equal the
    unsharded caches of the same requests (f32 run): within F32_TOL
    element by element and
    OWN_TOL normwise, as the logits (the second block's keys are made
    from the first block's summed output)."""
    root, ref = refs
    data, model = mesh
    ranks = _rank_arrays(root, arch, "f32", mesh)
    split = runs[mesh][0]["split"][arch]
    for i, (k_exp, v_exp) in enumerate(ref[arch, "f32"]["caches", data]):
        for name, exp in (("k", k_exp), ("v", v_exp)):
            by_data = []
            for d in range(data):
                group = [ranks[d * model + m][f"{name}{i}"]
                         for m in range(model)]
                if "kv_heads" in split:
                    by_data.append(np.concatenate(group, axis=2))
                else:
                    for g in group[1:]:
                        np.testing.assert_array_equal(g, group[0])
                    by_data.append(group[0])
            got = np.concatenate(by_data, axis=0)
            np.testing.assert_allclose(got, exp, **F32_TOL,
                                       err_msg=f"{name}{i}")
            assert np.linalg.norm(got - exp) <= OWN_TOL * np.linalg.norm(
                exp), f"{name}{i}"


def test_demoted_axes_in_the_runs(runs):
    """The runs split what the audit keeps: on four model ranks
    command-r-smoke's mixer and llama3-smoke's kv heads stay whole."""
    four = runs[(1, 4)][0]["split"]
    assert "heads" not in four["command-r-plus-104b"]
    assert "kv_heads" not in four["command-r-plus-104b"]
    assert "heads" in four["llama3-8b"] and "kv_heads" not in four[
        "llama3-8b"]
    assert {"heads", "kv_heads", "mlp", "vocab"} <= set(
        runs[(1, 2)][0]["split"]["gemma-7b"])


def test_serve_launcher_across_two_processes():
    """``python -m repro_torch.launch.serve --mesh data=1,model=2
    --dist-backend gloo``, one process a rank (``launch.mesh.run_ranks``):
    rank 0 prints the run and the mesh, rank 1 nothing of it, and the
    greedy tokens are the single-process run's."""
    argv = ["-m", "repro_torch.launch.serve", "--device", "cpu", "--arch",
            "llama3-8b", "--batch", "2", "--prompt-len", "16", "--gen", "4"]
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    (rc, one), = run_ranks(argv, 1, timeout_s=120, env=env)
    assert rc == 0, one
    two = run_ranks(argv + ["--mesh", "data=1,model=2", "--dist-backend",
                            "gloo"], 2, timeout_s=120, env=env)
    for r, (rc, out) in enumerate(two):
        assert rc == 0, f"rank {r}:\n{out[-3000:]}"
    assert "mesh data=1 model=2 backend=gloo" in two[0][1]
    assert "sample token ids" not in two[1][1]

    def tokens(out):
        return [ln for ln in out.splitlines() if ln.startswith("sample")]

    assert tokens(two[0][1]) == tokens(one) != []
