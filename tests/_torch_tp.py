"""Shared helpers of the tests that serve a model split over gloo processes
on the CPU and hold it against the JAX package's unsharded forward.

A case is an arch's smoke config in f32 (every cache tensor in f32), with
fields of the config and of its MoE config replaced. Its weights are the
port's ``init_params`` from a seeded ``torch.Generator`` (and the same
arrays, unflattened, are ``repro``'s); its prompts come from numpy with a
seed (``_torch_lm.prompts``). The parent serves the prefill and
``STEPS`` greedy decode steps unsharded with the port (:func:`prepare`),
then with ``repro`` compiled, fed the same tokens, noting each MoE
layer's routing and ``dropped_frac`` (:func:`reference`), while the
ranks of each ``(data, model)`` process mesh (``tests/_torch_multiproc.py``)
load their slices of the weights with ``params_from_jax(layout=)`` and
serve their rows of the prompts fed those tokens, noting their MoE
layers' routing likewise. Weights, prompts and results travel as npz
through a temporary directory.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import model as RM
from repro_torch.models import model as TM

from _torch_lm import (B, F32_TOL, S, STEPS, configs, f32, f32_leaves,
                       f32_leaves_jax, load, prompts, to_flat)
from _torch_multiproc import collect, parse_result, spawn

F32 = dict(dtype="float32", param_dtype="float32")
JAMBA_TOL = dict(rtol=1e-3, atol=1e-3)
# a split's logits against the port's unsharded ones, normwise by step:
# the split sums its products in another order, and these random weights
# make attention sharp; the two differ by up to 3.4e-5 (whisper), as much
# as the port's unsharded forward differs from repro's (up to 6.8e-5,
# jamba)
OWN_NORM = 1e-4


def tol_of(arch):
    """f32 logits against ``repro``: 1e-4, jamba 1e-3 (``PERF.md`` §2)."""
    return JAMBA_TOL if arch.startswith("jamba") else F32_TOL


@dataclasses.dataclass(frozen=True)
class Case:
    """An arch's smoke config in f32 with ``cfg`` fields and ``moe``
    fields replaced (tuples of pairs), prompts of ``s`` positions served
    with caches of ``max_len``."""
    name: str
    arch: str
    cfg: tuple = ()
    moe: tuple = ()
    max_len: int = 64
    s: int = S

    def configs(self):
        cj, ct = configs(self.arch, **F32, **dict(self.cfg))
        if self.moe:
            cj = dataclasses.replace(cj, moe=dataclasses.replace(
                cj.moe, **dict(self.moe)))
            ct = dataclasses.replace(ct, moe=dataclasses.replace(
                ct.moe, **dict(self.moe)))
        return cj, ct


def jax_params(flat):
    """``repro``'s parameter dict of the flat f32 arrays: the pattern's
    leaves (``pattern.<name>``, stacked over periods) under ``pattern``."""
    params = {"pattern": {}}
    for k, v in flat.items():
        if k.startswith("pattern."):
            params["pattern"][k[len("pattern."):]] = jnp.asarray(v)
        else:
            params[k] = jnp.asarray(v)
    if not params["pattern"]:
        del params["pattern"]
    return params


def _routing_jax(params, cfg, name, x, moe, out):
    """``repro``'s MoE FFN, noting each token's experts (its own
    selection) and its ``dropped_frac`` into ``out``."""
    y, aux = moe(params, cfg, name, x)
    m = cfg.moe
    logits = (x.reshape(-1, x.shape[-1])
              @ params[f"{name}.router"]).astype(jnp.float32)
    if m.router == "sigmoid_bias":
        sel = jax.nn.sigmoid(logits) + params[
            f"{name}.router_bias"].astype(jnp.float32)[None]
    else:
        sel = jax.nn.softmax(logits, axis=-1)
    idx = jax.lax.top_k(sel, m.top_k)[1]
    jax.debug.callback(lambda i, d: out.append((np.asarray(i), float(d))),
                       idx, aux["dropped_frac"], ordered=True)
    return y, aux


def prepare(case: Case, root, seed=1):
    """The port's unsharded prefill and greedy steps of the whole batch:
    its logits (``own``, (STEPS + 1, B, vocab)), caches and tokens
    (``feed``, (B, STEPS)); the weights, prompts and tokens written to
    ``root/<name>.npz`` for the ranks."""
    cj, ct = case.configs()
    flat = to_flat(TM.init_params(torch.Generator().manual_seed(seed), ct,
                                  device="cpu"))
    tm = load(flat, ct)
    bj, bt = prompts(cj, s=case.s)
    cat = f32_leaves(TM.init_caches(ct, B, case.max_len, device="cpu"))
    lt, cat = TM.forward_prefill(tm, bt, cat)
    own, feed = [f32(lt)[:, -1]], []
    for i in range(STEPS):
        tok = torch.argmax(lt[:, -1], -1)[:, None].to(torch.int32)
        feed.append(tok.numpy())
        lt, cat = TM.forward_decode(tm, tok, case.s + i, cat)
        own.append(f32(lt)[:, -1])
    feed = np.concatenate(feed, axis=1)
    arrays = {"w." + k: v for k, v in flat.items()}
    arrays.update(tokens=bt["tokens"].numpy(), feed=feed)
    if "frames" in bt:
        arrays["frames"] = bt["frames"].float().numpy()
    np.savez(root / f"{case.name}.npz", **arrays)
    return dict(own=np.stack(own), caches=cat, feed=feed, flat=flat,
                batch=bj, cj=cj)


def reference(case: Case, ref):
    """``repro``'s prefill and steps (compiled) on ``ref``'s weights and
    prompts, fed its tokens: adds its logits (``jax``) and its MoE layers'
    routing (``routing``: (idx (B*s, k), dropped_frac) a layer call, in
    call order) to ``ref``."""
    cj = ref["cj"]
    params = jax_params(ref["flat"])
    routing = []
    moe = RM.moe_ffn
    RM.moe_ffn = functools.partial(_routing_jax, moe=moe, out=routing)
    try:
        prefill = jax.jit(lambda p, b, c: RM.forward_prefill(p, cj, b, c))
        decode = jax.jit(lambda p, t, pos, c: RM.forward_decode(
            p, cj, t, pos, c))
        caj = f32_leaves_jax(RM.init_caches(cj, B, case.max_len))
        lj, caj = prefill(params, ref["batch"], caj)
        exp = [f32(lj)[:, -1]]
        for i in range(STEPS):
            tok = jnp.asarray(ref["feed"][:, i:i + 1])
            lj, caj = decode(params, tok, jnp.int32(case.s + i), caj)
            exp.append(f32(lj)[:, -1])
        jax.effects_barrier()
    finally:
        RM.moe_ffn = moe
    ref["jax"], ref["routing"] = np.stack(exp), routing
    return ref


_CHILD = """
import dataclasses
from pathlib import Path

import numpy as np
import torch

from repro_torch import configs as TC
from repro_torch.launch.mesh import init_process_mesh, shutdown_process_mesh
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_jax

torch.set_num_threads(1)  # the ranks of every mesh share the machine
root = Path({root!r})
pm = init_process_mesh({data}, {model}, "gloo", "cpu", timeout_s=60)
routing = []
moe = TM.moe_ffn


def noted(*args, **kw):
    y, aux = moe(*args, **kw)
    routing.append((aux["idx"].numpy(), float(aux["dropped_frac"])))
    return y, aux


TM.moe_ffn = noted
layouts = {{}}
for name, arch, cfg_kw, moe_kw, max_len, s in {cases!r}:
    routing.clear()
    z = np.load(root / f"{{name}}.npz")
    cfg = dataclasses.replace(TC.get_smoke_config(arch), dtype="float32",
                              param_dtype="float32", **dict(cfg_kw))
    if moe_kw:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, **dict(moe_kw)))
    lay = pm.layout(cfg, {b})
    layouts[name] = dict(split=sorted(lay.split), kv_seq=lay.kv_seq,
                         whole=sorted(lay.whole))
    flat = {{k[2:]: z[k] for k in z.files if k.startswith("w.")}}
    model = params_from_jax(flat, cfg, device="cpu", layout=lay)
    batch = {{"tokens": torch.from_numpy(z["tokens"])}}
    if "frames" in z.files:
        batch["frames"] = torch.from_numpy(z["frames"]).bfloat16()
    caches = TM.Caches(None if c is None else type(c)(*(
        t.float() if isinstance(t, torch.Tensor) else t for t in c))
        for c in TM.init_caches(cfg, {b}, max_len, "cpu", lay))
    logits, caches = TM.forward_prefill(model, lay.batch(batch), caches)
    out = [logits[:, -1].float()]
    feed = torch.from_numpy(z["feed"])[lay.rows({b})]
    for i in range({steps}):
        logits, caches = TM.forward_decode(model, feed[:, i:i + 1],
                                           s + i, caches)
        out.append(logits[:, -1].float())
    arrays = {{f"c{{i}}.{{f}}": t.float().numpy()
              for i, c in enumerate(caches) if c is not None
              for f, t in c._asdict().items()
              if isinstance(t, torch.Tensor)}}
    arrays.update({{f"idx{{j}}": i for j, (i, _) in enumerate(routing)}})
    np.savez(root / f"{{name}}-{tag}-rank{{pm.rank}}.npz",
             logits=torch.stack(out).numpy(),
             dropped=np.array([d for _, d in routing]), **arrays)
shutdown_process_mesh(pm)
emit({{"rank": pm.rank, "coords": list(pm.coords), "layouts": layouts}})
"""


def tag(mesh):
    return f"d{mesh[0]}m{mesh[1]}"


def start_meshes(root, cases_by_mesh):
    """Start each mesh's ranks serving its cases, every mesh at once."""
    started = {}
    for mesh, cases in cases_by_mesh.items():
        spec = [(c.name, c.arch, c.cfg, c.moe, c.max_len, c.s)
                for c in cases]
        code = _CHILD.format(root=str(root), data=mesh[0], model=mesh[1],
                             cases=spec, b=B, steps=STEPS, tag=tag(mesh))
        started[mesh] = spawn(code, mesh[0] * mesh[1], init_timeout=60)
    return started


def finish_meshes(started, timeout=150):
    """Each rank's emitted result, by mesh; every rank must exit 0."""
    got = {}
    for mesh, procs in started.items():
        outs = collect(procs, timeout=timeout)
        for r, (rc, out) in enumerate(outs):
            assert rc == 0, f"{mesh} rank {r} failed (rc={rc}):\n" \
                f"{out[-4000:]}"
        got[mesh] = [parse_result(out) for _, out in outs]
    return got


def serve_all(root, cases, meshes):
    """Every case prepared, the meshes' ranks started, ``repro``'s
    reference of every case while they run: (refs by case name, the
    ranks' results by mesh)."""
    refs = {c.name: prepare(c, root) for c in cases}
    started = start_meshes(root, meshes)
    try:
        for c in cases:
            reference(c, refs[c.name])
    finally:
        runs = finish_meshes(started)
    return refs, runs


def rank_arrays(root, name, mesh):
    return [np.load(root / f"{name}-{tag(mesh)}-rank{r}.npz")
            for r in range(mesh[0] * mesh[1])]


def check_logits_and_routing(case: Case, ref, ranks, mesh):
    """Every rank's logits within the case's tolerance of ``repro``'s for
    its rows and within ``OWN_NORM`` normwise of the port's unsharded
    ones, equal bit for bit across
    its model group; the tokens fed ``repro``'s greedy ones; each MoE
    layer call's experts for its rows ``repro``'s, the same on every rank
    of the group, and its ``dropped_frac`` ``repro``'s (global) one."""
    data, model = mesh
    rows = B // data
    assert np.array_equal(np.argmax(ref["jax"][:-1], -1).T, ref["feed"])
    for r, z in enumerate(ranks):
        d, _ = divmod(r, model)
        at = slice(d * rows, (d + 1) * rows)
        lead = ranks[d * model]
        np.testing.assert_array_equal(z["logits"], lead["logits"])
        np.testing.assert_allclose(z["logits"], ref["jax"][:, at],
                                   **tol_of(case.arch),
                                   err_msg=f"{case.name} {mesh} rank {r}")
        for step, (g, o) in enumerate(zip(z["logits"], ref["own"][:, at])):
            assert np.linalg.norm(g - o) <= OWN_NORM * np.linalg.norm(o), \
                (case.name, mesh, r, step)
        assert np.array_equal(np.argmax(z["logits"][:-1], -1).T,
                              ref["feed"][at])
        got = [z[f"idx{j}"] for j in range(len(z["dropped"]))]
        assert len(got) == len(ref["routing"])
        for j, (gi, (ei, ed)) in enumerate(zip(got, ref["routing"])):
            n = ei.shape[0] // B
            np.testing.assert_array_equal(gi, ei[d * rows * n:
                                                 (d + 1) * rows * n])
            np.testing.assert_array_equal(gi, lead[f"idx{j}"])
            assert abs(z["dropped"][j] - ed) <= 1e-7, (case.name, r, j)


def join_caches(ranks, mesh, layout, unsharded):
    """Each block's cache of every rank joined into the unsharded
    layout: the model ranks' kv heads (where split), positions (under
    ``kv_seq``), SSD heads and ``x`` channels, equal parts checked equal;
    the data ranks' rows. Returns ``{"c{i}.{field}": array}`` beside the
    unsharded caches' arrays."""
    data, model = mesh
    split = set(layout["split"])
    ssd = {"mlp", "heads"} <= split
    got, exp = {}, {}
    for i, c in enumerate(unsharded):
        if c is None:
            continue
        for field, t in c._asdict().items():
            if not isinstance(t, torch.Tensor):
                continue
            key = f"c{i}.{field}"
            exp[key] = t.float().numpy()
            by_data = []
            for d in range(data):
                group = [ranks[d * model + m][key] for m in range(model)]
                if field in ("k", "v") and layout["kv_seq"]:
                    by_data.append(np.concatenate(group, axis=1)[
                        :, :exp[key].shape[1]])
                elif field in ("k", "v") and "kv_heads" in split:
                    by_data.append(np.concatenate(group, axis=2))
                elif field == "state" and ssd:
                    by_data.append(np.concatenate(group, axis=1))
                elif field == "conv" and ssd:
                    # each rank: its x channels, then all of B and C
                    n_x = (exp[key].shape[-1] - group[0].shape[-1]) \
                        // (model - 1)
                    for g in group[1:]:
                        np.testing.assert_array_equal(g[..., n_x:],
                                                      group[0][..., n_x:])
                    by_data.append(np.concatenate(
                        [g[..., :n_x] for g in group]
                        + [group[0][..., n_x:]], axis=-1))
                else:
                    for g in group[1:]:
                        np.testing.assert_array_equal(g, group[0])
                    by_data.append(group[0])
            got[key] = np.concatenate(by_data, axis=0)
    return got, exp
