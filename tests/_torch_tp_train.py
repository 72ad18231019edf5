"""Shared helpers of the tests that train a model split over gloo processes
on the CPU, held against the JAX package's unsharded
``jax.value_and_grad`` and against the port's own unsplit run.

A case is an arch's smoke config in f32 with fields of its MoE config
replaced, a batch of ``B`` rows of ``s`` positions from numpy with a seed
(``_torch_lm.train_batches``: row 0's first 3 labels masked, so that the
data ranks count different labels) and weights from a seeded
``torch.Generator`` (the same arrays, unflattened, are ``repro``'s).

:func:`run_case` is what every process runs on each case, unsplit in the
parent and split on each rank (four ``tests/_torch_multiproc.py``
processes joined in a ``(2, 2)`` ``ProcessMesh``, whose model groups
are also ``(1, 2)`` meshes and whose data groups ``(2, 1)`` meshes, each
taking every other case of its mesh): one ``make_train_step`` step (AdamW, lr 1e-3, a
constant schedule) noting each MoE layer call's routing and each
gradient as autograd left it and as the step's exchange completed it,
then AdamW with ``compress_grads=True`` on those gradients. The parent
computes its references while the ranks run; arrays travel as npz
through a temporary directory.

This module imports no JAX at the top: the ranks import it too.
"""
import dataclasses
import functools
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch import configs as TC
from repro_torch.dist.plan import CUT, grad_classes, shard_layout
from repro_torch.models import model as TM
from repro_torch.train import step as TS
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                        init_opt_state)

from _torch_multiproc import collect, parse_result, spawn

B = 2
LR = 1e-3
F32 = dict(dtype="float32", param_dtype="float32")
# the limits of PERF.md section 2: against repro, f32 loss within rtol
# 1e-5 and each gradient within 1e-3 of its leaf's largest |value|;
# against the port's own unsplit run, each leaf normwise within 1e-4
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-3
OWN_NORM = 1e-4
# The smoke models at their random init are ill-conditioned: a relative
# 1e-7 change of every weight (an ulp) moves the unsplit f32 gradients by
# 1.5e-4 normwise (llama3-8b's worst leaf) to 1.8e-3 (llava's
# vis_proj1), and the split's other order of sums moves them likewise.
# Measured split against unsplit, worst leaf: jamba 7.2e-4, deepseek-v3
# 3.6e-4, whisper 3.3e-4, llava 1.9e-4, the others under 7.4e-5. These
# four are held at about three times their measure (jamba's and
# whisper's gradients against repro are held at 4e-3 for the same
# reason: _torch_lm.GRAD_F32_LOOSE)
OWN_NORM_LOOSE = {"jamba-v0.1-52b": 2e-3, "deepseek-v3-671b": 1e-3,
                  "whisper-base": 1e-3, "llava-next-mistral-7b": 6e-4}
# a parameter after one AdamW step moves by about lr x the sign of its
# gradient, so a gradient within rounding of zero may move it by 2 x lr
# the other way (chip_smoke.py's TRAIN_STEP_ATOL)
STEP_ATOL = 2 * LR
OPT = AdamWConfig(lr=LR)
OPT_INT8 = dataclasses.replace(OPT, compress_grads=True)


@dataclasses.dataclass(frozen=True)
class Case:
    """An arch's smoke config in f32 with ``moe`` fields replaced (pairs),
    trained on ``B`` rows of ``s`` positions."""
    name: str
    arch: str
    moe: tuple = ()
    s: int = 24

    def config(self, package=TC):
        cfg = dataclasses.replace(package.get_smoke_config(self.arch), **F32)
        if self.moe:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, **dict(self.moe)))
        return cfg


class DuckMesh:
    """A ``("data", "model")`` mesh as ``dist.plan`` reads one."""
    axis_names = ("data", "model")

    def __init__(self, data, model):
        self.shape = {"data": data, "model": model}


def tag(mesh):
    return f"d{mesh[0]}m{mesh[1]}"


def batch_arrays(cfg, s, seed=0) -> Dict[str, np.ndarray]:
    """``_torch_lm.train_batches``' arrays for ``B`` rows of ``s``
    positions (patches and frames f32; the ranks take them to bf16)."""
    rng = np.random.default_rng(seed)
    nv = cfg.n_patches if cfg.frontend == "vision" else 0
    toks = rng.integers(0, cfg.vocab, (B, s - nv + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -100
    arrays = {"tokens": toks[:, :-1], "labels": labels}
    if nv:
        arrays["patches"] = rng.normal(0, 1, (B, nv, 1024)).astype(
            np.float32)
    if cfg.is_encdec:
        arrays["frames"] = rng.normal(0, 1, (B, cfg.enc_seq, 128)).astype(
            np.float32)
    return arrays


def torch_batch(arrays, rows=None) -> Dict[str, torch.Tensor]:
    rows = slice(None) if rows is None else rows
    return {k: torch.from_numpy(np.ascontiguousarray(v[rows])).to(
        torch.bfloat16) if k in ("patches", "frames")
        else torch.from_numpy(np.ascontiguousarray(v[rows]))
        for k, v in arrays.items()}


def _arrays(prefix, tree) -> Dict[str, np.ndarray]:
    return {f"{prefix}.{k}": v.detach().float().numpy()
            for k, v in tree.items()}


def run_case(load, cfg, batch) -> Dict[str, np.ndarray]:
    """What a process computes of a case (the module docstring): ``load()``
    gives a fresh model (a rank's slice), ``batch`` its rows. One
    ``make_train_step`` step, then AdamW with ``compress_grads`` on the
    same gradients from the same start (what a compressed step would
    take). Returns the arrays: ``loss`` (the global batch's), ``gnorm``,
    ``gnorm_int8``, each MoE layer call's ``idx{j}`` and ``dropped`` in
    the forward, and ``raw.*`` (each gradient as autograd left it),
    ``grad.*`` (as the step's exchange completed it), ``param.*``,
    ``mu.*``, ``nu.*`` (after the step) and ``err.*`` (the int8
    residual) by parameter name."""
    routing, noted = [], {}
    moe, exchange = TM.moe_ffn, TS.exchange_grads

    def noting_moe(*args, **kw):
        y, aux = moe(*args, **kw)
        routing.append((aux["idx"].numpy(), float(aux["dropped_frac"])))
        return y, aux

    def noting_exchange(grads, classes, layout):
        noted["raw"] = {k: g.clone() for k, g in grads.items()}
        exchange(grads, classes, layout)
        noted["grad"] = {k: g.clone() for k, g in grads.items()}

    TM.moe_ffn, TS.exchange_grads = noting_moe, noting_exchange
    try:
        model = load()
        params = dict(model.named_parameters())
        start = {k: p.detach().clone() for k, p in params.items()}
        state = init_opt_state(params, OPT)
        _, state, m = TS.make_train_step(cfg, OPT, schedule="constant")(
            model, state, batch)
    finally:
        TM.moe_ffn, TS.exchange_grads = moe, exchange
    # the forward's calls (remat calls each MoE layer again in backward)
    route = routing[:sum(f == "moe" for _, f in cfg.layer_specs)]
    out = {"loss": np.float64(m["loss"]), "gnorm": np.float64(m["grad_norm"]),
           "dropped": np.array([d for _, d in route])}
    out.update({f"idx{j}": i for j, (i, _) in enumerate(route)})
    out.update(_arrays("raw", noted["raw"]))
    out.update(_arrays("grad", noted["grad"]))
    out.update(_arrays("param", params))
    out.update(_arrays("mu", state.mu))
    out.update(_arrays("nu", state.nu))
    layout = model.layout
    int8 = init_opt_state(start, OPT_INT8)
    _, int8, m8 = adamw_update(
        start, noted["grad"], int8, OPT_INT8, torch.ones(()),
        grad_classes(model) if layout is not None else None, layout)
    out["gnorm_int8"] = np.float64(m8["grad_norm"])
    out.update(_arrays("err", int8.error))
    return out


_CHILD = """
from pathlib import Path

import numpy as np
import torch

from repro_torch.launch.mesh import (ProcessMesh, init_process_mesh,
                                     shutdown_process_mesh)
from repro_torch.models.convert import params_from_jax
from repro_torch.train.step import train_rows

from _torch_tp_train import B, Case, run_case, torch_batch, tag

torch.set_num_threads(1)  # the ranks share the machine with other tests
root = Path({root!r})
pm = init_process_mesh(2, 2, "gloo", "cpu", timeout_s=300)
d, m = pm.coords
# each model group is a (1, 2) mesh and each data group a (2, 1) mesh: the
# cases of those meshes go to them in turns, after the (2, 2) cases
views = {{(2, 2): (pm, None),
          (1, 2): (ProcessMesh(1, 2, m, pm.device, pm.backend,
                               pm.model_group, None), d),
          (2, 1): (ProcessMesh(2, 1, d, pm.device, pm.backend, None,
                               pm.data_group), m)}}
layouts = {{}}
for mesh, specs in {jobs!r}:
    view, turn = views[tuple(mesh)]
    for i, spec in enumerate(specs):
        if turn is not None and i % 2 != turn:
            continue
        case = Case(*spec)
        cfg = case.config()
        z = np.load(root / f"{{case.name}}.npz")
        lay = view.layout(cfg, B, "train")
        layouts[case.name] = sorted(lay.split)
        flat = {{k[2:]: z[k] for k in z.files if k.startswith("w.")}}
        rows = train_rows(lay, B)
        batch = torch_batch({{k: z[k] for k in z.files
                             if not k.startswith("w.")}}, rows)
        out = run_case(lambda: params_from_jax(flat, cfg, device="cpu",
                                               layout=lay), cfg, batch)
        np.savez(root / f"{{case.name}}-{{tag(tuple(mesh))}}-rank"
                 f"{{view.rank}}.npz", rows=rows, **out)
shutdown_process_mesh(pm)
emit({{"rank": pm.rank, "coords": list(pm.coords), "layouts": layouts}})
"""


def start_ranks(root, cases_by_mesh):
    """Start the four ranks of a ``(2, 2)`` mesh whose groups also serve
    as the ``(1, 2)`` and ``(2, 1)`` meshes, on each mesh's cases."""
    jobs = [(list(mesh), [(c.name, c.arch, c.moe, c.s) for c in cases])
            for mesh, cases in sorted(cases_by_mesh.items(),
                                      key=lambda kv: kv[0] != (2, 2))]
    return spawn(_CHILD.format(root=str(root), jobs=jobs), 4,
                 init_timeout=60)


def finish_ranks(procs, timeout=300):
    """Each rank's emitted result; every rank must exit 0."""
    outs = collect(procs, timeout=timeout)
    for r, (rc, out) in enumerate(outs):
        assert rc == 0, f"rank {r} failed (rc={rc}):\n{out[-4000:]}"
    return [parse_result(out) for _, out in outs]


def prepare(case: Case, root, seed=1):
    """The case's weights and batch written to ``root/<name>.npz`` for
    the ranks; returns them with the port's unsplit :func:`run_case`."""
    from _torch_lm import to_flat
    from repro_torch.models.convert import params_from_jax
    cfg = case.config()
    flat = to_flat(TM.init_params(torch.Generator().manual_seed(seed), cfg,
                                  device="cpu"))
    arrays = batch_arrays(cfg, case.s)
    np.savez(root / f"{case.name}.npz", **arrays,
             **{"w." + k: v for k, v in flat.items()})
    return dict(flat=flat, arrays=arrays, cfg=cfg)


def own(ref):
    """The port's unsplit run of a prepared case."""
    from repro_torch.models.convert import params_from_jax
    cfg = ref["cfg"]
    ref["own"] = run_case(lambda: params_from_jax(ref["flat"], cfg,
                                                  device="cpu"),
                          cfg, torch_batch(ref["arrays"]))
    return ref


def reference(case: Case, ref):
    """``repro``'s unsharded ``jax.value_and_grad`` of ``forward_train``
    (compiled) on the case's weights and batch, and its MoE layers'
    routing of a forward: adds ``jax_loss``, ``jax_grads`` (flat names)
    and ``routing`` ((idx (B*s, k), dropped_frac) a layer call)."""
    import functools

    import jax
    import jax.numpy as jnp

    from repro.models import model as RM
    from _torch_lm import jax_flat, jax_loss_and_grads
    from _torch_tp import _routing_jax, jax_params

    from repro import configs as RC
    cj = case.config(RC)
    params = jax_params(ref["flat"])
    bj = {k: jnp.asarray(v, jnp.bfloat16 if k in ("patches", "frames")
                         else None) for k, v in ref["arrays"].items()}
    (loss, _), grads = jax_loss_and_grads(cj, params, bj)
    routing = []
    moe = RM.moe_ffn
    RM.moe_ffn = functools.partial(_routing_jax, moe=moe, out=routing)
    try:
        jax.jit(lambda p: RM.forward_train(p, cj, bj)[0])(params)
        jax.effects_barrier()
    finally:
        RM.moe_ffn = moe
    ref.update(jax_loss=float(loss), jax_grads=jax_flat(grads),
               routing=routing)
    return ref


def train_all(root, cases, meshes, against_repro=()):
    """Every case prepared, the ranks started (:func:`start_ranks`), the
    port's unsplit run of every case and ``repro``'s reference of those
    named in ``against_repro`` while they run: (refs by case name, the
    ranks' results)."""
    refs = {c.name: prepare(c, root) for c in cases}
    started = start_ranks(root, meshes)
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))  # beside the ranks
    try:
        for c in cases:
            own(refs[c.name])
            if c.name in against_repro:
                reference(c, refs[c.name])
    finally:
        torch.set_num_threads(threads)
        runs = finish_ranks(started)
    return refs, runs


@functools.lru_cache(maxsize=None)
def _load(path) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def rank_arrays(root, name, mesh):
    """Each rank's arrays of case ``name`` on ``mesh``, read once."""
    return [_load(root / f"{name}-{tag(mesh)}-rank{r}.npz")
            for r in range(mesh[0] * mesh[1])]


@functools.lru_cache(maxsize=None)
def rank_models(case: Case, mesh):
    """Each rank's abstract model (its layout and cuts), by rank."""
    cfg = case.config()
    return tuple(TM.abstract_params(cfg, layout=shard_layout(
        cfg, DuckMesh(*mesh), r, B, "train")) for r in range(mesh[0] *
                                                             mesh[1]))


@functools.lru_cache(maxsize=None)
def _classes(model):
    return grad_classes(model)


def join(ranks, models, mesh, prefix, data_rank=0) -> Dict[str, np.ndarray]:
    """The ``prefix.*`` arrays of data rank ``data_rank``'s model group
    joined into whole parameters: each rank's runs of a cut one put in
    place (a run held whole on every rank taken from the group's first
    rank), a whole one the first rank's."""
    _, model = mesh
    group = range(data_rank * model, (data_rank + 1) * model)
    classes = {r: _classes(models[r]) for r in group}
    out = {}
    for name in models[0].specs():
        first = group[0]
        if classes[first][name].kind != CUT:
            out[name] = ranks[first][f"{prefix}.{name}"]
            continue
        whole = np.zeros(models[0].whole_shape(name),
                         ranks[first][f"{prefix}.{name}"].dtype)
        for r in group:
            c = classes[r][name]
            arr = ranks[r][f"{prefix}.{name}"]
            for (start, n), (at, _, held) in zip(c.cut.pieces, c.runs):
                if held and r != first:
                    continue
                dst = [slice(None)] * whole.ndim
                dst[c.cut.dim] = slice(start, start + n)
                whole[tuple(dst)] = run_slice(arr, c.cut.dim, at, n)
        out[name] = whole
    return out


def held_whole(models, rank) -> Dict[str, List[Tuple[int, int, int]]]:
    """Parameter name -> the local runs ``(dim, start, length)`` of rank
    ``rank``'s slice that every rank of its model group holds whole."""
    out = {}
    for name, c in _classes(models[rank]).items():
        if c.kind != CUT:
            out[name] = [(0, 0, None)]
        elif c.whole_runs:
            out[name] = [(c.cut.dim, s, n) for s, n in c.whole_runs]
    return out


def run_slice(arr, dim, start, n):
    if n is None:
        return arr
    idx = [slice(None)] * arr.ndim
    idx[dim] = slice(start, start + n)
    return arr[tuple(idx)]


def normwise(got, exp) -> float:
    den = float(np.linalg.norm(exp))
    return float(np.linalg.norm(got - exp)) / (den if den else 1.0)


def to_jax_names(cfg, tensors: Dict[str, np.ndarray]) -> Dict:
    """Arrays by the port's parameter names under the JAX package's flat
    names (``_torch_lm.to_flat`` of arrays)."""
    import types

    from _torch_lm import to_flat
    return to_flat(types.SimpleNamespace(cfg=cfg),
                   {k: torch.from_numpy(v) for k, v in tensors.items()})


def rows_of(mesh, data_rank) -> slice:
    n = B // mesh[0]
    return slice(data_rank * n, (data_rank + 1) * n)


def own_limit(arch) -> float:
    return OWN_NORM_LOOSE.get(arch, OWN_NORM)


def check_routing(got_ranks, exp_routing, mesh, what):
    """Each rank's MoE layer calls: its rows' experts equal to
    ``exp_routing``'s (repro's, or the port's unsplit run's) and the same
    on every rank of its model group; ``dropped_frac`` equal."""
    data, model = mesh
    for r, z in enumerate(got_ranks):
        d = r // model
        n = len(z["dropped"])
        assert n == len(exp_routing), (what, r, n, len(exp_routing))
        for j, (ei, ed) in enumerate(exp_routing):
            per = ei.shape[0] // B
            at = rows_of(mesh, d)
            np.testing.assert_array_equal(
                z[f"idx{j}"], ei[at.start * per: at.stop * per],
                err_msg=f"{what} rank {r} MoE call {j}")
            np.testing.assert_array_equal(
                z[f"idx{j}"], got_ranks[d * model][f"idx{j}"])
            assert abs(float(z["dropped"][j]) - ed) <= 1e-7, \
                (what, r, j, float(z["dropped"][j]), ed)


def own_routing(ref) -> List[Tuple[np.ndarray, float]]:
    z = ref["own"]
    return [(z[f"idx{j}"], float(z["dropped"][j]))
            for j in range(len(z["dropped"]))]
