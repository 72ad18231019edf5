"""Checkpoints: atomic, resumable, restored onto any layout.

The port of the JAX package's ``train/checkpoint.py``, in its layout: a
``step_%08d`` directory a checkpoint, written as ``.tmp`` and renamed
(a failure mid-save never corrupts the latest one), holding ``.npy``
files and ``manifest.json``, which maps each leaf's path (dict keys,
sequence indices and named-tuple fields joined by ``/``) to its whole
shape, dtype and pieces, ``None`` leaves kept as ``null``; the newest 3
are kept. bf16 has no numpy dtype: a bf16 leaf is stored as its
``uint16`` view with ``"dtype": "bfloat16"`` in the manifest and viewed
back on restore.

A leaf held whole is one file (``"file"``), as the JAX package's
manifest has it. A model split over a ``(data, model)`` process mesh
(``model.layout``) saves its parameters and every leaf named after one
(the optimizer's moments, master copy and residual) cut as the
parameter is, in ``"pieces"``: ``{"file", "dim", "start", "length"}``,
a run of the whole leaf along ``dim``. Each rank of data rank 0 writes
its own runs of each cut leaf, model rank 0 also the runs held whole on
every rank (SSD's ``B`` and ``C``), and rank 0 each whole leaf; then,
after a barrier, rank 0 writes the manifest (with each parameter's
logical axes and segments), renames the directory and drops the oldest.
:func:`restore_checkpoint` assembles each leaf of the target's layout
from the pieces that cover it (memory mapped; a whole leaf is one
piece), so a checkpoint restores onto any layout, one process included:
the JAX package's re-meshing restore (``shardings=``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..dist.plan import Segments

_BF16 = "bfloat16"


def _items(tree) -> Optional[Tuple]:
    """(key, child) pairs of a container, or None for a leaf."""
    if isinstance(tree, dict):
        return tuple((str(k), v) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return tuple(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return tuple((str(i), v) for i, v in enumerate(tree))
    return None


def _flatten(tree, prefix: Tuple[str, ...] = ()) -> Dict[str, Any]:
    items = _items(tree)
    if items is None:
        return {"/".join(prefix): tree}
    out = {}
    for key, child in items:
        out.update(_flatten(child, prefix + (key,)))
    return out


def _unflatten(target, flat: Dict[str, Any],
               prefix: Tuple[str, ...] = ()):
    items = _items(target)
    if items is None:
        return flat["/".join(prefix)]
    children = [_unflatten(child, flat, prefix + (key,))
                for key, child in items]
    if isinstance(target, dict):
        return dict(zip(target.keys(), children))
    if hasattr(target, "_fields"):
        return type(target)(*children)
    return type(target)(children)


def _host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a numpy array; bf16 as its ``uint16`` view."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _dtype_name(dtype: torch.dtype) -> str:
    return _BF16 if dtype == torch.bfloat16 \
        else str(torch.empty((), dtype=dtype).numpy().dtype)


def _leaf_param(model, key: str) -> Optional[str]:
    """The parameter of ``model`` the leaf ``key`` is named after (its
    path's last part), or None."""
    name = key.rsplit("/", 1)[-1]
    return name if model is not None and name in model.specs() else None


def _runs(layout, name: str, model, shape) -> List[Tuple[int, int, int, bool]]:
    """Every model rank's runs of parameter ``name`` (of the whole
    ``shape``) under ``layout``: ``(model_rank, start, length, held
    whole)``, ``layout``'s ``model_rank`` replaced by each in turn."""
    seg = model.segments(name)
    out = []
    for m in range(layout.model):
        cut = model.param_cut(name, shape,
                              dataclasses.replace(layout, model_rank=m))
        flags = seg.split if seg is not None else (True,) * len(cut.pieces)
        out += [(m, s, n, not f) for (s, n), f in zip(cut.pieces, flags)]
    return out


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    model=None) -> str:
    """Atomically save a tree (dicts, lists, tuples, named tuples) of
    tensors and ``None``s; returns the checkpoint's directory. With
    ``model`` (its ``layout`` across a process mesh), every leaf named
    after one of its parameters is taken as this rank's cut of it, and
    every rank of the mesh must call this (the module docstring)."""
    layout = None if model is None else model.layout
    many = layout is not None and layout.data * layout.model > 1
    rank0 = not many or (layout.data_rank == 0 and layout.model_rank == 0)
    flat = _flatten(tree)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if rank0 and os.path.exists(tmp):
        shutil.rmtree(tmp)
    if many:
        dist.barrier()
    os.makedirs(tmp, exist_ok=True)
    manifest = {}
    for key, leaf in flat.items():
        if leaf is None:
            manifest[key] = None
            continue
        base = re.sub(r"[^A-Za-z0-9_.-]", "_", key)
        name = _leaf_param(model, key)
        cut = None if name is None else model.cut_of(name)
        if cut is None:
            entry = {"file": base + ".npy", "shape": list(leaf.shape),
                     "dtype": _dtype_name(leaf.dtype)}
            if rank0:
                np.save(os.path.join(tmp, base + ".npy"), _host(leaf))
        else:
            entry = {"shape": list(model.whole_shape(name)),
                     "dtype": _dtype_name(leaf.dtype), "pieces": []}
        if name is not None:
            seg = model.segments(name)
            entry["axes"] = list(model.specs()[name])
            entry["segments"] = None if seg is None else seg._asdict()
        manifest[key] = entry
        if cut is None:
            continue
        mine = {}
        at = 0
        for start, n in cut.pieces:
            mine[start] = at
            at += n
        for m, start, n, held in _runs(layout, name, model,
                                       entry["shape"]):
            if held and m > 0:
                continue
            fname = f"{base}@{cut.dim}.{start}.npy"
            entry["pieces"].append({"file": fname, "dim": cut.dim,
                                    "start": start, "length": n})
            if layout.data_rank == 0 and m == layout.model_rank:
                part = leaf.detach().narrow(cut.dim, mine[start], n)
                np.save(os.path.join(tmp, fname), _host(part))
    if many:
        dist.barrier()
    if rank0:
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "leaves": manifest}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        _gc(ckpt_dir, keep=3)
    if many:
        dist.barrier()
    return final


def _steps(ckpt_dir: str):
    return [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
            if d.startswith("step_") and not d.endswith(".tmp")]


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return max(steps) if steps else None


def _pieces(meta: Dict) -> List[Dict]:
    """A leaf's pieces; a leaf held whole (one file) is one whole
    piece."""
    return meta["pieces"] if "pieces" in meta \
        else [{"file": meta["file"], "dim": None}]


def _assemble(final: str, meta: Dict, cut) -> np.ndarray:
    """The runs of ``cut`` (None: the whole leaf) of a leaf joined from
    the pieces that cover them."""
    shape = tuple(meta["shape"])
    pieces = _pieces(meta)
    if cut is None and len(pieces) == 1 and pieces[0]["dim"] is None:
        return np.load(os.path.join(final, pieces[0]["file"]))
    dim = cut.dim if cut is not None else pieces[0]["dim"]
    want = cut.pieces if cut is not None else ((0, shape[dim]),)
    out_shape = list(shape)
    out_shape[dim] = sum(n for _, n in want)
    out, filled = None, 0
    local = 0
    for start, n in want:
        for p in pieces:
            pdim = p["dim"]
            ps, pn = (0, shape[dim]) if pdim is None \
                else (p["start"], p["length"])
            if pdim is not None and pdim != dim:
                raise ValueError(f"a piece cut along {pdim}, wanted along "
                                 f"{dim}")
            lo, hi = max(start, ps), min(start + n, ps + pn)
            if hi <= lo:
                continue
            src = np.load(os.path.join(final, p["file"]), mmap_mode="r")
            part = np.take(src, np.arange(lo - ps, hi - ps), axis=dim)
            if out is None:
                out = np.empty(out_shape, dtype=src.dtype)
            idx = [slice(None)] * len(shape)
            idx[dim] = slice(local + lo - start, local + hi - start)
            out[tuple(idx)] = part
            filled += hi - lo
        local += n
    if filled != out_shape[dim]:
        raise ValueError(f"the pieces cover {filled} of the {out_shape[dim]} "
                         f"entries wanted along dimension {dim}")
    return out


def restore_checkpoint(ckpt_dir: str, step: int, target: Any,
                       layout=None) -> Any:
    """Restore into the structure of ``target``, whose leaves are tensors
    (or ``meta`` tensors) giving each leaf's shape and device (``meta``
    restores to the CPU); each leaf keeps the dtype it was saved in.
    With ``layout`` (a ``dist.plan.ShardLayout``), each leaf saved with
    its logical axes is cut as ``layout`` cuts a parameter of those axes
    and assembled from the pieces that cover the cut, whatever layout
    saved it; without, every leaf is restored whole. A shape other than
    the target's raises ``ValueError``."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)["leaves"]
    restored = {}
    for key, spec in _flatten(target).items():
        meta = manifest.get(key)
        if meta is None or spec is None:
            restored[key] = None
            continue
        cut = None
        if layout is not None and "axes" in meta:
            seg = meta.get("segments")
            cut = layout.param_cut(meta["shape"], meta["axes"],
                                   None if seg is None else Segments(
                                       **{k: tuple(v)
                                          for k, v in seg.items()}))
        arr = _assemble(final, meta, cut)
        if meta["dtype"] == _BF16:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if tuple(t.shape) != tuple(spec.shape):
            raise ValueError(f"checkpoint leaf {key}: shape "
                             f"{tuple(t.shape)} != target "
                             f"{tuple(spec.shape)}")
        if spec.device.type != "meta":
            t = t.to(spec.device)
        restored[key] = t
    return _unflatten(target, restored)


def _gc(ckpt_dir: str, keep: int) -> None:
    for s in sorted(_steps(ckpt_dir))[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
