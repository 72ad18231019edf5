"""Checkpoints: atomic, resumable.

The port of the JAX package's ``train/checkpoint.py``, in its layout: a
``step_%08d`` directory a checkpoint, written as ``.tmp`` and renamed
(a failure mid-save never corrupts the latest one), holding an ``.npy``
file a leaf and ``manifest.json``, which maps each leaf's path (dict
keys, sequence indices and named-tuple fields joined by ``/``) to its
file, shape and dtype, ``None`` leaves kept as ``null``; the newest 3
are kept. bf16 has no numpy dtype: a bf16 leaf is stored as its
``uint16`` view with ``"dtype": "bfloat16"`` in the manifest and viewed
back on restore. The model runs on one card, so each checkpoint is one
process's whole state: the JAX package's shard layout and re-meshing
have no counterpart.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

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


def save_checkpoint(ckpt_dir: str, step: int, tree: Any) -> str:
    """Atomically save a tree (dicts, lists, tuples, named tuples) of
    tensors and ``None``s; returns the checkpoint's directory."""
    flat = _flatten(tree)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {}
    for key, leaf in flat.items():
        if leaf is None:
            manifest[key] = None
            continue
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            arr = t.view(torch.int16).numpy().view(np.uint16)
            dtype = _BF16
        else:
            arr = t.numpy()
            dtype = str(arr.dtype)
        fname = re.sub(r"[^A-Za-z0-9_.-]", "_", key) + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest[key] = {"file": fname, "shape": list(arr.shape),
                         "dtype": dtype}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "leaves": manifest}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _gc(ckpt_dir, keep=3)
    return final


def _steps(ckpt_dir: str):
    return [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
            if d.startswith("step_") and not d.endswith(".tmp")]


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, target: Any) -> Any:
    """Restore into the structure of ``target``, whose leaves are tensors
    (or ``meta`` tensors) giving each leaf's shape and device (``meta``
    restores to the CPU); each leaf keeps the dtype it was saved in. A
    shape other than the target's raises ``ValueError``."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)["leaves"]
    restored = {}
    for key, spec in _flatten(target).items():
        meta = manifest.get(key)
        if meta is None or spec is None:
            restored[key] = None
            continue
        arr = np.load(os.path.join(final, meta["file"]))
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
