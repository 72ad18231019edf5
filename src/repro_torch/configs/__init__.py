"""Architecture registry + assigned input shapes.

Every assigned architecture is selectable as ``--arch <id>``; each pairs
with the LM shape set (train_4k / prefill_32k / decode_32k / long_500k).
``long_500k`` runs only for sub-quadratic archs (ssm/hybrid).

The port of the JAX package's ``configs/``. ``repro_torch.models`` serves
all ten archs. :func:`input_specs` gives a cell's inputs as tensors on
the ``meta`` device, the stand-ins the dry run (``launch.dryrun``) runs
a step on, where the JAX package gives ``ShapeDtypeStruct``s.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

import torch

from ..models.config import ModelConfig

_MODULES = {
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "llama3-8b": "llama3_8b",
    "command-r-plus-104b": "command_r_plus_104b",
    "gemma-7b": "gemma_7b",
    "nemotron-4-15b": "nemotron_4_15b",
    "mamba2-780m": "mamba2_780m",
    "whisper-base": "whisper_base",
}

ARCH_IDS = list(_MODULES)

# assigned input shapes: name -> (seq_len, global_batch, kind)
SHAPES: Dict[str, Tuple[int, int, str]] = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}

# archs with sub-quadratic sequence mixing (long_500k eligible)
SUBQUADRATIC = {"jamba-v0.1-52b", "mamba2-780m"}


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f".{_MODULES[arch]}", __package__)
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f".{_MODULES[arch]}", __package__)
    return mod.SMOKE


def cell_is_applicable(arch: str, shape: str) -> Tuple[bool, str]:
    """(runnable, reason-if-skipped) for an (arch x shape) cell."""
    if shape == "long_500k" and arch not in SUBQUADRATIC:
        return False, "full-attention arch: O(S^2) at 500k (DESIGN.md §5 skip)"
    return True, ""


def shape_overrides(cfg: ModelConfig, shape: str) -> ModelConfig:
    """Per-shape config adjustments (documented in EXPERIMENTS.md)."""
    if shape == "long_500k":
        # shard the (few) attention KV caches over the model axis
        cfg = dataclasses.replace(cfg, decode_kv_shard="seq")
    if shape in ("decode_32k",) and cfg.mla is None and cfg.ssm is None:
        # dense GQA 32k cache at batch 128: int8 cache keeps HBM in budget
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    return cfg


def input_specs(cfg: ModelConfig, shape: str,
                batch_override: Optional[int] = None, device="meta",
                seq_override: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Every model input of the given shape, as the JAX package's
    ``input_specs`` names, shapes and types them: empty tensors on
    ``device`` (``meta``: shapes and dtypes alone), zeros elsewhere.
    ``seq_override`` replaces the shape's positions (a dry run of another
    length: the VLM's text is what its patches leave)."""
    seq, gbatch, kind = SHAPES[shape]
    seq = seq_override or seq
    b = batch_override or gbatch
    make = torch.empty if torch.device(device).type == "meta" else torch.zeros

    def spec(shp, dtype):
        return make(shp, dtype=dtype, device=device)

    if kind == "decode":
        # one new token against a seq_len cache
        return {"token": spec((b, 1), torch.int32)}
    text = seq - (cfg.n_patches if cfg.frontend == "vision" else 0)
    out = {"tokens": spec((b, text), torch.int32)}
    if kind == "train":
        out["labels"] = spec((b, text), torch.int32)
    if cfg.frontend == "vision":
        out["patches"] = spec((b, cfg.n_patches, 1024), torch.bfloat16)
    if cfg.is_encdec:
        out["frames"] = spec((b, cfg.enc_seq, 128), torch.bfloat16)
    return out
