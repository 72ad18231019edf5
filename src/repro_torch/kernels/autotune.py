"""Launch-size autotuning for the CUDA decode kernels.

The counterpart of the JAX package's ``kernels/autotune.py``, in the
port's terms: where the Pallas kernels have a tile size per grid, the
CUDA kernels have a launch size. Every knob of :class:`LaunchConfig` is a
choice the kernels made as a constant before: the exit, stream and store
kernels' block sizes (``csrc/huffman.cu``), the store kernel's writer of
whole units, the thread groups of the IDCT and pixel kernels' blocks
(``csrc/geometry.cuh`` ``launch_groups``) and the sync loops' rounds
between host checks (``core.sync.RoundBlocks``). The defaults are those
constants. A small measured search over a fixed candidate set, keyed by
``(PlanShape, backend, fuse, device kind)``, picks per bucket:

* resolution order: the ``REPRO_TORCH_LAUNCH`` override (parsed and
  validated loudly) > in-memory cache > persistent table
  (``REPRO_TORCH_LAUNCH_TABLE``, default ``~/.cache/repro_torch/
  launch.json``) > measured search (only when a ``measure`` callable is
  supplied: the decoder wires one up under ``REPRO_TORCH_AUTOTUNE=1``) >
  the defaults. On ``backend="torch"`` (the plain versions, no launch)
  the call returns the defaults and never measures.

* the chosen :class:`LaunchConfig` is **part of the program key**
  (``core/api.decode_program``), so a bucket tunes at most once, and a
  CUDA graph captured under one config never replays under another: the
  config's programs are its own.

* every candidate, not just the winner, is covered by the kernel
  verifier (``python -m repro_torch.analysis kernels``: the launch
  geometry of every candidate on every ladder rung on the host, and the
  checked build of every kernel under every candidate on the card), so a
  bad launch choice is a failed check, not a silent wrong result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import tempfile
from typing import Callable, Dict, List, Optional

LAUNCH_ENV = "REPRO_TORCH_LAUNCH"
AUTOTUNE_ENV = "REPRO_TORCH_AUTOTUNE"
TABLE_ENV = "REPRO_TORCH_LAUNCH_TABLE"

STORE_WRITERS = ("auto", "lane", "warp")
# the C kernels' rt::StoreWriter values
WRITER_CODES = {"auto": 0, "lane": 1, "warp": 2}
MAX_GROUPS = 48      # csrc/geometry.cuh kMaxGroups
MAX_BLOCK_ROUNDS = 64


@dataclasses.dataclass(frozen=True)
class LaunchConfig:
    """One point of the launch search space (hashable: it rides in the
    program key)."""

    exit_threads: int = 256     # exit kernel block size
    stream_threads: int = 1024  # stream kernel block size
    store_threads: int = 256    # store kernel block size
    store_writer: str = "auto"  # whole units: by lane count, lane, warp
    pixel_groups: int = 0       # pixel kernel groups a block (0: default)
    idct_groups: int = 0        # IDCT kernel groups a block (0: default)
    block_rounds: int = 4       # sync rounds between host checks

    def label(self) -> str:
        return (f"e{self.exit_threads}:s{self.stream_threads}"
                f":t{self.store_threads}{self.store_writer[0]}"
                f":p{self.pixel_groups}:i{self.idct_groups}"
                f":r{self.block_rounds}")


DEFAULT_LAUNCH = LaunchConfig()

#: Per-knob candidate values. The search varies one knob at a time from
#: the default (the knobs bound independent kernels, so the space is a
#: star, not a cross product). The block sizes are those the kernels are
#: instantiated for (``csrc/geometry.cuh``); the store kernel stops at 256
#: because its unit slots take 264 bytes a thread (135 KB at 512).
LAUNCH_CANDIDATES: Dict[str, tuple] = {
    "exit_threads": (128, 256, 512),
    "stream_threads": (256, 512, 1024),
    "store_threads": (128, 256),
    "store_writer": STORE_WRITERS,
    "pixel_groups": (0, 12, 24),
    "idct_groups": (0, 12, 24),
    "block_rounds": (2, 4, 8),
}

_FIELD_ALIASES = {
    "exit": "exit_threads", "exit_threads": "exit_threads",
    "stream": "stream_threads", "stream_threads": "stream_threads",
    "store": "store_threads", "store_threads": "store_threads",
    "writer": "store_writer", "store_writer": "store_writer",
    "pixels": "pixel_groups", "pixel_groups": "pixel_groups",
    "idct": "idct_groups", "idct_groups": "idct_groups",
    "rounds": "block_rounds", "block_rounds": "block_rounds",
}
_THREAD_KNOBS = ("exit_threads", "stream_threads", "store_threads")


def check_launch(name: str, value):
    """Loud validation of one knob (the parse-time half of the launch
    contract; the C entry points refuse the same values with
    cudaErrorInvalidValue, and the verifier checks each candidate's
    geometry)."""
    if name not in LAUNCH_CANDIDATES:
        raise ValueError(f"unknown launch knob {name!r}; expected one of "
                         f"{sorted(LAUNCH_CANDIDATES)}")
    if name == "store_writer":
        if value not in STORE_WRITERS:
            raise ValueError(f"store_writer must be one of {STORE_WRITERS}, "
                             f"got {value!r}")
        return value
    if not isinstance(value, int) or isinstance(value, bool):
        raise ValueError(f"launch knob {name} must be an int, got {value!r}")
    if name in _THREAD_KNOBS and value not in LAUNCH_CANDIDATES[name]:
        raise ValueError(
            f"{name}={value}: the kernel is instantiated for block sizes "
            f"{LAUNCH_CANDIDATES[name]} only")
    if name in ("pixel_groups", "idct_groups") and value != 0 and (
            not 0 < value <= MAX_GROUPS or value % 4):
        raise ValueError(
            f"{name}={value}: 0 (the default) or a multiple of 4 in "
            f"4..{MAX_GROUPS} (groups of 8 threads filling whole warps); "
            f"the launch also needs it a multiple of the units per MCU")
    if name == "block_rounds" and not 1 <= value <= MAX_BLOCK_ROUNDS:
        raise ValueError(f"block_rounds={value} out of range "
                         f"(1..{MAX_BLOCK_ROUNDS})")
    return value


def candidate_configs(base: LaunchConfig = DEFAULT_LAUNCH
                      ) -> List[LaunchConfig]:
    """The measured-search candidate set: the base config plus every
    single-knob variation. Deduplicated, base first."""
    out = [base]
    for field, values in LAUNCH_CANDIDATES.items():
        for v in values:
            cand = dataclasses.replace(base, **{field: v})
            if cand not in out:
                out.append(cand)
    return out


def parse_launch_override(text: str) -> LaunchConfig:
    """Parse ``REPRO_TORCH_LAUNCH``: ``"exit=128,stream=512,writer=lane"``
    (unnamed knobs keep their defaults). Junk raises with the accepted
    grammar: a silently ignored override is a mistuned fleet."""
    fields: Dict[str, object] = {}
    for part in filter(None, (p.strip() for p in text.split(","))):
        if "=" not in part:
            raise ValueError(
                f"{LAUNCH_ENV} entry {part!r} is not key=value; expected "
                f"e.g. 'exit=128,stream=512,store=128,writer=lane,"
                f"pixels=24,idct=24,rounds=8'")
        key, _, val = part.partition("=")
        name = _FIELD_ALIASES.get(key.strip())
        if name is None:
            raise ValueError(
                f"{LAUNCH_ENV} key {key.strip()!r} unknown; expected one "
                f"of {sorted(set(_FIELD_ALIASES))}")
        val = val.strip()
        if name != "store_writer":
            try:
                val = int(val)
            except ValueError:
                raise ValueError(f"{LAUNCH_ENV} value {val!r} for {name} "
                                 f"is not an int") from None
        fields[name] = check_launch(name, val)
    return dataclasses.replace(DEFAULT_LAUNCH, **fields)


# ---------------------------------------------------------------------------
# Tuned-config cache: in-memory + persistent table
# ---------------------------------------------------------------------------

_TUNED: Dict[str, LaunchConfig] = {}


def device_kind() -> str:
    """The card's name (``torch.cuda.get_device_name``), "unknown" without
    one: tune keys then fall in one shared bucket."""
    import torch

    if not torch.cuda.is_available():
        return "unknown"
    return torch.cuda.get_device_name().replace(" ", "-")


def tune_key(shape, backend: str, fuse: str,
             kind: Optional[str] = None) -> str:
    """The table key: one entry per (bucket, backend, fuse, device kind),
    the granularity of the program cache plus the card it was measured
    on."""
    label = shape.label() if hasattr(shape, "label") else str(shape)
    return f"{label}|{backend}|{fuse}|{kind or device_kind()}"


def table_path() -> str:
    env = os.environ.get(TABLE_ENV)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "launch.json")


def _load_table(path: str) -> Dict[str, Dict]:
    try:
        with open(path) as f:
            data = json.load(f)
        return data if isinstance(data, dict) else {}
    except (OSError, ValueError):
        return {}


def _store_entry(path: str, key: str, cfg: LaunchConfig) -> None:
    """Best-effort persistent record (read, merge, atomic replace); a
    read-only filesystem degrades to in-memory tuning, never an error on
    the decode path."""
    try:
        table = _load_table(path)
        table[key] = dataclasses.asdict(cfg)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                                   prefix=".launch.")
        with os.fdopen(fd, "w") as f:
            json.dump(table, f, indent=0, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass


def _from_row(row) -> LaunchConfig:
    """A table row as a config, every knob checked (TypeError/ValueError
    on a stale or corrupt row)."""
    if not isinstance(row, dict):
        raise TypeError(f"table row {row!r} is not an object")
    return LaunchConfig(**{k: check_launch(k, v) for k, v in row.items()})


def clear_launch_cache() -> None:
    """Drop the in-memory tuned-config cache (tests)."""
    _TUNED.clear()


def autotune_enabled() -> bool:
    return os.environ.get(AUTOTUNE_ENV) == "1"


def search(measure: Callable[[LaunchConfig], float], rounds: int = 3,
           candidates: Optional[List[LaunchConfig]] = None
           ) -> tuple:
    """Measure every candidate ``rounds`` times in turns; return
    ``(winner, {config: [seconds]})``.

    ``measure(cfg) -> seconds`` runs one warm decode under ``cfg``, or
    raises ``ValueError`` for a config the bucket refuses (a group count
    its layout does not divide, the warp writer below a warp of lanes),
    which drops the candidate. The winner is the candidate with the least
    median, but the default (the first candidate) stays unless that
    median beats the default's by more than the spread (max - min) of
    either one's times.
    """
    cands = list(candidates or candidate_configs())
    times: Dict[LaunchConfig, List[float]] = {c: [] for c in cands}
    for _ in range(rounds):
        for cand in list(times):
            try:
                times[cand].append(float(measure(cand)))
            except ValueError:
                del times[cand]
    if not times:
        return DEFAULT_LAUNCH, times
    default = cands[0]
    med = {c: statistics.median(ts) for c, ts in times.items()}
    best = min(med, key=med.get)
    if default in med and best != default:
        spread = max(max(times[c]) - min(times[c]) for c in (best, default))
        if med[default] - med[best] <= spread:
            best = default
    return best, times


def resolve_launch(shape, backend: str, fuse: str, *,
                   measure: Optional[Callable[[LaunchConfig], float]] = None,
                   kind: Optional[str] = None,
                   rounds: int = 3) -> LaunchConfig:
    """Resolve the launch config of one program bucket.

    With ``measure`` (see :func:`search`), a bucket found in neither cache
    is searched, the winner memoized in-process and written to the
    table, so later processes skip the search. Without it the call is a
    pure lookup (override > caches > defaults): resolving a warm bucket
    measures nothing.
    """
    override = os.environ.get(LAUNCH_ENV)
    if override:
        return parse_launch_override(override)
    if backend != "cuda":
        return DEFAULT_LAUNCH
    key = tune_key(shape, backend, fuse, kind)
    hit = _TUNED.get(key)
    if hit is not None:
        return hit
    path = table_path()
    row = _load_table(path).get(key)
    if row is not None:
        try:
            cfg = _TUNED[key] = _from_row(row)
            return cfg
        except (TypeError, ValueError):
            pass  # stale or corrupt row: fall through to tune or default
    if measure is None:
        _TUNED[key] = DEFAULT_LAUNCH
        return DEFAULT_LAUNCH
    best, _ = search(measure, rounds=rounds)
    _TUNED[key] = best
    _store_entry(path, key, best)
    return best
