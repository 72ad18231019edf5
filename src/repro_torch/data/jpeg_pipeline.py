"""The paper's decoder as a first-class input-pipeline stage.

The port of the JAX package's ``data/jpeg_pipeline.py``. This is the
deployment the paper motivates: a VLM training job where only
*compressed* JPEG bytes cross the host->device link; entropy decoding,
IDCT, patchify and the patch embedding all run on the card, then feed the
model's vision frontend directly.

Pipeline: jpeg bytes --(host: parse+frame)--> device plan
          --(card: parallel decode)--> RGB
          --(card: patchify + linear embed stub)--> (B, n_patches, 1024)

The host work is exactly the paper's host share (header parse +
subsequence framing); pixels never exist host-side.

Streaming: decode programs live in the module-level per-bucket cache
(:func:`repro_torch.core.api.decode_program`, keyed on the batch's
capacity-bucketed ``PlanShape``), NOT in this pipeline — a stream of fresh
batches allocates once per bucket and then only moves data. The
pipeline's own ``_decoders`` LRU caches per-*batch* handles (parsed plan +
pinned host copy of its arrays), which only matters when the same
byte-identical batch repeats; ``decoder_cache_size=0`` disables that
handle cache entirely without losing the shared programs.
:meth:`JpegVisionPipeline.decode_stats` surfaces the streaming counters.

``mesh=`` (a ``launch.mesh.Mesh``) splits each batch's decode over the
mesh's cards (``ParallelDecoder.decode_on``), balanced over as many lane
blocks with ``balance``; the RGB is gathered to the mesh's first card,
which embeds it as without a mesh, so the tokens are the same bits.
Against the JAX package, ``decode_stats()`` has no ``jaxpr_eqns``.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.api import ParallelDecoder, resolve_options
from ..core.bitstream import STATUS_OK, STATUS_RECOVERED, STATUS_REJECTED
from ..jpeg.encoder import Dataset
from ..launch.multihost import process_info


def embed_from_jax(w: np.ndarray) -> torch.Tensor:
    """The JAX pipeline's patch embedding as the port's bf16 weight.

    ``w`` is ``np.asarray(pipe.w_embed.astype(jnp.float32))`` of a
    ``repro`` pipeline; bf16 -> f32 -> bf16 is lossless, so tokens of both
    packages come from the same weights. Install it with
    :meth:`JpegVisionPipeline.load_embed`.
    """
    return torch.from_numpy(np.array(w, dtype=np.float32)).to(
        torch.bfloat16)


@dataclasses.dataclass
class JpegPipelineStats:
    compressed_mb: float
    decoded_mb: float
    n_images: int
    sync_rounds: int
    # streaming decode stats (allocate-once observability)
    decode_ms: float = 0.0        # wall ms of this batch's decode+embed
    compiled: bool = False        # this batch allocated its bucket's program
    bucket: str = ""              # PlanShape label of the batch's bucket
    # resilience (validate=True pipelines): per-image STATUS_* array and
    # the batch's damaged-image counts
    status: Optional[np.ndarray] = None   # (B,) int32 or None
    images_recovered: int = 0
    images_rejected: int = 0

    @property
    def transfer_saving(self) -> float:
        return self.decoded_mb / max(self.compressed_mb, 1e-9)


class JpegVisionPipeline:
    """Decode a batch of JPEGs on the card and emit ViT-style patch tokens.

    ``device`` (default ``"cuda"``, or the first device of ``mesh``:
    raises without a card; ``"cpu"`` runs the plain versions), ``sync``,
    ``backend`` and ``fuse`` go to the decoder and resolve as
    :func:`repro_torch.core.api.resolve_options` does. ``mesh`` decodes
    over the mesh's cards (module docstring). ``balance``
    ("roundrobin"/"lpt") lays a batch's chunk lanes out in balanced
    blocks, one a card (bit-identical). ``bucket=False`` pins
    exact-fit plan shapes (one program per distinct batch geometry).
    ``sync_stats=True`` waits for each batch's tokens so ``decode_ms`` is
    the true device wall time; by default it measures only the host's
    enqueue cost. ``validate=True`` makes the stage resilient: damaged
    blobs are classified (never raised), rejected images decode as inert
    lanes, and per-batch stats carry a per-image status.
    """

    def __init__(self, patch: int = 16, embed_dim: int = 1024,
                 chunk_bits: int = 1024, sync: str = "jacobi",
                 backend: Optional[str] = None, seed: int = 0,
                 device=None, balance: str = "none",
                 decoder_cache_size: int = 16, bucket: bool = True,
                 sync_stats: bool = False, validate: bool = False,
                 fuse: Optional[str] = None, mesh=None):
        if device is None:
            device = mesh.devices.flat[0] if mesh is not None else "cuda"
        self.device, _, _ = resolve_options(sync, backend, fuse, device)
        self.mesh = mesh
        self.patch = patch
        self.embed_dim = embed_dim
        self.chunk_bits = chunk_bits
        self.sync = sync
        self.backend = backend
        self.fuse = fuse
        self.validate = validate
        self.balance = balance
        self.bucket = bucket
        self.sync_stats = sync_stats
        rng = np.random.default_rng(seed)
        # stub patch-embedding projection (fixed; a real run would train
        # it), drawn as the JAX package draws it
        self.w_embed = torch.from_numpy(
            rng.normal(0, 0.02, (patch * patch * 3, embed_dim))).to(
            torch.bfloat16).to(self.device)
        # LRU of per-batch decoder *handles* (host plan + pinned arrays).
        # Programs live in the shared per-bucket cache of core.api, so
        # eviction here never discards a program's buffers. Size 0 turns
        # the handle cache off: every call builds (and returns) a fresh,
        # fully usable handle and pins nothing afterwards.
        if decoder_cache_size < 0:
            raise ValueError(
                f"decoder_cache_size must be >= 0 (0 disables caching), "
                f"got {decoder_cache_size}")
        self._decoder_cache_size = decoder_cache_size
        self._decoders: Dict = collections.OrderedDict()
        # One pipeline may be fed from several threads (the decode
        # service, or a threaded data loader): every running counter below
        # and the handle LRU mutate under this lock — bare ``+=`` is not
        # atomic. Device work never runs under the lock.
        self._lock = threading.Lock()
        self._batches = 0
        self._compiles = 0
        self._cold_ms: List[float] = []
        self._warm_ms: List[float] = []
        self._buckets: Dict[str, int] = {}
        self._last: Optional[JpegPipelineStats] = None
        self._last_dec: Optional[ParallelDecoder] = None
        # resilience counters (advance only under validate=True)
        self._images_ok = 0
        self._images_recovered = 0
        self._images_rejected = 0

    def load_embed(self, w) -> None:
        """Install a patch embedding of shape ``(patch*patch*3,
        embed_dim)`` (a tensor, or numpy through :func:`embed_from_jax`)."""
        if not isinstance(w, torch.Tensor):
            w = embed_from_jax(w)
        if tuple(w.shape) != tuple(self.w_embed.shape):
            raise ValueError(f"embedding shape {tuple(w.shape)} != "
                             f"{tuple(self.w_embed.shape)}")
        self.w_embed = w.to(device=self.device, dtype=torch.bfloat16)

    @staticmethod
    def _batch_key(blobs: Sequence[bytes]) -> bytes:
        """Content digest of a batch. A decoder handle holds the batch's
        words and metadata, so the key must identify the *bytes*, not just
        the shape: two same-size batches must never share a handle."""
        h = hashlib.blake2b(digest_size=16)
        for b in blobs:
            h.update(len(b).to_bytes(8, "little"))
            h.update(b)
        return h.digest()

    def _decoder(self, blobs: Sequence[bytes]) -> ParallelDecoder:
        key = self._batch_key(blobs)
        with self._lock:
            dec = self._decoders.get(key)
            if dec is not None:
                self._decoders.move_to_end(key)
                return dec
        # plan build happens outside the lock; two threads missing the
        # same key both build (benign — handles are content addressed and
        # the program is shared), last insert wins
        dec = ParallelDecoder.from_bytes(
            list(blobs), chunk_bits=self.chunk_bits, sync=self.sync,
            backend=self.backend, bucket=self.bucket, fuse=self.fuse,
            device=self.device, validate=self.validate,
            balance=self.balance,
            lanes=self.mesh.size if self.mesh is not None else None)
        if self._decoder_cache_size > 0:
            with self._lock:
                self._decoders[key] = dec
                while len(self._decoders) > self._decoder_cache_size:
                    self._decoders.popitem(last=False)
        return dec

    def embed(self, rgb: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 -> (B, n_patches, embed_dim) bf16 tokens:
        patchify (a reshape and a permute of the crop to whole patches),
        scale to [0, 1] in bf16, and one bf16 product with ``w_embed``."""
        b, h, w, _ = rgb.shape
        p = self.patch
        hc, wc = h // p, w // p
        x = rgb[:, : hc * p, : wc * p].to(torch.bfloat16) / 255.0
        x = x.reshape(b, hc, p, wc, p, 3).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, hc * wc, p * p * 3)
        return x @ self.w_embed

    def patches_for(self, blobs: Sequence[bytes]):
        """(B, n_patches, embed_dim) patch tokens + stats."""
        t0 = time.perf_counter()
        dec = self._decoder(blobs)
        with self._lock:
            self._last_dec = dec
        allocations = dec.program.allocations
        if self.mesh is not None:
            out = dec.decode_on(self.mesh, emit="rgb")
            compiled = out.mesh.get("allocations", 0) > 0
            rgb = None if out.rgb is None else out.rgb.full(self.device)
        else:
            out = dec.decode(emit="rgb")
            compiled = dec.program.allocations > allocations
            rgb = out.rgb  # (B, H, W, 3) uint8 on the device
        if rgb is None:
            # validated decode with no pixel stage (every image quarantined,
            # or mixed-geometry survivors): emit zero patch tokens per image
            # so the stream keeps flowing — status tells the caller why
            b, h, w = len(blobs), 0, 0
            tokens = torch.zeros((b, 0, self.embed_dim),
                                 dtype=torch.bfloat16, device=self.device)
        else:
            b, h, w, _ = rgb.shape
            tokens = self.embed(rgb)
        if self.sync_stats and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt_ms = (time.perf_counter() - t0) * 1e3
        status = out.status
        stats = JpegPipelineStats(
            compressed_mb=sum(len(bb) for bb in blobs) / 1e6,
            decoded_mb=b * h * w * 3 / 1e6,
            n_images=b,
            sync_rounds=out.sync_rounds,
            decode_ms=dt_ms,
            compiled=compiled,
            bucket=dec.shape.label(),
            status=status,
            images_recovered=(int((status == STATUS_RECOVERED).sum())
                              if status is not None else 0),
            images_rejected=(int((status == STATUS_REJECTED).sum())
                             if status is not None else 0),
        )
        self._record(stats)
        return tokens, stats

    def _record(self, stats: JpegPipelineStats) -> None:
        with self._lock:
            self._batches += 1
            self._compiles += int(stats.compiled)
            log = self._cold_ms if stats.compiled else self._warm_ms
            log.append(stats.decode_ms)
            del log[:-100]  # bounded history for the medians
            self._buckets[stats.bucket] = \
                self._buckets.get(stats.bucket, 0) + 1
            if stats.status is not None:
                self._images_ok += int((stats.status == STATUS_OK).sum())
                self._images_recovered += stats.images_recovered
                self._images_rejected += stats.images_rejected
            self._last = stats

    def decode_stats(self) -> Dict:
        """Streaming decode counters.

        ``compile_count`` counts batches whose decode allocated its
        bucket's ``DecodeProgram`` (``decode_program_stats()``'s
        allocations: the port's counterpart of the JAX package's traces;
        the target is one per (bucket, sync, backend, fuse) over the whole
        stream); ``warm_step_ms`` is the median decode+embed wall time of
        the other steps — the steady-state cost. Step times include device
        execution only under ``sync_stats=True``.

        ``kernel_launches`` are the last decode's kernel launches
        (``ParallelDecoder.launch_stats()``) plus two for each replayed
        CUDA graph of two Jacobi rounds; ``inter_stage_hbm_bytes`` is the
        same dict's analytic inter-stage traffic.

        Counters are *per process*: in a multi-process launch every process
        allocates (and feeds) independently, so the dict carries
        ``process_id`` / ``process_count`` and must never be summed across
        processes (gather with
        :func:`repro_torch.launch.multihost.gather_decode_stats`).
        """
        med = (lambda xs: float(np.median(xs)) if xs else 0.0)
        info = process_info()
        # snapshot every counter under the lock so a concurrent _record
        # cannot be observed half-applied
        with self._lock:
            last = self._last
            dec = self._last_dec
            batches, compiles = self._batches, self._compiles
            cold_ms, warm_ms = list(self._cold_ms), list(self._warm_ms)
            buckets = dict(self._buckets)
            images_ok = self._images_ok
            images_recovered = self._images_recovered
            images_rejected = self._images_rejected
        launch = dec.launch_stats() if dec is not None else {}
        return {
            "batches": batches,
            "compile_count": compiles,
            "cold_step_ms": med(cold_ms),
            "warm_step_ms": med(warm_ms),
            "buckets": buckets,
            "active_bucket": last.bucket if last else "",
            "sync_rounds": last.sync_rounds if last else 0,
            "transfer_saving": last.transfer_saving if last else 0.0,
            # resilience rollups (all zero unless validate=True)
            "images_ok": images_ok,
            "images_recovered": images_recovered,
            "images_rejected": images_rejected,
            "fuse": launch.get("fuse", dec.fuse if dec else "none"),
            "kernel_launches": (sum(launch.get("launches", {}).values())
                                + 2 * launch.get("graph_replays", 0)),
            "inter_stage_hbm_bytes": launch.get("inter_stage_bytes", 0),
            "process_id": info.process_id,
            "process_count": info.num_processes,
        }

    def batches(self, dataset: Dataset, batch_size: int,
                drop_remainder: bool = False):
        """Yield (tokens, stats) per batch of ``batch_size`` images.

        When the dataset size does not divide, the tail is yielded as a
        short final batch; pass ``drop_remainder=True`` for fixed-shape
        training streams.

        Every batch here is content-distinct, so only the shared
        per-bucket program cache (never the content-keyed handle LRU)
        keeps the stream from allocating: after a bucket's first batch,
        steps are pure data movement.
        """
        blobs = dataset.jpeg_bytes
        for i in range(0, len(blobs), batch_size):
            batch = blobs[i: i + batch_size]
            if drop_remainder and len(batch) < batch_size:
                return
            yield self.patches_for(batch)
