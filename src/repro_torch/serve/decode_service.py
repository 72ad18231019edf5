"""Continuous-batching async JPEG decode service, on the card.

A port of the JAX package's ``serve/decode_service.py`` over the port's
program cache (``core/api.py``): callers :meth:`~DecodeService.submit`
single JPEG requests and get a future; a deadline-aware micro-batch
**former** packs arrivals into batches on the
:class:`~repro_torch.core.bitstream.PlanShape` bucket ladder, host-side
parse/plan/validate runs in stage threads overlapped with device decode,
and results are delivered per request with latency and SLO accounting.

Pipeline (three stage threads + the callers' threads)::

    submit() -> [arrival queue] -> former  (parse/validate, group by
                                            geometry, deadline-aware flush)
             -> [form queue]    -> planner (pad to batch_size, build plan,
                                            admission, upload plan data)
             -> [ready queue]   -> device  (decode, copy to the host,
                                            fulfill futures)

* **Continuous batching.** The former groups requests by image geometry
  and flushes a group when it reaches ``batch_size``, when the oldest
  request has waited ``max_form_ms`` (the sparse-queue bound), or when
  its deadline minus the current batch-time estimate says the batch must
  launch *now* to meet the SLO. Partial batches are padded to
  ``batch_size`` with inert quarantine slots (the rejected-image
  machinery: zero-bit segments in a donor footprint — pure plan *data*),
  so every batch of a geometry rides the same ``n_images`` bucket and a
  partial flush never adds a program.

* **Admission control is program-cache control.** Each formed batch's
  bucketed :class:`PlanShape` is checked against the admitted set: an
  already-admitted (or covering) bucket is a *hit*; a new bucket is
  *minted* only while ``len(admitted) < max_buckets``. Beyond that, the
  batch either fails typed (``admission="reject"``) or its requests wait
  and are retried — bounded by each request's deadline, which converts
  an unserveable wait into a typed ``DeadlineExceeded``
  (``admission="wait"``). A single request too large for the configured
  top ladder rung is rejected at submit time (``RequestTooLarge``)
  before any plan (or program) can exist for it.

* **Host/device overlap.** The ready queue is bounded at
  ``ready_depth`` (default 2): while the device thread runs batch *k*,
  the planner is building batch *k+1*'s plan and copying it from pinned
  host memory to the card on a CUDA stream of its own
  (``ParallelDecoder.prefetch``), recording an event; the device thread
  decodes on its own stream, which waits on that event before it copies
  the batch into the program's buffers. The device stage makes one
  device-to-host copy per batch.

* **Resilience.** With ``validate=True``, corrupt requests flow through
  validation as quarantine lanes — they decode inert, their results
  carry ``STATUS_REJECTED``, and they never stall the queue. With
  ``validate=False`` (strict), a non-clean blob fails its future typed at
  parse time and never enters a batch.

* **Graceful shutdown.** ``close()`` (or the context manager) drains: the
  former flushes every pending group, the planner and device threads
  finish the in-flight batches, and only then do the threads exit.
  ``close(drain=False)`` fails pending requests with ``ServiceClosed``.

``serve_stats()`` reports queue depths, batch occupancy, deadline
misses, latency percentiles, and per-bucket hit/miss counters, with the
program cache's counters (:func:`repro_torch.core.api.decode_program_stats`).

``ServiceConfig(device="cuda")`` is the default: without a card the
service refuses to start unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.api import (ParallelDecoder, _shape_covers, decode_program_stats,
                        resolve_options, sequential_chunk_bits)
from ..core.bitstream import (BatchValidation, BlobReport, ImageGeometry,
                              PlanShape, STATUS_OK, STATUS_REJECTED,
                              bucket_capacity, build_batch_plan, plan_shape,
                              validate_blob)


# ---------------------------------------------------------------------------
# Typed request outcomes
# ---------------------------------------------------------------------------

class ServeError(Exception):
    """Base class for decode-service errors."""


class ServiceClosed(ServeError):
    """submit() after close()."""


class RequestRejected(ServeError):
    """The request was not decoded; ``reason`` says why."""

    def __init__(self, message: str, reason: str = "rejected"):
        super().__init__(message)
        self.reason = reason


class RequestTooLarge(RequestRejected):
    """The blob exceeds the service's top words-ladder rung — admitting it
    would add a program of unbounded size, so it is refused before any
    plan exists."""

    def __init__(self, message: str):
        super().__init__(message, reason="too_large")


class QueueFull(RequestRejected):
    """The arrival queue is at its bound (overload shedding)."""

    def __init__(self, message: str):
        super().__init__(message, reason="queue_full")


class BucketAdmissionError(RequestRejected):
    """The formed batch would mint a PlanShape bucket beyond
    ``max_buckets`` and the admission policy is ``"reject"`` (or the
    service is draining)."""

    def __init__(self, message: str):
        super().__init__(message, reason="admission")


class DeadlineExceeded(RequestRejected):
    """The request's deadline expired while waiting for bucket admission
    (``admission="wait"``) — the SLO bound on the wait."""

    def __init__(self, message: str):
        super().__init__(message, reason="deadline")


# ---------------------------------------------------------------------------
# Configuration / results
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServiceConfig:
    """Tuning knobs for one :class:`DecodeService`.

    ``slo_ms`` is the default per-request deadline (submit can override);
    the former uses it together with the running batch-time estimate to
    decide when a partial batch must flush. ``max_words`` is the top
    words-capacity ladder rung a single request may occupy — the
    admission bound that keeps one oversized blob from minting an
    unbounded bucket. ``device`` is where the decode runs: ``"cuda"``
    (default; the service refuses to start without a card) or ``"cpu"``.
    ``mesh`` (a ``launch.mesh.Mesh`` of that device type) splits each
    batch's decode over the mesh's cards (``ParallelDecoder.decode_on``);
    the results are gathered to the host as without it.
    """

    batch_size: int = 8
    slo_ms: float = 1000.0
    max_form_ms: float = 50.0        # sparse-queue partial-flush bound
    safety_ms: float = 2.0           # SLO slack subtracted from deadlines
    est_batch_ms: float = 50.0       # batch-time prior before the first batch
    wait_retry_ms: float = 10.0      # re-form delay for admission-bounced reqs
    max_buckets: int = 4             # admitted PlanShape buckets (program cap)
    admission: str = "reject"        # "reject" | "wait" beyond max_buckets
    max_words: int = 1 << 18         # top ladder rung for one request's words
    queue_limit: int = 4096          # arrival-queue bound (shed beyond)
    ready_depth: int = 2             # prepared batches in flight (dbl buffer)
    # decode knobs (the same surface as ParallelDecoder.from_bytes)
    chunk_bits: int = 1024
    seq_chunks: int = 32
    sync: str = "jacobi"
    backend: Optional[str] = None
    fuse: Optional[str] = None
    validate: bool = False           # quarantine damage instead of rejecting
    emit: str = "rgb"                # "rgb" | "coeffs"
    device: str = "cuda"
    mesh: object = None              # decode_on(mesh) when set

    def __post_init__(self):
        if self.admission not in ("reject", "wait"):
            raise ValueError(f"admission must be 'reject' or 'wait', "
                             f"got {self.admission!r}")
        if self.emit not in ("rgb", "coeffs"):
            raise ValueError(f"emit must be 'rgb' or 'coeffs', "
                             f"got {self.emit!r}")
        if self.batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if self.ready_depth < 1:
            raise ValueError("ready_depth must be >= 1")


@dataclasses.dataclass
class ServeResult:
    """Per-request outcome delivered through the submit() future."""

    status: int                      # STATUS_OK / RECOVERED / REJECTED
    latency_ms: float                # submit -> result-ready wall time
    deadline_missed: bool
    bucket: str                      # PlanShape label the batch rode
    batch_images: int                # real requests in the batch (occupancy)
    index_in_batch: int
    rgb: Optional[torch.Tensor] = None     # (H, W, 3) uint8, host
    coeffs: Optional[torch.Tensor] = None  # (n_units, 64) int32, host
    error: Optional[str] = None      # validation diagnostic (damaged blobs)


@dataclasses.dataclass(eq=False)   # identity eq: reports hold numpy arrays
class _Request:
    blob: bytes
    arrival: float                   # perf_counter at submit
    deadline: float                  # absolute perf_counter deadline
    future: Future
    # filled by the former's parse step
    report: Optional[BlobReport] = None
    geo: Optional[ImageGeometry] = None
    first_seen: float = 0.0          # when the former admitted it to pending
    not_before: float = 0.0          # admission-bounce retry gate
    bounced: int = 0


@dataclasses.dataclass
class _FormedBatch:
    requests: List[_Request]
    geo: Optional[ImageGeometry]


@dataclasses.dataclass
class _PreparedBatch:
    dec: ParallelDecoder
    requests: List[_Request]
    minted: bool                     # this batch admitted (allocates) a bucket
    bucket: str


_PAD_REPORT_ERROR = "pad slot (batch former fill)"

# pending-group key for requests with no parsed geometry (rejected blobs in
# validate mode); a real group key is an ImageGeometry, and None is the
# former's "no group due" sentinel, so these need their own bucket key
_NO_GEO = "no-geometry"


def _group_key(req: "_Request"):
    return req.geo if req.geo is not None else _NO_GEO


def _pad_report() -> BlobReport:
    """An inert quarantine report for a former pad slot: plans as a
    zero-bit rejected image in the donor footprint, so padding a partial
    batch to ``batch_size`` adds no words and no decode work."""
    return BlobReport(status=STATUS_REJECTED, error=_PAD_REPORT_ERROR)


class DecodeService:
    """Continuous-batching async decode service (module docstring)."""

    def __init__(self, config: Optional[ServiceConfig] = None, **overrides):
        if config is None:
            config = ServiceConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        self.config = config
        # refuses a missing card (unless device="cpu") before any thread
        self._device, self._backend, self._fuse = resolve_options(
            config.sync, config.backend, config.fuse, config.device)
        self._streams = None         # (upload, decode) CUDA streams
        if self._device.type == "cuda":
            self._streams = (torch.cuda.Stream(self._device),
                             torch.cuda.Stream(self._device))
        # arrival/pending state, guarded by _cv (the former's condition)
        self._cv = threading.Condition()
        self._arrivals: deque = deque()
        self._pending: "OrderedDict[object, List[_Request]]" = OrderedDict()
        self._forms_outstanding = 0  # formed batches not yet past the planner
        self._closed = False         # submit() gate
        self._draining = False       # close(drain=True) in progress
        self._abort = False          # close(drain=False): fail pending
        # stage queues
        self._form_q: "queue.Queue" = queue.Queue()
        self._ready_q: "queue.Queue" = queue.Queue(maxsize=config.ready_depth)
        # stats + admission state, guarded by _lock (leaf lock: never
        # acquire _cv while holding it)
        self._lock = threading.Lock()
        self._admitted: List[PlanShape] = []
        self._est_batch_s = config.est_batch_ms / 1e3
        self._reset_counters_locked()
        self._threads = [
            threading.Thread(target=self._former_loop, daemon=True,
                             name="decode-serve-former"),
            threading.Thread(target=self._planner_loop, daemon=True,
                             name="decode-serve-planner"),
            threading.Thread(target=self._device_loop, daemon=True,
                             name="decode-serve-device"),
        ]
        for t in self._threads:
            t.start()

    # -- lifecycle ----------------------------------------------------------

    def __enter__(self) -> "DecodeService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self, drain: bool = True, timeout: float = 120.0) -> None:
        """Stop the service. ``drain=True`` (default) serves everything
        already submitted — pending groups flush (padded if partial),
        in-flight batches finish on device, futures resolve — before the
        stage threads exit. ``drain=False`` fails pending requests with
        :class:`ServiceClosed` and only finishes batches already past
        the former."""
        with self._cv:
            self._closed = True
            self._draining = True
            if not drain:
                self._abort = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=timeout)

    def submit(self, blob: bytes, deadline_ms: Optional[float] = None
               ) -> Future:
        """Queue one JPEG for decode; returns a future of
        :class:`ServeResult` (or a typed :class:`RequestRejected`).

        ``deadline_ms`` overrides the config SLO for this request. A blob
        larger than the top admission rung fails immediately with
        :class:`RequestTooLarge` — no plan is built and no program can
        result from it."""
        fut: Future = Future()
        now = time.perf_counter()
        blob = bytes(blob)
        # words-ladder admission: the per-request words operand extent,
        # rounded up the same capacity ladder the plan shapes ride
        words = -(-len(blob) // 4)
        if bucket_capacity(words) > bucket_capacity(self.config.max_words):
            fut.set_exception(RequestTooLarge(
                f"request of {len(blob)} bytes (~{words} words) exceeds the "
                f"service's top ladder rung "
                f"({bucket_capacity(self.config.max_words)} words)"))
            self._count_rejection("too_large")
            return fut
        req = _Request(
            blob=blob, arrival=now, future=fut,
            deadline=now + (deadline_ms if deadline_ms is not None
                            else self.config.slo_ms) / 1e3)
        with self._cv:
            if self._closed:
                raise ServiceClosed("submit() after close()")
            depth = len(self._arrivals) + sum(
                len(g) for g in self._pending.values())
            if depth >= self.config.queue_limit:
                fut.set_exception(QueueFull(
                    f"arrival queue at its bound ({depth} pending >= "
                    f"queue_limit={self.config.queue_limit})"))
                self._count_rejection("queue_full")
                return fut
            self._arrivals.append(req)
            self._cv.notify_all()
        with self._lock:
            self._submitted += 1
            if self._t_first is None:
                self._t_first = now
        return fut

    def submit_many(self, blobs: Sequence[bytes],
                    deadline_ms: Optional[float] = None) -> List[Future]:
        return [self.submit(b, deadline_ms=deadline_ms) for b in blobs]

    def prewarm(self, blobs: Sequence[bytes]) -> None:
        """Push one batch of representative blobs through the full
        pipeline synchronously — mints the bucket and allocates its
        program so the first real request never pays for it. Follow with
        :meth:`reset_stats` to keep SLO accounting clean."""
        futs = self.submit_many(blobs, deadline_ms=600_000.0)
        for f in futs:
            f.result(timeout=600)

    def reset_stats(self) -> None:
        """Zero the traffic counters (admitted buckets and the batch-time
        estimate survive — they are serving state, not measurements)."""
        with self._lock:
            self._reset_counters_locked()

    # -- observability ------------------------------------------------------

    def _reset_counters_locked(self) -> None:
        self._submitted = 0
        self._completed = 0
        self._rejections: Dict[str, int] = {}
        self._deadline_misses = 0
        self._batches = 0
        self._batch_images = 0
        self._occupancy: List[int] = []
        self._latencies: deque = deque(maxlen=8192)
        self._cold_ms: List[float] = []
        self._warm_ms: List[float] = []
        self._bucket_stats: Dict[str, Dict[str, int]] = {}
        self._t_first: Optional[float] = None
        self._t_last_done: Optional[float] = None

    def _count_rejection(self, reason: str) -> None:
        with self._lock:
            self._rejections[reason] = self._rejections.get(reason, 0) + 1

    def serve_stats(self) -> Dict:
        """Serving counters: per-service counters, a nested ``programs``
        dict from :func:`repro_torch.core.api.decode_program_stats` (the
        shared program cache the admission policy protects), and median
        cold/warm batch times. ``buckets`` maps each admitted bucket label
        to its ``hits``/``misses`` (miss = the batch that minted it)."""
        with self._cv:
            arrival_depth = len(self._arrivals)
            pending_depth = sum(len(g) for g in self._pending.values())
        med = (lambda xs: float(np.median(xs)) if xs else 0.0)
        with self._lock:
            lat = np.asarray(self._latencies, dtype=np.float64)
            span = ((self._t_last_done - self._t_first)
                    if self._t_last_done is not None
                    and self._t_first is not None else 0.0)
            pct = (lambda q: float(np.percentile(lat, q)) if lat.size else 0.0)
            return {
                "submitted": self._submitted,
                "completed": self._completed,
                "rejected": dict(self._rejections),
                "deadline_misses": self._deadline_misses,
                "batches": self._batches,
                "batch_size": self.config.batch_size,
                "occupancy_mean": (float(np.mean(self._occupancy))
                                   if self._occupancy else 0.0),
                "queue_depth": {
                    "arrival": arrival_depth,
                    "pending": pending_depth,
                    "formed": self._form_q.qsize(),
                    "ready": self._ready_q.qsize(),
                },
                "latency_ms": {"p50": pct(50), "p90": pct(90),
                               "p99": pct(99),
                               "max": float(lat.max()) if lat.size else 0.0},
                "throughput_ips": (self._completed / span if span > 0
                                   else 0.0),
                "cold_batch_ms": med(self._cold_ms),
                "warm_batch_ms": med(self._warm_ms),
                "est_batch_ms": self._est_batch_s * 1e3,
                "slo_ms": self.config.slo_ms,
                "buckets": {k: dict(v)
                            for k, v in self._bucket_stats.items()},
                "admitted_buckets": [s.label() for s in self._admitted],
                "max_buckets": self.config.max_buckets,
                "programs": decode_program_stats(),
            }

    # -- stage 1: parse + deadline-aware micro-batch former -----------------

    def _fail(self, req: _Request, exc: Exception, reason: str) -> None:
        if not req.future.done() and \
                req.future.set_running_or_notify_cancel():
            req.future.set_exception(exc)
        self._count_rejection(reason)

    def _parse_request(self, req: _Request) -> None:
        """Classify one arrival (host work, outside every lock) and stage
        it for forming — or fail its future typed."""
        try:
            report = validate_blob(req.blob)
        except Exception as e:  # a stage thread keeps running
            # validate_blob is the non-throwing wall; anything escaping it
            # is a bug, but a serving thread must forward it into the
            # request's future rather than die
            self._fail(req, RequestRejected(f"parse failed: {e}", "error"),
                       "error")
            return
        if report.status != STATUS_OK and not self.config.validate:
            # strict mode: damage is a typed client error, never a decode
            self._fail(req, RequestRejected(
                f"damaged JPEG: {report.error}", "damaged"), "damaged")
            return
        req.report = report
        req.geo = (ImageGeometry.of(report.image)
                   if report.image is not None else None)
        req.first_seen = time.perf_counter()
        with self._cv:
            self._pending.setdefault(_group_key(req), []).append(req)
            self._cv.notify_all()

    def _flush_time(self, req: _Request, est: float) -> float:
        """Absolute time at which this request alone forces a flush."""
        t_sparse = req.first_seen + self.config.max_form_ms / 1e3
        t_slo = req.deadline - est - self.config.safety_ms / 1e3
        return max(min(t_sparse, t_slo), req.not_before)

    def _est_s(self) -> float:
        with self._lock:
            return self._est_batch_s

    def _due_key_locked(self, now: float):
        """The first pending group that must flush now (or None)."""
        est = self._est_s()
        for key, reqs in self._pending.items():
            eligible = [r for r in reqs if r.not_before <= now]
            if len(eligible) >= self.config.batch_size:
                return key
            if eligible and min(self._flush_time(r, est)
                                for r in eligible) <= now:
                return key
        return None

    def _next_due_delay_locked(self, now: float) -> Optional[float]:
        est = self._est_s()
        times = [self._flush_time(r, est)
                 for reqs in self._pending.values() for r in reqs]
        if not times:
            return None
        return max(min(times) - now, 1e-3)

    def _take_batch_locked(self, key, now: float,
                           drain: bool = False) -> List[_Request]:
        reqs = self._pending.get(key, [])
        pool = reqs if drain else [r for r in reqs if r.not_before <= now]
        pool = sorted(pool, key=lambda r: r.arrival)
        take = pool[: self.config.batch_size]
        rest = [r for r in reqs if r not in take]
        if rest:
            self._pending[key] = rest
        else:
            self._pending.pop(key, None)
        return take

    def _former_loop(self) -> None:
        while True:
            with self._cv:
                now = time.perf_counter()
                if (not self._arrivals and not self._draining
                        and self._due_key_locked(now) is None):
                    self._cv.wait(timeout=self._next_due_delay_locked(now))
                raw = list(self._arrivals)
                self._arrivals.clear()
                draining = self._draining
                abort = self._abort
            for req in raw:
                if abort:
                    self._fail(req, ServiceClosed("service closed"), "closed")
                else:
                    self._parse_request(req)
            # flush every due group (everything, when draining)
            while True:
                with self._cv:
                    now = time.perf_counter()
                    key = (next(iter(self._pending), None) if draining
                           else self._due_key_locked(now))
                    if key is None:
                        break
                    batch = self._take_batch_locked(key, now, drain=draining)
                    if not batch:
                        break
                    self._forms_outstanding += 1
                if abort:
                    for r in batch:
                        self._fail(r, ServiceClosed("service closed"),
                                   "closed")
                    with self._cv:
                        self._forms_outstanding -= 1
                        self._cv.notify_all()
                    continue
                self._form_q.put(_FormedBatch(batch, key))
            if draining:
                with self._cv:
                    # exit only when nothing can re-enter pending: the
                    # planner bounces batches back here only while not
                    # draining, and _forms_outstanding covers the window
                    # where a pre-drain batch is still inside the planner
                    if (not self._arrivals and not self._pending
                            and self._forms_outstanding == 0):
                        self._form_q.put(None)
                        return
                    # a pre-drain batch is still in the planner; wait for
                    # its notify instead of spinning
                    self._cv.wait(timeout=0.05)

    # -- stage 2: planner (pad, plan, admission, upload) --------------------

    def _reinject(self, requests: List[_Request], now: float) -> None:
        """Admission-bounced requests go back to the former, gated by a
        retry delay so an unadmittable group does not spin."""
        retry = self.config.wait_retry_ms / 1e3
        with self._cv:
            for r in requests:
                r.bounced += 1
                r.not_before = now + retry
                self._pending.setdefault(_group_key(r), []).append(r)
            self._cv.notify_all()

    def _admit(self, plan, shape: PlanShape):
        """(shape to pin, minted) for a formed batch — or (None, False)
        when the bucket budget is exhausted. Prefers the smallest
        already-admitted shape that covers the plan, so partial batches
        and quarantined batches ride their full siblings' bucket."""
        with self._lock:
            best = None
            for a in self._admitted:
                if a == shape or _shape_covers(a, plan):
                    if best is None or a.n_words < best.n_words:
                        best = a
            if best is not None:
                return best, False
            if len(self._admitted) < self.config.max_buckets:
                self._admitted.append(shape)
                return shape, True
            return None, False

    def _record_bucket(self, label: str, minted: bool) -> None:
        with self._lock:
            st = self._bucket_stats.setdefault(label,
                                               {"hits": 0, "misses": 0})
            st["misses" if minted else "hits"] += 1

    def _plan_batch(self, fb: _FormedBatch) -> Optional[_PreparedBatch]:
        cfg = self.config
        now = time.perf_counter()
        reqs = fb.requests
        # bounced requests whose deadline passed while waiting: the SLO
        # bound on admission="wait"
        expired = [r for r in reqs if r.bounced and now > r.deadline]
        for r in expired:
            self._fail(r, DeadlineExceeded(
                f"deadline expired after {r.bounced} admission retries"),
                "deadline")
        reqs = [r for r in reqs if r not in expired]
        if not reqs:
            return None
        live = [r for r in reqs if r.report.status != STATUS_REJECTED]
        if not live:
            # nothing decodable (validate=True, every blob rejected):
            # resolve directly — a device pass would decode pure padding
            done = time.perf_counter()
            for i, r in enumerate(reqs):
                self._resolve(r, status=STATUS_REJECTED, rgb=None,
                              coeffs=None, bucket="", occupancy=len(reqs),
                              index=i, done=done)
            return None
        reports = [r.report for r in reqs]
        blobs = [r.blob for r in reqs]
        n_pad = cfg.batch_size - len(reqs)
        validation = BatchValidation(reports + [_pad_report()] * n_pad)
        blobs = blobs + [b""] * n_pad
        chunk_bits = cfg.chunk_bits
        if cfg.sync == "sequential":
            unstuffed = [(r.clean, r.rst_bits) for r in validation.reports
                         if r.clean is not None]
            if unstuffed:
                chunk_bits = sequential_chunk_bits(unstuffed)
        plan = build_batch_plan(blobs, chunk_bits=chunk_bits,
                                seq_chunks=cfg.seq_chunks,
                                validation=validation)
        shape = plan_shape(plan)
        pin, minted = self._admit(plan, shape)
        if pin is None:
            if cfg.admission == "wait" and not self._draining:
                self._reinject(reqs, now)
                return None
            for r in reqs:
                self._fail(r, BucketAdmissionError(
                    f"bucket {shape.label()} would exceed "
                    f"max_buckets={cfg.max_buckets} "
                    f"(admitted: {[s.label() for s in self._admitted]})"),
                    "admission")
            return None
        self._record_bucket(pin.label(), minted)
        dec = ParallelDecoder(plan, sync=cfg.sync, backend=self._backend,
                              fuse=self._fuse, device=self._device,
                              shape=pin, validation=validation)
        if self._streams is not None and cfg.mesh is None:
            dec.prefetch(self._streams[0])
        return _PreparedBatch(dec=dec, requests=reqs, minted=minted,
                              bucket=pin.label())

    def _planner_loop(self) -> None:
        while True:
            fb = self._form_q.get()
            if fb is None:
                self._ready_q.put(None)
                return
            try:
                prepared = self._plan_batch(fb)
            except Exception as e:  # a stage thread keeps running
                # per-batch containment: a planning bug fails this batch's
                # futures typed instead of killing the stage thread
                for r in fb.requests:
                    if not r.future.done():
                        self._fail(r, RequestRejected(
                            f"planning failed: {e}", "error"), "error")
                prepared = None
            finally:
                with self._cv:
                    self._forms_outstanding -= 1
                    self._cv.notify_all()
            if prepared is not None:
                # blocks at ready_depth: the backpressure that makes the
                # prepared batches a double buffer, not an unbounded pile
                self._ready_q.put(prepared)

    # -- stage 3: device ----------------------------------------------------

    def _resolve(self, req: _Request, *, status: int, rgb, coeffs,
                 bucket: str, occupancy: int, index: int,
                 done: float) -> None:
        missed = done > req.deadline
        result = ServeResult(
            status=status, latency_ms=(done - req.arrival) * 1e3,
            deadline_missed=missed, bucket=bucket, batch_images=occupancy,
            index_in_batch=index, rgb=rgb, coeffs=coeffs,
            error=(req.report.error
                   if req.report is not None and status != STATUS_OK
                   else None))
        if req.future.set_running_or_notify_cancel():
            req.future.set_result(result)
        with self._lock:
            self._completed += 1
            self._deadline_misses += int(missed)
            self._latencies.append(result.latency_ms)
            self._t_last_done = done

    def _decode_to_host(self, dec: ParallelDecoder):
        """Decode one batch on the service's decode stream, then copy its
        result to the host: one device-to-host copy per batch, which also
        waits for the decode."""
        cfg = self.config
        stream = (torch.cuda.stream(self._streams[1])
                  if self._streams is not None else contextlib.nullcontext())
        with stream:
            if cfg.mesh is not None:
                out = dec.decode_on(cfg.mesh, emit=cfg.emit)
                rgb = (out.rgb.full("cpu") if out.rgb is not None
                       else None)
                coeffs = (out.coeffs.full("cpu") if cfg.emit == "coeffs"
                          else None)
                return out, rgb, coeffs
            out = dec.decode(emit=cfg.emit)
            rgb = out.rgb.cpu() if out.rgb is not None else None
            coeffs = (out.coeffs.cpu() if cfg.emit == "coeffs"
                      and out.coeffs is not None else None)
        return out, rgb, coeffs

    def _device_loop(self) -> None:
        cfg = self.config
        while True:
            pb = self._ready_q.get()
            if pb is None:
                return
            t0 = time.perf_counter()
            try:
                out, rgb, coeffs = self._decode_to_host(pb.dec)
            except Exception as e:  # a stage thread keeps running
                for r in pb.requests:
                    if not r.future.done():
                        self._fail(r, RequestRejected(
                            f"decode failed: {e}", "error"), "error")
                continue
            done = time.perf_counter()
            batch_s = done - t0
            g = pb.dec.shape.geometry
            # per-request views of the host copies are free, while slicing
            # the device tensors would launch an op per request
            status = out.status
            for i, req in enumerate(pb.requests):
                st = (int(status[i]) if status is not None else STATUS_OK)
                c = None
                if coeffs is not None and g is not None:
                    c = coeffs[i * g.n_units:(i + 1) * g.n_units]
                self._resolve(req, status=st,
                              rgb=rgb[i] if rgb is not None else None,
                              coeffs=c, bucket=pb.bucket,
                              occupancy=len(pb.requests), index=i,
                              done=done)
            with self._lock:
                self._batches += 1
                self._batch_images += len(pb.requests)
                self._occupancy.append(len(pb.requests))
                del self._occupancy[:-1000]
                log = self._cold_ms if pb.minted else self._warm_ms
                log.append(batch_s * 1e3)
                del log[:-200]
                if not pb.minted:
                    # EWMA of the warm batch time drives the former's
                    # deadline-pressure flush; the cold (allocating) batch
                    # would poison the estimate for the whole stream
                    self._est_batch_s = 0.8 * self._est_batch_s \
                        + 0.2 * batch_s


# ---------------------------------------------------------------------------
# Open-loop traffic
# ---------------------------------------------------------------------------

def run_open_loop(service: DecodeService, blobs: Sequence[bytes], *,
                  n_requests: int, rate_ips: float = 0.0, seed: int = 0,
                  deadline_ms: Optional[float] = None,
                  timeout_s: float = 600.0) -> Dict:
    """Drive ``service`` with open-loop traffic and summarize outcomes.

    ``rate_ips > 0`` draws Poisson arrivals at that rate (absolute
    schedule — the arrival clock never waits for completions, which is
    what makes the load open-loop); ``rate_ips == 0`` submits the whole
    backlog at once (the saturation/drain measurement). Returns latency
    percentiles over completed requests, achieved images/sec, deadline
    misses, and typed-rejection counts."""
    rng = np.random.default_rng(seed)
    offsets = (np.cumsum(rng.exponential(1.0 / rate_ips, n_requests))
               if rate_ips > 0 else np.zeros(n_requests))
    futures = []
    t0 = time.perf_counter()
    for i in range(n_requests):
        delay = t0 + float(offsets[i]) - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        futures.append(service.submit(blobs[i % len(blobs)],
                                      deadline_ms=deadline_ms))
    results: List[ServeResult] = []
    rejected: Dict[str, int] = {}
    for f in futures:
        try:
            results.append(f.result(timeout=timeout_s))
        except RequestRejected as e:
            rejected[e.reason] = rejected.get(e.reason, 0) + 1
    wall = time.perf_counter() - t0
    lat = np.asarray(sorted(r.latency_ms for r in results))
    pct = (lambda q: float(np.percentile(lat, q)) if lat.size else 0.0)
    return {
        "n_requests": n_requests,
        "completed": len(results),
        "rejected": rejected,
        "deadline_misses": sum(r.deadline_missed for r in results),
        "wall_s": wall,
        "ips": len(results) / wall if wall > 0 else 0.0,
        "p50_ms": pct(50), "p90_ms": pct(90), "p99_ms": pct(99),
        "rate_ips": rate_ips,
        "occupancy_mean": (float(np.mean([r.batch_images for r in results]))
                           if results else 0.0),
    }
