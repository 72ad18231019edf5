"""The port's decode service on the CPU: the counterparts of
``tests/test_serve.py``'s classes, with ``device="cpu"``.

Program-cache thread safety, forming, admission, quarantine, drain and
the typed rejections, and open-loop traffic. Every wait has a
timeout. Most tests share one (geometry, batch_size, chunk_bits) bucket.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro.jpeg import codec_ref as cr
from repro_torch.core import api
from repro_torch.core.bitstream import build_batch_plan, plan_shape
from repro_torch.serve import (BucketAdmissionError, DeadlineExceeded,
                               DecodeService, QueueFull, RequestRejected,
                               RequestTooLarge, ServiceClosed, ServiceConfig,
                               run_open_loop)

from _torch_corpus import synth_image

BATCH = 4
CHUNK_BITS = 256
SEQ_CHUNKS = 8
W = H = 32
TIMEOUT = 120


def blob(seed: int, w: int = W, h: int = H) -> bytes:
    return cr.encode_baseline(synth_image(h, w, seed=seed),
                              quality=80).jpeg_bytes


def corpus(n: int, w: int = W, h: int = H):
    return [blob(s, w, h) for s in range(n)]


def service(**overrides) -> DecodeService:
    cfg = dict(batch_size=BATCH, chunk_bits=CHUNK_BITS,
               seq_chunks=SEQ_CHUNKS, slo_ms=60_000.0, max_form_ms=30.0,
               device="cpu")
    cfg.update(overrides)
    return DecodeService(ServiceConfig(**cfg))


class TestProgramCacheThreadSafety:
    def test_concurrent_lookup_single_cache_entry(self):
        api.clear_decode_programs()
        plan = build_batch_plan(corpus(BATCH), chunk_bits=CHUNK_BITS,
                                seq_chunks=SEQ_CHUNKS)
        shape = plan_shape(plan)
        n = 8
        barrier = threading.Barrier(n)
        got, errs = [None] * n, []

        def hammer(i):
            try:
                barrier.wait(timeout=30)
                got[i] = api.decode_program(shape, device="cpu")
            except Exception as e:  # surfaced through errs
                errs.append(e)

        threads = [threading.Thread(target=hammer, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert not errs
        assert all(p is got[0] for p in got)
        assert len(api.decode_programs()) == 1

    def test_concurrent_first_decode_single_allocation(self):
        """Threads decoding one bucket at once, the very first decode
        included: one program, allocated once, equal outputs."""
        api.clear_decode_programs()
        blobs = corpus(BATCH)
        n = 6
        barrier = threading.Barrier(n)
        errs, outs = [], [None] * n

        def decode_one(i):
            try:
                dec = api.ParallelDecoder.from_bytes(
                    blobs, chunk_bits=CHUNK_BITS, seq_chunks=SEQ_CHUNKS,
                    device="cpu")
                barrier.wait(timeout=60)
                outs[i] = dec.decode(emit="rgb").rgb
            except Exception as e:  # surfaced through errs
                errs.append(e)

        threads = [threading.Thread(target=decode_one, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in threads)
        assert not errs, errs
        progs = api.decode_programs()
        assert len(progs) == 1 and progs[0].allocations == 1
        for o in outs[1:]:
            assert torch.equal(o, outs[0])


class TestServiceBasics:
    def test_full_batches_decode_and_match_reference(self):
        blobs = corpus(2 * BATCH)
        with service() as svc:
            res = [f.result(timeout=TIMEOUT) for f in svc.submit_many(blobs)]
        assert all(r.status == 0 for r in res)
        assert all(r.batch_images == BATCH for r in res)
        for b, r in zip(blobs, res):
            ref = cr.decode_baseline(b)
            assert r.rgb.device.type == "cpu" and tuple(r.rgb.shape) == \
                ref.shape
            assert np.abs(r.rgb.numpy().astype(int)
                          - ref.astype(int)).max() <= 1
        assert {r.bucket for r in res}

    def test_serve_stats_shape(self):
        api.clear_decode_programs()
        with service() as svc:
            [f.result(timeout=TIMEOUT)
             for f in svc.submit_many(corpus(BATCH))]
            stats = svc.serve_stats()
        assert stats["submitted"] == stats["completed"] == BATCH
        assert stats["batches"] == 1
        assert stats["occupancy_mean"] == BATCH
        assert stats["deadline_misses"] == 0
        assert stats["latency_ms"]["p99"] >= stats["latency_ms"]["p50"] > 0
        assert len(stats["admitted_buckets"]) == 1
        assert sum(v["misses"] for v in stats["buckets"].values()) == 1
        progs = stats["programs"]
        assert progs["programs"] == 1 and progs["allocations"] == 1
        assert progs["device_bytes"] > 0

    def test_coeffs_emit(self):
        blobs = corpus(BATCH)
        with service(emit="coeffs") as svc:
            res = [f.result(timeout=TIMEOUT) for f in svc.submit_many(blobs)]
        for b, r in zip(blobs, res):
            img = cr.parse_jpeg(b)
            exp = cr.undiff_dc(img, cr.decode_coefficients(img))
            np.testing.assert_array_equal(r.coeffs.numpy(), exp)
            assert r.rgb is None

    def test_submit_after_close_raises(self):
        svc = service()
        svc.close(timeout=TIMEOUT)
        with pytest.raises(ServiceClosed):
            svc.submit(blob(0))

    def test_refuses_to_start_without_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DecodeService(ServiceConfig())
        with pytest.raises(ValueError):
            ServiceConfig(emit="planes")


class TestFormerEdgeCases:
    def test_sparse_queue_partial_flush_on_deadline(self):
        with service(max_form_ms=25.0) as svc:
            t0 = time.perf_counter()
            res = [f.result(timeout=TIMEOUT)
                   for f in svc.submit_many(corpus(BATCH - 2))]
            waited = time.perf_counter() - t0
        assert all(r.status == 0 for r in res)
        assert all(r.batch_images == BATCH - 2 for r in res)
        assert waited < 60.0

    def test_partial_flush_pads_do_not_change_image_count(self):
        with service() as svc:
            res = [f.result(timeout=TIMEOUT)
                   for f in svc.submit_many(corpus(3))]
            admitted = svc.serve_stats()["admitted_buckets"]
        assert len(admitted) == 1
        assert f"b{BATCH}:" in admitted[0]
        assert all(r.bucket == admitted[0] for r in res)

    def test_oversized_request_typed_rejection_no_cache_entry(self):
        api.clear_decode_programs()
        with service(max_words=64) as svc:
            fut = svc.submit(blob(0))
            with pytest.raises(RequestTooLarge) as ei:
                fut.result(timeout=30)
            stats = svc.serve_stats()
        assert ei.value.reason == "too_large"
        assert stats["rejected"] == {"too_large": 1}
        assert stats["admitted_buckets"] == []
        assert stats["batches"] == 0
        assert len(api.decode_programs()) == 0

    def test_shutdown_drains_in_flight_work(self):
        blobs = corpus(3 * BATCH)
        svc = service()
        futs = svc.submit_many(blobs)
        svc.close(drain=True, timeout=TIMEOUT)
        res = [f.result(timeout=60) for f in futs]
        assert all(r.status == 0 for r in res)
        assert svc.serve_stats()["completed"] == len(blobs)

    def test_shutdown_without_drain_fails_pending_typed(self):
        svc = service(max_form_ms=10_000.0)  # hold the batch open
        futs = svc.submit_many(corpus(2))
        svc.close(drain=False, timeout=TIMEOUT)
        for f in futs:
            with pytest.raises((ServiceClosed, RequestRejected)):
                f.result(timeout=60)

    def test_queue_limit_sheds_typed(self):
        svc = service(queue_limit=2, max_form_ms=10_000.0)
        try:
            futs = svc.submit_many(corpus(4))
            for f in futs[2:]:
                with pytest.raises(QueueFull):
                    f.result(timeout=30)
        finally:
            svc.close(drain=False, timeout=TIMEOUT)


class TestAdmissionControl:
    def test_new_bucket_beyond_budget_rejected(self):
        with service(max_buckets=1) as svc:
            ok = [f.result(timeout=TIMEOUT)
                  for f in svc.submit_many(corpus(BATCH))]
            assert all(r.status == 0 for r in ok)
            for f in svc.submit_many(corpus(BATCH, w=16, h=16)):
                with pytest.raises(BucketAdmissionError) as ei:
                    f.result(timeout=60)
                assert ei.value.reason == "admission"
            stats = svc.serve_stats()
        assert len(stats["admitted_buckets"]) == 1
        assert stats["rejected"]["admission"] == BATCH

    def test_wait_admission_bounded_by_deadline(self):
        with service(max_buckets=1, admission="wait", wait_retry_ms=5.0,
                     max_form_ms=5.0) as svc:
            [f.result(timeout=TIMEOUT)
             for f in svc.submit_many(corpus(BATCH))]
            futs = svc.submit_many(corpus(BATCH, w=16, h=16),
                                   deadline_ms=150.0)
            for f in futs:
                with pytest.raises(DeadlineExceeded) as ei:
                    f.result(timeout=60)
                assert ei.value.reason == "deadline"
            assert len(svc.serve_stats()["admitted_buckets"]) == 1

    def test_partial_batch_rides_admitted_covering_bucket(self):
        with service() as svc:
            [f.result(timeout=TIMEOUT)
             for f in svc.submit_many(corpus(BATCH))]
            [f.result(timeout=TIMEOUT) for f in svc.submit_many(corpus(2))]
            stats = svc.serve_stats()
        assert len(stats["admitted_buckets"]) == 1
        bucket = stats["admitted_buckets"][0]
        assert stats["buckets"][bucket] == {"hits": 1, "misses": 1}


class TestQuarantineFlow:
    def test_damaged_requests_never_stall_the_queue(self):
        """validate=True: a truncated header, a cut scan and a flipped bit
        resolve with their validated status beside clean requests."""
        from repro_torch.core.bitstream import validate_blob
        good = corpus(BATCH)
        start = good[1].index(b"\xff\xda")
        bad = [good[0][:40], good[1][:start + (len(good[1]) - start) // 2]]
        with service(validate=True) as svc:
            res = [f.result(timeout=TIMEOUT)
                   for f in svc.submit_many(good + bad)]
        assert all(r.status == 0 for r in res[:BATCH])
        for b, r in zip(bad, res[BATCH:]):
            assert r.status == validate_blob(b).status != 0
            assert r.error
        assert res[BATCH].status == 2 and res[BATCH].rgb is None

    def test_strict_mode_rejects_damage_before_batching(self):
        with service(validate=False) as svc:
            fut = svc.submit(b"\xff\xd8 not a jpeg")
            with pytest.raises(RequestRejected) as ei:
                fut.result(timeout=30)
            assert ei.value.reason == "damaged"
            assert svc.serve_stats()["batches"] == 0


class TestOpenLoop:
    def test_poisson_open_loop_summary(self):
        blobs = corpus(BATCH)
        with service() as svc:
            svc.prewarm(blobs)
            svc.reset_stats()
            load = run_open_loop(svc, blobs, n_requests=3 * BATCH,
                                 rate_ips=300.0, seed=0,
                                 deadline_ms=30_000.0, timeout_s=TIMEOUT)
        assert load["completed"] == 3 * BATCH
        assert load["rejected"] == {}
        assert load["p99_ms"] >= load["p50_ms"] > 0
        assert load["ips"] > 0
        assert load["deadline_misses"] == 0
