"""The VLM input pipeline (``repro_torch.data.jpeg_pipeline``) and the
dataset encoder against the JAX package's, on the CPU.

Tolerances: encoder bytes, weights, patch vectors and integer stats are
bit-identical; tokens may differ by one bf16 ulp of the JAX value
(``rtol=2**-7``, ``atol=2**-9``: the two CPU matmuls sum in different
orders).
"""
import dataclasses
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import clear_decode_programs as r_clear_decode_programs
from repro.data.jpeg_pipeline import JpegVisionPipeline as RPipeline
from repro.jpeg import encoder as RE
from repro.jpeg import codec_ref as cr
from repro_torch.core import api
from repro_torch.core.bitstream import STATUS_OK, STATUS_REJECTED
from repro_torch.data.jpeg_pipeline import JpegVisionPipeline, embed_from_jax
from repro_torch.jpeg import encoder as E
from repro_torch.jpeg.encoder import DatasetSpec, build_dataset

import _corrupt as cc
from _torch_corpus import synth_image

TOKEN_TOL = dict(rtol=2 ** -7, atol=2 ** -9)


def pipe(**kw) -> JpegVisionPipeline:
    return JpegVisionPipeline(device="cpu", **kw)


def _blob(seed=1, restart=0, quality=85, sub="4:4:4", size=(32, 32)):
    return cr.encode_baseline(synth_image(*size, seed=seed), quality=quality,
                              subsampling=sub,
                              restart_interval=restart).jpeg_bytes


def _zero_app0_len(blob):
    """Fatal header damage: APP0 length 0."""
    bad = bytearray(blob)
    bad[5] = 0x00
    bad[4] = 0x00
    return bytes(bad)


def _cut_scan(blob, frac=3):
    start, end = cc.scan_span(blob)
    return blob[: start + (end - start) * (frac - 1) // frac]


def _tokens(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t.astype(jnp.float32))


# ---------------------------------------------------------------------------
# The encoder: bytes, registry and scaling equal the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    DatasetSpec("a", n_images=3, width=64, height=48, quality=80),
    DatasetSpec("b", n_images=2, width=40, height=24, quality=60,
                subsampling="4:2:2", restart_interval=2),
    DatasetSpec("c", n_images=2, width=48, height=32, quality=95,
                subsampling="4:4:4"),
], ids=lambda s: s.name)
def test_encoder_bytes_equal_repro(spec):
    ref_spec = RE.DatasetSpec(**dataclasses.asdict(spec))
    for seed in (0, 7):
        ds = build_dataset(spec, seed=seed, keep_truth=True)
        ref = RE.build_dataset(ref_spec, seed=seed, keep_truth=True)
        assert ds.jpeg_bytes == ref.jpeg_bytes
        assert all(np.array_equal(a, b) for a, b in
                   zip(ds.coeff_zigzag, ref.coeff_zigzag))
        assert ds.compressed_mb == ref.compressed_mb
    rng, ref_rng = (np.random.default_rng(3), np.random.default_rng(3))
    assert np.array_equal(E.synth_frame(rng, 40, 24, 0.26, detail=0.5),
                          RE.synth_frame(ref_rng, 40, 24, 0.26, detail=0.5))


def test_paper_datasets_and_scaling_equal_repro():
    assert E.QSCALE_TO_QUALITY == RE.QSCALE_TO_QUALITY
    assert set(E.PAPER_DATASETS) == {
        "newyork", "stata", "tos_1440p", "tos_4k", "tos_8", "tos_14",
        "tos_20"}
    for name, spec in E.PAPER_DATASETS.items():
        ref = RE.PAPER_DATASETS[name]
        assert dataclasses.asdict(spec) == dataclasses.asdict(ref)
        for scale in (0.001, 0.01, 0.05, 0.3, 1.0, 2.0):
            assert dataclasses.asdict(E.scaled_spec(spec, scale)) == \
                dataclasses.asdict(RE.scaled_spec(ref, scale))
    s = E.scaled_spec(E.PAPER_DATASETS["newyork"], 0.01)
    assert s.n_images >= 2 and s.width % 16 == 0
    q = {k: E.PAPER_DATASETS[k].quality for k in ("tos_8", "tos_14",
                                                   "tos_20")}
    assert q["tos_8"] > q["tos_14"] > q["tos_20"]


def test_dataset_cache_holds_only_the_ports_pickles(tmp_path):
    spec = DatasetSpec("cached", n_images=2, width=32, height=32, quality=70)
    ds = build_dataset(spec, cache_dir=str(tmp_path))
    RE.build_dataset(RE.DatasetSpec(**dataclasses.asdict(spec)),
                     cache_dir=str(tmp_path))
    names = sorted(p.name for p in tmp_path.iterdir())
    assert len(names) == 2  # one file per package, never shared
    ours = [n for n in names if n.startswith("repro_torch_")]
    assert len(ours) == 1
    again = build_dataset(spec, cache_dir=str(tmp_path))
    assert type(again) is E.Dataset and again.jpeg_bytes == ds.jpeg_bytes


# ---------------------------------------------------------------------------
# Weights, patch vectors and tokens against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,patch,dim", [(0, 16, 1024), (3, 8, 32)])
def test_w_embed_bit_identical_and_round_trip(seed, patch, dim):
    ref = RPipeline(patch=patch, embed_dim=dim, seed=seed, backend="jnp")
    w = np.asarray(ref.w_embed.astype(jnp.float32))
    mine = pipe(patch=patch, embed_dim=dim, seed=seed)
    assert mine.w_embed.dtype == torch.bfloat16
    assert np.array_equal(mine.w_embed.float().numpy(), w)
    t = embed_from_jax(w)
    assert t.dtype == torch.bfloat16 and torch.equal(t, mine.w_embed)
    other = pipe(patch=patch, embed_dim=dim, seed=seed + 1)
    assert not torch.equal(other.w_embed, mine.w_embed)
    other.load_embed(w)
    assert torch.equal(other.w_embed, mine.w_embed)
    with pytest.raises(ValueError, match="embedding shape"):
        other.load_embed(w[:, :-1])


def test_patch_vectors_bit_identical():
    """With an identity embedding the tokens are the patch vectors (x * 1
    and sums with zeros are exact): the port's scale and patch layout equal
    the JAX pipeline's expression bit for bit."""
    p, b, h, w = 8, 2, 24, 40
    rgb = np.random.default_rng(0).integers(0, 256, (b, h, w, 3),
                                            dtype=np.uint8)
    x = jnp.asarray(rgb)[:, : h // p * p, : w // p * p].astype(
        jnp.bfloat16) / 255.0
    x = x.reshape(b, h // p, p, w // p, p, 3).transpose(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, (h // p) * (w // p), p * p * 3)
    mine = pipe(patch=p, embed_dim=p * p * 3)
    mine.load_embed(np.eye(p * p * 3, dtype=np.float32))
    got = mine.embed(torch.from_numpy(rgb))
    assert np.array_equal(_tokens(got), _tokens(x))


def _clean(n=3, size=(32, 32)):
    return [_blob(seed=s, restart=2, sub="4:2:0", size=size)
            for s in range(1, n + 1)]


CASES = {
    "clean": (lambda: _clean(), False),
    "clean-validated": (lambda: _clean(), True),
    "mixed": (lambda: [(c := _clean())[0], _zero_app0_len(c[1]),
                       _cut_scan(c[2])], True),
    "all-rejected": (lambda: [b"junk", b"more junk"], True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_tokens_and_stats_equal_repro(case):
    make, validate = CASES[case]
    blobs = make()
    # both program caches empty: a quarantined batch borrows a cached
    # bucket that covers it, so the caches' history must be the same
    api.clear_decode_programs()
    r_clear_decode_programs()
    kw = dict(patch=8, embed_dim=48, chunk_bits=256, validate=validate)
    ref = RPipeline(backend="jnp", **kw)
    mine = pipe(**kw)
    rt, rs = ref.patches_for(blobs)
    mt, ms = mine.patches_for(blobs)
    assert tuple(mt.shape) == tuple(rt.shape) and mt.dtype == torch.bfloat16
    np.testing.assert_allclose(_tokens(mt), _tokens(rt), **TOKEN_TOL)
    for f in ("n_images", "sync_rounds", "compressed_mb", "decoded_mb",
              "bucket", "compiled", "images_recovered", "images_rejected"):
        assert getattr(ms, f) == getattr(rs, f), f
    if rs.status is None:
        assert ms.status is None
    else:
        assert np.array_equal(ms.status, np.asarray(rs.status))
    a, b = mine.decode_stats(), ref.decode_stats()
    for k in ("batches", "compile_count", "buckets", "active_bucket",
              "sync_rounds", "transfer_saving", "images_ok",
              "images_recovered", "images_rejected", "fuse",
              "inter_stage_hbm_bytes", "process_id", "process_count"):
        assert a[k] == b[k], k
    assert "jaxpr_eqns" not in a and a["kernel_launches"] == 0


# ---------------------------------------------------------------------------
# Ports of tests/test_jpeg_pipeline.py
# ---------------------------------------------------------------------------

def test_pipeline_patches_shape_and_stats():
    ds = build_dataset(DatasetSpec("t", n_images=4, width=64, height=48,
                                   quality=80))
    tokens, stats = pipe(patch=8, embed_dim=64, chunk_bits=256).patches_for(
        ds.jpeg_bytes)
    assert tuple(tokens.shape) == (4, (48 // 8) * (64 // 8), 64)
    assert tokens.dtype == torch.bfloat16
    assert torch.isfinite(tokens.float()).all()
    assert stats.n_images == 4 and stats.compressed_mb > 0
    assert stats.transfer_saving > 1.0


def test_decoder_cache_keys_on_content_not_shape():
    """Reversing a 2-image batch keeps (count, total_bytes) while changing
    every output pixel: each batch must decode its own images."""
    a, b = build_dataset(DatasetSpec("t3", n_images=2, width=64, height=48,
                                     quality=80)).jpeg_bytes
    p = pipe(patch=8, embed_dim=32, chunk_bits=256)
    tok_ab, _ = p.patches_for([a, b])
    tok_ba, _ = p.patches_for([b, a])
    assert len(p._decoders) == 2
    exp_ba, _ = pipe(patch=8, embed_dim=32, chunk_bits=256).patches_for(
        [b, a])
    assert torch.equal(tok_ba, exp_ba)
    assert torch.equal(tok_ab[0], tok_ba[1])
    assert not torch.equal(tok_ab, tok_ba)


def test_decoder_cache_is_bounded_lru():
    blobs = build_dataset(DatasetSpec("t5", n_images=4, width=32, height=32,
                                      quality=70)).jpeg_bytes
    p = pipe(patch=8, embed_dim=32, chunk_bits=128, decoder_cache_size=2)
    batches = [[blobs[i]] for i in range(3)]
    for b in batches:
        p.patches_for(b)
    assert len(p._decoders) == 2
    assert p._batch_key(batches[0]) not in p._decoders
    assert p._batch_key(batches[2]) in p._decoders
    # a hit refreshes recency: touch batch 1, insert batch 0, batch 2 evicts
    p.patches_for(batches[1])
    p.patches_for(batches[0])
    assert p._batch_key(batches[1]) in p._decoders
    assert p._batch_key(batches[2]) not in p._decoders
    nocache = pipe(patch=8, embed_dim=32, chunk_bits=128,
                   decoder_cache_size=0)
    nocache.patches_for(batches[0])
    assert len(nocache._decoders) == 0
    with pytest.raises(ValueError, match="decoder_cache_size"):
        pipe(decoder_cache_size=-1)


def test_cache_size_zero_streams_through_shared_programs():
    """decoder_cache_size=0 returns a fresh, usable handle every call, pins
    nothing afterwards, and still decodes in the shared per-bucket program:
    one allocation."""
    api.clear_decode_programs()
    blobs = build_dataset(DatasetSpec("t7", n_images=2, width=32, height=32,
                                      quality=70)).jpeg_bytes
    p = pipe(patch=8, embed_dim=32, chunk_bits=128, decoder_cache_size=0)
    tok1, st1 = p.patches_for(blobs)
    assert len(p._decoders) == 0 and st1.compiled
    tok2, st2 = p.patches_for(blobs)
    assert len(p._decoders) == 0 and not st2.compiled
    assert torch.equal(tok1, tok2)
    assert [q.allocations for q in api.decode_programs()] == [1]
    dec = p._decoder(blobs)
    assert dec.decode(emit="coeffs").converged and len(p._decoders) == 0


def test_pipeline_batches_iterator_and_tail():
    ds = build_dataset(DatasetSpec("t6", n_images=7, width=32, height=32,
                                   quality=70))
    p = pipe(patch=8, embed_dim=32, chunk_bits=128)
    batches = list(p.batches(ds, batch_size=3))
    assert [t.shape[0] for t, _ in batches] == [3, 3, 1]
    assert sum(s.n_images for _, s in batches) == 7
    dropped = list(p.batches(ds, batch_size=3, drop_remainder=True))
    assert [t.shape[0] for t, _ in dropped] == [3, 3]
    assert [t.shape[0] for t, _ in p.batches(ds, batch_size=10)] == [7]
    assert list(p.batches(ds, batch_size=10, drop_remainder=True)) == []


def test_pipeline_stream_allocates_once_per_bucket():
    """The counterpart of test_plan_buckets'
    test_pipeline_stream_compiles_once_per_bucket: a stream of distinct
    batches allocates each bucket's program once."""
    api.clear_decode_programs()
    ds = build_dataset(DatasetSpec("bucket-stream", n_images=20, width=32,
                                   height=32, quality=75))
    p = pipe(patch=8, embed_dim=32, chunk_bits=128, decoder_cache_size=0)
    for _ in p.batches(ds, batch_size=2):
        pass
    st = p.decode_stats()
    assert st["batches"] == 10
    progs = api.decode_programs()
    assert 1 <= len(progs) <= 3
    assert all(q.allocations == 1 for q in progs)
    assert st["compile_count"] == len(progs)
    assert set(st["buckets"]) == {q.shape.label() for q in progs}
    assert st["warm_step_ms"] > 0.0 and st["active_bucket"]


def test_balance_passes_to_the_decoder():
    blobs = _clean(2)
    p = pipe(patch=8, embed_dim=32, chunk_bits=128, balance="lpt")
    tokens, _ = p.patches_for(blobs)
    ref, _ = pipe(patch=8, embed_dim=32, chunk_bits=128).patches_for(blobs)
    assert torch.equal(tokens, ref)
    # on the CPU a balanced plan has one lane block: the identity plan
    assert next(iter(p._decoders.values())).plan.n_lanes == 1
    with pytest.raises(ValueError, match="unknown lane balance"):
        pipe(balance="greedy").patches_for(blobs)


# ---------------------------------------------------------------------------
# Ports of tests/test_resilience.py's pipeline tests
# ---------------------------------------------------------------------------

class TestPipelineResilience:
    def test_status_and_counters_through_pipeline(self):
        clean = [_blob(seed=s, restart=2) for s in (1, 2, 3)]
        p = pipe(patch=16, embed_dim=32, chunk_bits=256, validate=True)
        tokens, stats = p.patches_for(
            [clean[0], _zero_app0_len(clean[1]), clean[2]])
        assert tokens.shape[0] == 3
        assert list(stats.status) == [STATUS_OK, STATUS_REJECTED, STATUS_OK]
        assert (stats.images_recovered, stats.images_rejected) == (0, 1)
        p.patches_for([clean[0], _cut_scan(clean[1]), clean[2]])
        ds = p.decode_stats()
        assert ds["images_ok"] == 4
        assert ds["images_recovered"] == 1
        assert ds["images_rejected"] == 1

    def test_all_quarantined_batch_keeps_streaming(self):
        p = pipe(patch=16, embed_dim=32, chunk_bits=256, validate=True)
        tokens, stats = p.patches_for([b"junk", b"more junk"])
        assert tuple(tokens.shape) == (2, 0, 32)
        assert tokens.dtype == torch.bfloat16
        assert list(stats.status) == [STATUS_REJECTED, STATUS_REJECTED]

    def test_unvalidated_pipeline_reports_no_status(self):
        p = pipe(patch=16, embed_dim=32, chunk_bits=256)
        _, stats = p.patches_for([_blob(seed=1)])
        assert stats.status is None
        assert p.decode_stats()["images_ok"] == 0


# ---------------------------------------------------------------------------
# The port of tests/test_serve.py's threaded counters
# ---------------------------------------------------------------------------

def test_threaded_counters_exact():
    """Concurrent ``patches_for`` callers lose no counter increment."""
    n_threads, per_thread, batch = 4, 3, 3
    base = [_blob(seed=s, sub="4:2:0") for s in range(batch)]
    p = pipe(patch=8, embed_dim=32, chunk_bits=256, validate=True,
             sync_stats=True)
    batches = {t: [base[(t + i) % batch:] + base[:(t + i) % batch]
                   for i in range(per_thread)] for t in range(n_threads)}
    barrier = threading.Barrier(n_threads)
    errs = []

    def run(t):
        try:
            barrier.wait(timeout=30)
            for b in batches[t]:
                p.patches_for(b)
        except Exception as e:  # reported below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    stats = p.decode_stats()
    assert stats["batches"] == n_threads * per_thread
    assert stats["images_ok"] == n_threads * per_thread * batch
    assert stats["images_recovered"] == stats["images_rejected"] == 0
    assert sum(stats["buckets"].values()) == n_threads * per_thread
