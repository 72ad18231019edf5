"""The port's LM/VLM serving path (``repro_torch.serve.step``,
``repro_torch.launch.serve``, ``repro_torch.launch.report``) against the
JAX package's, on the CPU, at smoke size.

Tolerances: the step builders' bf16 logits ``rtol=0.08, atol=0.15`` (the
JAX package's own, ``tests/test_models.py``), greedy tokens equal where
the JAX logits' top-2 margin exceeds that tolerance; the top-k mask and
the report tables exactly.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as r_smoke
from repro.launch import report as RR
from repro.models import model as RM
from repro.serve import step as RS
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import report as TR
from repro_torch.launch import serve as TSV
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import step as TS

from _torch_lm import BF16_TOL, jax_flat

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "gemma-7b"])
def test_step_builders_match_repro(arch):
    cj, ct = r_smoke(arch), get_smoke_config(arch)
    m = RM.init_params(jax.random.key(1), cj)
    tm = params_from_jax(jax_flat(m.params), ct, device="cpu")
    rng = np.random.default_rng(1)
    nv = cj.n_patches if cj.frontend == "vision" else 0
    toks = rng.integers(0, cj.vocab, (2, 16)).astype(np.int32)
    bj, bt = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if nv:
        p = rng.normal(0, 1, (2, nv, 1024)).astype(np.float32)
        bj["patches"] = jnp.asarray(p, jnp.bfloat16)
        bt["patches"] = torch.from_numpy(p).to(torch.bfloat16)
    max_len = 16 + 8 + nv
    lj, caj = RS.make_prefill_step(cj, max_len)(
        m.params, bj, RM.init_caches(cj, 2, max_len))
    lt, cat = TS.make_prefill_step(ct)(
        tm, bt, TM.init_caches(ct, 2, max_len, device="cpu"))
    np.testing.assert_allclose(lt.float().numpy(),
                               np.asarray(lj.astype(jnp.float32)), **BF16_TOL)
    tok = jnp.argmax(lj[:, -1], -1)[:, None].astype(jnp.int32)
    dj, dt = RS.make_decode_step(cj), TS.make_decode_step(ct)
    for i in range(3):
        tj, lj, caj = dj(m.params, tok, 16 + nv + i, caj)
        tt, lt, cat = dt(tm, torch.from_numpy(np.array(tok)), 16 + nv + i,
                         cat)
        ref = np.asarray(lj[:, -1].astype(jnp.float32))
        np.testing.assert_allclose(lt[:, -1].float().numpy(), ref,
                                   **BF16_TOL)
        assert tt.dtype == torch.int32 and tt.shape == (2, 1)
        top2 = np.sort(ref, -1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > BF16_TOL["atol"] + \
            BF16_TOL["rtol"] * np.abs(top2[:, 1])
        np.testing.assert_array_equal(tt.numpy()[sure, 0],
                                      np.asarray(tj)[sure, 0])
        tok = tj
    with pytest.raises(ValueError, match="built for"):
        TS.make_decode_step(get_smoke_config("llama3-8b"))(tm, tt, 0, cat)


def jax_top_k_mask(l, top_k):
    """The JAX sampling step's mask (``repro/serve/step.py``), verbatim."""
    kth = jax.lax.top_k(l, top_k)[0][:, -1:]
    return jnp.where(l < kth, -1e30, l)


@pytest.mark.parametrize("top_k", [1, 5, 50])
def test_top_k_mask_equals_repro(top_k):
    rng = np.random.default_rng(top_k)
    l = rng.normal(size=(4, 512)).astype(np.float32)
    l[0, :8] = l[0, 0]  # ties at the k-th value stay
    l[1] = np.round(l[1], 1)
    got = TS.top_k_logits(torch.from_numpy(l), top_k).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_top_k_mask(
        jnp.asarray(l), top_k)))


def test_sampling_step_draws_within_top_k():
    ct = get_smoke_config("llama3-8b")
    tm = TM.init_params(torch.Generator().manual_seed(0), ct, device="cpu")
    bt = {"tokens": torch.randint(0, ct.vocab, (3, 12),
                                  generator=torch.Generator().manual_seed(1))}
    step = TS.make_sampling_decode_step(ct, temperature=0.8, top_k=5)

    def prefilled():
        logits, caches = TM.forward_prefill(
            tm, bt, TM.init_caches(ct, 3, 20, device="cpu"))
        return torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32), \
            caches

    tok, caches = prefilled()
    logits, _ = TM.forward_decode(tm, tok, 12, caches)
    top = torch.topk(logits[:, -1].float(), 5).indices
    draws = []
    for seed in (7, 7, 8):
        tok, caches = prefilled()
        nxt, _ = step(tm, tok, 12, caches,
                      torch.Generator().manual_seed(seed))
        assert nxt.dtype == torch.int32 and nxt.shape == (3, 1)
        assert all(int(nxt[i, 0]) in top[i].tolist() for i in range(3))
        draws.append(nxt)
    assert torch.equal(draws[0], draws[1])  # same generator, same draw


def test_abstract_caches_on_meta():
    cfg = get_config("llava-next-mistral-7b")
    caches = TS.abstract_caches(cfg, 4, 2984)
    assert len(caches) == 32
    assert all(c.k.device.type == "meta" and c.k.shape == (4, 2984, 8, 128)
               and c.k.dtype == torch.bfloat16 for c in caches)
    int8 = TS.abstract_caches(dataclasses.replace(
        cfg, kv_cache_dtype="int8"), 1, 16)
    assert int8[0].k.dtype == torch.int8 and int8[0].k_scale.shape == (
        1, 16, 8, 1)


# ---------------------------------------------------------------------------
# the command line and its reports
# ---------------------------------------------------------------------------

def _serve(*args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        env=env, capture_output=True, text=True, timeout=timeout, cwd=ROOT)


@pytest.mark.parametrize("extra", [[], ["--jpeg-stream", "2"]],
                         ids=["plain", "jpeg-stream"])
def test_serve_cli_runs_on_cpu(extra):
    r = _serve("--device", "cpu", "--arch", "llava-next-mistral-7b",
               "--batch", "2", "--prompt-len", "8", "--gen", "4", *extra)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "arch=llava-smoke batch=2 device=cpu" in r.stdout
    assert "decode : 3 steps" in r.stdout
    if extra:
        assert "### Decode stream (plan buckets)" in r.stdout


@pytest.mark.parametrize("arch,name", [("mamba2-780m", "mamba2-smoke"),
                                       ("whisper-base", "whisper-smoke")])
def test_serve_cli_serves_ssm_and_encdec(arch, name):
    """The SSD and encoder-decoder families serve from the command line
    (the encoder-decoder's frames drawn from the seed)."""
    r = _serve("--device", "cpu", "--arch", arch, "--batch", "2",
               "--prompt-len", "8", "--gen", "4")
    assert r.returncode == 0, r.stdout + r.stderr
    assert f"arch={name} batch=2 device=cpu" in r.stdout
    assert "decode : 3 steps" in r.stdout


def test_run_on_cpu():
    cfg = get_smoke_config("llava-next-mistral-7b")
    r = TSV.run(cfg, 2, 8, 5, device="cpu", seed=3)
    assert r.tokens.shape == (2, 5) and r.decode_steps == 4
    assert r.max_len == 8 + 5 + 8 + cfg.n_patches
    assert r.pos == 8 + cfg.n_patches + 4
    assert r.first_decode_logits.shape == (2, cfg.vocab)
    assert torch.isfinite(r.first_decode_logits).all()
    assert r.caches[0].length == 8 + cfg.n_patches + 4
    again = TSV.run(cfg, 2, 8, 5, device="cpu", seed=3)
    assert torch.equal(again.tokens, r.tokens)
    # the first decode step's logits are the prefill's of prompt + token
    caches = TM.init_caches(cfg, 2, r.max_len, device="cpu")
    batch = dict(r.batch, tokens=torch.cat([r.batch["tokens"],
                                            r.tokens[:, :1]], 1))
    logits, _ = TM.forward_prefill(r.model, batch, caches)
    np.testing.assert_allclose(r.first_decode_logits.numpy(),
                               logits[:, -1].float().numpy(), **BF16_TOL)
    with pytest.raises(ValueError, match="patches of shape"):
        TSV.run(cfg, 2, 8, 5, device="cpu",
                patches=torch.zeros(2, 3, 1024, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="no vision frontend"):
        TSV.run(get_smoke_config("llama3-8b"), 2, 8, 5, device="cpu",
                patches=torch.zeros(2, 3, 1024))


def test_entry_points_need_a_card(monkeypatch):
    """Without a card the default device raises, and nothing runs on the
    CPU unless the caller asks for it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("llama3-8b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init_params(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init_caches(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TA.init_kv_cache(1, 8, cfg.n_kv_heads, cfg.head_dim)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TL.ParamBuilder(torch.Generator())
    flat = jax_flat(RM.init_params(jax.random.key(1),
                                   r_smoke("llama3-8b")).params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax(flat, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TA.init_mla_cache(1, 8, get_smoke_config("deepseek-v2-236b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.init_caches(get_smoke_config("mamba2-780m"), 1, 8)
    # the meta device allocates nothing and needs no card
    assert TA.init_kv_cache(1, 8, 2, 4, device="meta").k.is_meta
    for served in (cfg, get_smoke_config("whisper-base")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TSV.run(served, 1, 4, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.jpeg_stream_dryrun(1, batch_size=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.decode_serve_dryrun(2, batch_size=2)


STREAM_STATS = {
    "batches": 3, "compile_count": 1, "cold_step_ms": 812.5,
    "warm_step_ms": 3.25, "sync_rounds": 7, "transfer_saving": 9.875,
    "active_bucket": "c128w4096", "buckets": {"c128w4096": 3},
}


@pytest.mark.parametrize("stats", [
    STREAM_STATS,
    dict(STREAM_STATS, images_ok=5, images_recovered=2, images_rejected=1),
    dict(STREAM_STATS, hosts=[dict(STREAM_STATS, process_id=i,
                                   process_count=2) for i in range(2)]),
], ids=["clean", "damaged", "hosts"])
def test_render_decode_stats_equals_repro(stats):
    assert TR.render_decode_stats(stats) == RR.render_decode_stats(stats)


def test_render_serve_stats_and_formats_equal_repro():
    stats = {"submitted": 10, "completed": 9, "batches": 3,
             "occupancy_mean": 3.0, "batch_size": 4, "deadline_misses": 1,
             "latency_ms": {"p50": 12.0, "p99": 2500.0},
             "throughput_ips": 41.5, "warm_batch_ms": 0.5,
             "rejected": {"queue_full": 1},
             "buckets": {"c64": {"hits": 2, "misses": 1}}, "max_buckets": 4}
    load = {"n_requests": 10, "rate_ips": 50.0, "completed": 9,
            "deadline_misses": 1, "p50_ms": 12.0, "p99_ms": 40.0,
            "ips": 41.5}
    assert TR.render_serve_stats(stats, load) == \
        RR.render_serve_stats(stats, load)
    for b in (None, 0, 1023, 5 << 20, 3 << 40, 1 << 60):
        assert TR.fmt_bytes(b) == RR.fmt_bytes(b)
    for s in (None, 5e-6, 0.25, 12.5):
        assert TR.fmt_s(s) == RR.fmt_s(s)


def test_dryruns_on_cpu():
    stats = TR.jpeg_stream_dryrun(2, batch_size=2, device="cpu")
    assert stats["batches"] == 2 and stats["compile_count"] >= 1
    assert "### Decode stream" in TR.render_decode_stats(stats)
    sstats, load = TR.decode_serve_dryrun(4, batch_size=2, device="cpu")
    assert load["completed"] == 4 and sstats["completed"] == 4
    assert "### Decode serve" in TR.render_serve_stats(sstats, load)

