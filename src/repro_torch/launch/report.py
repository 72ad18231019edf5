"""Tables of the dry runs: the model dry run's cells and rooflines
(:func:`render`), the JPEG decode stream and the decode service.

The port of the JAX package's ``launch/report.py``, over the port's
dry run (``launch.dryrun``), pipeline and decode service::

  PYTHONPATH=src python -m repro_torch.launch.report results/dryrun/dryrun.json
"""
from __future__ import annotations

import json
import sys


def fmt_bytes(b):
    if b is None:
        return "-"
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(b) < 1024:
            return f"{b:.2f}{unit}"
        b /= 1024
    return f"{b:.2f}PiB"


def fmt_s(s):
    if s is None:
        return "-"
    if s < 1e-3:
        return f"{s*1e6:.1f}us"
    if s < 1.0:
        return f"{s*1e3:.2f}ms"
    return f"{s:.2f}s"


def render_decode_stats(stats: dict) -> str:
    """Render ``JpegVisionPipeline.decode_stats()`` (the streaming decode
    counters) as the EXPERIMENTS.md §Decode-stream table.

    Surfaced by the ``--jpeg-stream`` dry-runs in ``launch/serve.py`` /
    ``launch/train.py``: compile count vs batches is the compile-once
    check (one trace per capacity bucket x stage), warm-step ms the
    steady-state input-pipeline cost.
    """
    out = []
    out.append("### Decode stream (plan buckets)\n")
    hosts = stats.get("hosts")
    per_host = hosts if hosts else [stats]
    # resilience columns appear only when some host actually saw damage —
    # clean streams keep the familiar narrow table
    damaged = any(st.get("images_recovered", 0) or st.get("images_rejected", 0)
                  for st in per_host)
    cols = "| batches | compiles | cold step | warm step | sync rounds " \
           "| transfer saving | active bucket |"
    sep = "|---|---|---|---|---|---|---|"
    if damaged:
        cols += " ok | recovered | rejected |"
        sep += "---|---|---|"
    if hosts:
        cols = "| host " + cols
        sep = "|---" + sep
    out.append(cols)
    out.append(sep)
    for st in per_host:
        row = (
            f"| {st.get('batches', 0)} | {st.get('compile_count', 0)} "
            f"| {fmt_s(st.get('cold_step_ms', 0.0) / 1e3)} "
            f"| {fmt_s(st.get('warm_step_ms', 0.0) / 1e3)} "
            f"| {st.get('sync_rounds', 0)} "
            f"| {st.get('transfer_saving', 0.0):.1f}x "
            f"| `{st.get('active_bucket', '')}` |")
        if damaged:
            row += (f" {st.get('images_ok', 0)} "
                    f"| {st.get('images_recovered', 0)} "
                    f"| {st.get('images_rejected', 0)} |")
        if hosts:
            row = (f"| {st.get('process_id', 0)}/"
                   f"{st.get('process_count', 1)} " + row)
        out.append(row)
    if hosts:
        # per-host bucket maps: a host stuck bouncing between buckets is
        # exactly what this surface exists to expose, so never collapse
        # the footer to the main host's counters
        for st in per_host:
            bk = st.get("buckets") or {}
            if bk:
                out.append(
                    f"\nhost {st.get('process_id', 0)} buckets "
                    "(batches per bucket): " + ", ".join(
                        f"`{k}`: {v}" for k, v in sorted(bk.items())))
    else:
        buckets = stats.get("buckets") or {}
        if buckets:
            out.append("\nbuckets seen (batches per bucket): " + ", ".join(
                f"`{k}`: {v}" for k, v in sorted(buckets.items())))
    return "\n".join(out)


def jpeg_stream_dryrun(n_batches: int, batch_size: int = 4,
                       backend=None, sync: str = "jacobi",
                       width: int = 32, height: int = 32,
                       chunk_bits: int = 256, device=None,
                       ctx=None, mesh=None) -> dict:
    """Stream ``n_batches`` distinct synthetic JPEG batches through a
    ``JpegVisionPipeline`` and return its ``decode_stats()``.

    The ``--jpeg-stream N`` flag of ``launch/serve.py`` runs this before
    the model run so a dry run surfaces the decode-side streaming
    counters (compile count vs batches, warm-step ms, active bucket) next
    to the model numbers — pass the result to :func:`render_decode_stats`.

    ``device`` is where the pipeline decodes (``"cuda"``, the default
    without a mesh, raises without a card; ``"cpu"`` runs the plain
    versions); ``mesh`` splits each batch's decode over the mesh's
    devices (``JpegVisionPipeline(mesh=)``). With a multi-process ``ctx``
    (:func:`repro_torch.launch.multihost.init_distributed`), the corpus is
    sharded per host (:class:`~repro_torch.launch.multihost.HostFeed`):
    every process streams only its own slice, and the returned dict
    additionally carries ``hosts`` — the per-host stats gathered over the
    store, one entry per process (compile counters stay per-host; see
    ``decode_stats``).
    """
    from ..data.jpeg_pipeline import JpegVisionPipeline
    from ..jpeg.encoder import DatasetSpec, build_dataset
    from .multihost import HostFeed, gather_decode_stats

    ds = build_dataset(DatasetSpec("jpeg-stream-dryrun",
                                   n_images=n_batches * batch_size,
                                   width=width, height=height, quality=80))
    pipe = JpegVisionPipeline(patch=8, embed_dim=64, chunk_bits=chunk_bits,
                              backend=backend, sync=sync, device=device,
                              mesh=mesh, decoder_cache_size=0,
                              sync_stats=True)
    if ctx is not None and ctx.num_processes > 1:
        feed = HostFeed.from_corpus(ds.jpeg_bytes, ctx)
        for batch in feed.batches(batch_size):
            pipe.patches_for(batch)
        stats = pipe.decode_stats()
        stats["hosts"] = gather_decode_stats(stats, ctx)
        return stats
    for _ in pipe.batches(ds, batch_size=batch_size):
        pass
    return pipe.decode_stats()


def render_serve_stats(stats: dict, load: dict = None) -> str:
    """Render ``DecodeService.serve_stats()`` (and optionally a
    ``run_open_loop`` summary) as the EXPERIMENTS.md §Decode-serve table.

    Surfaced by the ``--decode-serve`` dry-run in ``launch/serve.py``:
    batch occupancy vs batch size is the continuous-batching health
    check, deadline misses vs completed the SLO check, and the admitted
    bucket list the compile-budget check (admission control caps the
    program cache; see docs/SERVING.md §Serving front-end).
    """
    out = []
    out.append("### Decode serve (continuous batching)\n")
    lat = stats.get("latency_ms", {})
    out.append("| submitted | completed | batches | occupancy | deadline "
               "misses | p50 | p99 | throughput | warm batch |")
    out.append("|---|---|---|---|---|---|---|---|---|")
    out.append(
        f"| {stats.get('submitted', 0)} | {stats.get('completed', 0)} "
        f"| {stats.get('batches', 0)} "
        f"| {stats.get('occupancy_mean', 0.0):.2f}/"
        f"{stats.get('batch_size', 0)} "
        f"| {stats.get('deadline_misses', 0)} "
        f"| {fmt_s(lat.get('p50', 0.0) / 1e3)} "
        f"| {fmt_s(lat.get('p99', 0.0) / 1e3)} "
        f"| {stats.get('throughput_ips', 0.0):.1f} img/s "
        f"| {fmt_s(stats.get('warm_batch_ms', 0.0) / 1e3)} |")
    rej = stats.get("rejected") or {}
    if rej:
        out.append("\nrejections: " + ", ".join(
            f"{k}: {v}" for k, v in sorted(rej.items())))
    buckets = stats.get("buckets") or {}
    if buckets:
        out.append(
            f"\nadmitted buckets ({len(buckets)}/"
            f"{stats.get('max_buckets', 0)}, batches as hits+misses): "
            + ", ".join(f"`{k}`: {v.get('hits', 0)}+{v.get('misses', 0)}"
                        for k, v in sorted(buckets.items())))
    if load:
        out.append(
            f"\nopen loop: {load.get('n_requests', 0)} requests at "
            f"{load.get('rate_ips', 0.0):.1f} img/s -> "
            f"{load.get('completed', 0)} completed, "
            f"{load.get('deadline_misses', 0)} missed, "
            f"p50 {load.get('p50_ms', 0.0):.2f}ms / "
            f"p99 {load.get('p99_ms', 0.0):.2f}ms, "
            f"{load.get('ips', 0.0):.1f} img/s achieved")
    return "\n".join(out)


def decode_serve_dryrun(n_requests: int, batch_size: int = 4,
                        rate_ips: float = 0.0, slo_ms: float = 250.0,
                        backend=None, width: int = 32, height: int = 32,
                        chunk_bits: int = 256, seed: int = 0,
                        device="cuda") -> tuple:
    """Drive a :class:`~repro_torch.serve.DecodeService` on ``device`` with
    ``n_requests`` of open-loop traffic and return ``(serve_stats,
    load_summary)``.

    The ``--decode-serve N`` flag of ``launch/serve.py`` runs this before
    the model run — the serving analogue of ``--jpeg-stream`` — so a
    dry run surfaces the continuous-batching counters (occupancy,
    deadline misses, admitted buckets) next to the model numbers. Pass
    both results to :func:`render_serve_stats`. ``rate_ips == 0`` drains
    a saturated backlog (throughput mode); a positive rate is Poisson
    open-loop traffic against ``slo_ms``.
    """
    from ..jpeg.encoder import DatasetSpec, build_dataset
    from ..serve import DecodeService, ServiceConfig, run_open_loop

    ds = build_dataset(DatasetSpec("decode-serve-dryrun",
                                   n_images=max(n_requests, batch_size),
                                   width=width, height=height, quality=80))
    svc = DecodeService(ServiceConfig(
        batch_size=batch_size, chunk_bits=chunk_bits, backend=backend,
        slo_ms=slo_ms, device=device))
    try:
        svc.prewarm(ds.jpeg_bytes[:batch_size])
        svc.reset_stats()
        # drain mode saturates the queue, so queue wait is unbounded by
        # design — a huge deadline keeps it a throughput measurement
        load = run_open_loop(svc, ds.jpeg_bytes, n_requests=n_requests,
                             rate_ips=rate_ips, seed=seed,
                             deadline_ms=slo_ms if rate_ips > 0
                             else 600_000.0)
        stats = svc.serve_stats()
    finally:
        svc.close()
    return stats, load


def _per_card(r: dict, key: str) -> float:
    """``r[key]`` for one card: the port's rows hold a card's bytes
    (``per_card``); the JAX package's are read, as its report reads them,
    as the whole mesh's."""
    return r[key] if r.get("per_card") else r[key] / r["n_chips"]


def render(path: str) -> str:
    """The dry-run and roofline tables of a ``dryrun.json`` (the port's,
    or the JAX package's), against the H100's datasheet peaks
    (``launch.mesh.H100``), in bytes a card; a cell whose peak goes over
    a card's 80 GB is marked."""
    from .dryrun import model_flops, roofline
    from .mesh import H100
    with open(path) as f:
        rows = json.load(f)
    out = []
    out.append("### Dry-run matrix (a card)\n")
    out.append("| arch | shape | mesh | pass | peak/card | args/card | "
               "temp/card | flops/card (bf16, f32) | bytes/card | "
               "coll bytes/card |")
    out.append("|---|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        if "skipped" in r:
            out.append(f"| {r['arch']} | {r['shape']} | - | SKIP: "
                       f"{r['skipped']} | | | | | | |")
            continue
        if "error" in r:
            out.append(f"| {r['arch']} | {r['shape']} | {r.get('mesh')} | "
                       f"FAIL | | | | | | |")
            continue
        peak = r.get("peak_bytes")
        over = " **over 80 GB**" if peak and peak > H100["hbm_bytes"] \
            else ""
        split = (f" ({r['flops_bf16']:.3e}, {r['flops_f32']:.3e})"
                 if "flops_bf16" in r else "")
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['compile_s']}s "
            f"| {fmt_bytes(peak)}{over} "
            f"| {fmt_bytes(_per_card(r, 'argument_bytes'))} "
            f"| {fmt_bytes(_per_card(r, 'temp_bytes'))} "
            f"| {r.get('flops_model', 0):.3e}{split} "
            f"| {fmt_bytes(r.get('hbm_bytes_accessed_model'))} "
            f"| {fmt_bytes(r.get('collective_bytes_model', r.get('collective_bytes', 0)))} |")

    out.append("\n### Roofline (H100 SXM5 80GB datasheet peaks, 700 W; "
               "a step)\n")
    out.append("| arch | shape | mesh | compute | memory | collective | "
               "dominant | bound | MODEL_FLOPS/counted | roofline frac |")
    out.append("|---|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        if "flops_model" not in r:
            continue
        rf = roofline(r)
        mf = model_flops(r["arch"], r["shape"])
        frac = mf / (r["flops_model"] * r["n_chips"]) \
            if r["flops_model"] else 0
        # fraction of roofline achieved = ideal compute time over bound
        ideal = mf / (r["n_chips"] * H100["peak_flops_bf16"])
        achieved = ideal / rf["bound_s"] if rf["bound_s"] else 0.0
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {fmt_s(rf['compute_s'])} | {fmt_s(rf['memory_s'])} "
            f"| {fmt_s(rf['collective_s'])} | **{rf['dominant']}** "
            f"| {fmt_s(rf['bound_s'])} | {frac:.2f} | {achieved:.2f} |")
    return "\n".join(out)


if __name__ == "__main__":
    print(render(sys.argv[1] if len(sys.argv) > 1 else
                 "results/dryrun/dryrun.json"))
