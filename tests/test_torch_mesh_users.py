"""The users of the mesh decode, on CPU blocks, and its two contracts.

The decode service with ``mesh=``, the VLM pipeline with ``mesh=`` (its
tokens the single-device pipeline's, bit for bit),
``jpeg_stream_dryrun(mesh=)``, ``decode_multihost(mesh="local")`` in two
processes of two CPU blocks each, and the traced-program checker's
collective-accounting and words-donated-mesh on a mesh of two blocks,
clean on the mesh cells.
"""
import numpy as np
import torch

from _torch_corpus import synth_image
from _torch_multiproc import run_processes
from repro.jpeg import codec_ref as cr
from repro_torch.analysis import trace_check as T
from repro_torch.core import api
from repro_torch.data.jpeg_pipeline import JpegVisionPipeline
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.report import jpeg_stream_dryrun
from repro_torch.serve import DecodeService, ServiceConfig

CPU = torch.device("cpu")


def _blobs(n=3, restart=0):
    return [cr.encode_baseline(synth_image(24, 32, seed=20 + i), quality=85,
                               restart_interval=restart).jpeg_bytes
            for i in range(n)]


def test_service_with_mesh():
    blobs = _blobs()
    cfg = dict(device="cpu", batch_size=3, chunk_bits=128, seq_chunks=4,
               max_form_ms=5.0)
    with DecodeService(ServiceConfig(mesh=Mesh([CPU] * 2), **cfg)) as svc:
        got = [f.result(timeout=120) for f in [svc.submit(b)
                                               for b in blobs]]
    ref = api.decode_batch(blobs, chunk_bits=128, seq_chunks=4,
                           device="cpu")
    for i, r in enumerate(got):
        assert torch.equal(r.rgb, ref.rgb[i])


def test_pipeline_and_dryrun_with_mesh():
    blobs = _blobs(restart=2)
    kw = dict(patch=8, embed_dim=32, chunk_bits=128)
    one = JpegVisionPipeline(device="cpu", **kw)
    two = JpegVisionPipeline(mesh=Mesh([CPU] * 2), balance="lpt", **kw)
    assert two.device == CPU
    a, sa = one.patches_for(blobs)
    b, sb = two.patches_for(blobs)
    assert torch.equal(a, b) and sa.sync_rounds == sb.sync_rounds
    assert sb.compiled and not two.patches_for(blobs)[1].compiled
    stats = jpeg_stream_dryrun(2, batch_size=2, width=16, height=16,
                               chunk_bits=128, mesh=Mesh([CPU] * 2))
    assert stats["batches"] == 2


def test_multihost_local_mesh():
    """Two processes of two CPU blocks each: every process's coefficients
    equal its slice of a one-process decode of the whole corpus."""
    blobs = _blobs(n=4, restart=2)
    out = run_processes("""
        import torch
        from repro_torch.launch.mesh import Mesh
        from repro_torch.launch.multihost import HostFeed, decode_multihost
        from test_torch_mesh_users import _blobs
        feed = HostFeed.from_corpus(_blobs(n=4, restart=2), ctx)
        res = decode_multihost(feed.local_blobs, ctx, chunk_bits=128,
                               seq_chunks=4, device="cpu",
                               mesh=Mesh([torch.device("cpu")] * 2))
        emit({"offset": res.global_coeffs.offset,
              "blocks": res.local.mesh["blocks"],
              "coeffs": res.local.coeffs.numpy().tolist()})
    """, 2, timeout=120)
    ref = api.decode_batch(blobs, chunk_bits=128, seq_chunks=4,
                           device="cpu", emit="coeffs").coeffs.numpy()
    for r in out:
        c = np.asarray(r["coeffs"], dtype=np.int32)
        assert r["blocks"] == 2
        np.testing.assert_array_equal(c, ref[r["offset"]:r["offset"]
                                             + len(c)])


def test_mesh_contracts_clean():
    """Both mesh contracts on the checker's mesh cells: no violation, and
    copies between blocks of every kind the cell makes (their seeds are
    in test_torch_trace_check_seeds.py)."""
    report = T.check(device="cpu", cells=[], meshes=True)
    assert report.ok and len(report.meshes) == 2
    halo, maps = report.meshes
    assert halo.copies == halo.expected and halo.copies["halo"] > 0
    assert maps.copies == maps.expected and maps.copies["maps"] > 0
    assert "on 2 mesh cells: collective-accounting" in report.lines()[-1]
