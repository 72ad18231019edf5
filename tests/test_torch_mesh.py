"""The decode over a mesh (``ParallelDecoder.decode_on``) on the CPU.

``decode_on`` over ``Mesh([cpu] * 4)`` is held against ``repro``'s own
``decode_on``, run in a subprocess on four forced host devices under an
Auto-axis ``jax.sharding.Mesh`` (``jax.make_mesh`` makes Explicit axes,
which ``repro``'s sharding constraints refuse): every schedule and
balance policy, with exits, ``sync_rounds``, ``converged`` and
coefficients bit-identical and RGB within 1. Meshes of 1 to 4 blocks are
held against the port's own ``decode()`` on padded buckets, more blocks
than sequences, a quarantined blob and ``emit="planes"``; and the mesh
API: flattening, the ``rules=`` refusal, an absent card, the layout's
row ranges and the exchange's byte count.
"""
import json

import numpy as np
import pytest
import torch

import _corrupt as cc
from _multiproc import run_sub
from _torch_corpus import synth_image
from repro.jpeg import codec_ref as cr
from repro_torch.core import api
from repro_torch.core import decode as D
from repro_torch.core.mesh_decode import Sharded
from repro_torch.dist import plan as DP
from repro_torch.kernels.huffman import ops as HK
from repro_torch.launch.mesh import Mesh, make_mesh

CPU = torch.device("cpu")
KW = dict(chunk_bits=128, seq_chunks=4)
# (sync, balance, emit) run through repro's decode_on on four devices: RGB
# on a uniform batch, coefficients on the skewed one
REPRO_CASES = [("jacobi", "none", "rgb"), ("jacobi", "roundrobin", "coeffs"),
               ("jacobi", "lpt", "coeffs"), ("faithful", "none", "coeffs"),
               ("specmap", "lpt", "rgb"), ("sequential", "none", "coeffs")]


def case_blobs(emit):
    return uniform_blobs() if emit == "rgb" else skewed_blobs()


def skewed_blobs():
    """One multi-restart image plus small tails (as test_distribution's
    lane-balance test)."""
    big = cr.encode_baseline(synth_image(48, 64, seed=1, noise=20.0),
                             quality=92, restart_interval=2)
    smalls = [cr.encode_baseline(synth_image(16, 16, seed=5 + i), quality=60)
              for i in range(3)]
    return [r.jpeg_bytes for r in [big] + smalls]


def uniform_blobs(restarts=(0, 2, 0), seed=3):
    """Three 24x32 images, the first a single entropy segment, so that
    lane blocks cut inside a segment and exchange halos."""
    return [cr.encode_baseline(synth_image(24, 32, seed=seed + i),
                               quality=90, restart_interval=r).jpeg_bytes
            for i, r in enumerate(restarts)]


@pytest.fixture(scope="module")
def repro_out(tmp_path_factory):
    """repro's decode_on of REPRO_CASES, four forced host devices."""
    path = tmp_path_factory.mktemp("repro_mesh") / "out.npz"
    run_sub(f"""
        import numpy as np, jax
        from repro.core.api import decode_batch
        from test_torch_mesh import case_blobs, KW, REPRO_CASES
        mesh = jax.sharding.Mesh(np.array(jax.devices()), ("data",))
        res = {{}}
        for sync, bal, emit in REPRO_CASES:
            out = decode_batch(case_blobs(emit), sync=sync, backend="jnp", mesh=mesh,
                               balance=bal, emit=emit, **KW)
            tag = f"{{sync}}-{{bal}}"
            assert len(out.coeffs.sharding.device_set) == 4
            res[tag + "-coeffs"] = np.asarray(out.coeffs)
            res[tag + "-rounds"] = np.asarray([out.sync_rounds,
                                               out.converged])
            if emit == "rgb":
                res[tag + "-rgb"] = np.asarray(out.rgb)
        np.savez({str(path)!r}, **res)
    """, devices=4)
    return dict(np.load(path))


def single_exits(dec):
    """(lanes, 4) exit states of ``dec``'s single-card sync."""
    dev, sh = dec.dev, dec.shape
    meta = D.chunk_meta(dev)

    def exits(d, entry, idx=None, out=None):
        return HK.decode_exits_plain(d, meta, entry, idx, s_max=sh.s_max,
                                     min_code_bits=sh.min_code_bits, out=out)

    res = api.run_sync(dev, sh, dec.sync, exits)
    return torch.stack(list(res.exits), 1)


@pytest.mark.parametrize("sync,balance,emit", REPRO_CASES)
def test_decode_on_equals_repro(repro_out, sync, balance, emit):
    dec = api.ParallelDecoder.from_bytes(
        case_blobs(emit), sync=sync, device="cpu", balance=balance, lanes=4,
        **KW)
    out = dec.decode_on(Mesh([CPU] * 4), emit=emit)
    tag = f"{sync}-{balance}"
    np.testing.assert_array_equal(out.coeffs.full().numpy(),
                                  repro_out[tag + "-coeffs"])
    assert [out.sync_rounds, out.converged] == \
        repro_out[tag + "-rounds"].tolist()
    assert torch.equal(out.mesh["exits"].full(), single_exits(dec))
    assert out.mesh["blocks"] == 4 and sum(out.mesh["lanes"]) == \
        dec.shape.n_chunks
    if emit == "rgb":
        d = np.abs(out.rgb.full().numpy().astype(int)
                   - repro_out[tag + "-rgb"].astype(int))
        assert d.max() <= 1, d.max()
        print(f"rgb off by one: {int((d == 1).sum())} of {d.size}")
    assert out.mesh["copy_bytes"] == out.mesh["expected_bytes"]


def _quarantined():
    clean = uniform_blobs(restarts=(2, 2, 0))
    return [clean[0], cc.bit_flips(clean[1], n=1)[0][1], clean[2],
            b"\xff\xd8 not a jpeg"]


# (case, blocks): the batch, its options and what is compared
@pytest.mark.parametrize("case,blocks", [
    ("bucket", 1), ("bucket", 2), ("segment", 4),
    ("segment-faithful", 3), ("tiny", 4), ("quarantine", 3), ("planes", 2)])
def test_decode_on_equals_decode(case, blocks):
    kw, emit = dict(KW), "rgb"
    blobs = uniform_blobs()
    if case == "tiny":   # fewer sequences than blocks: empty blocks
        blobs = [cr.encode_baseline(synth_image(16, 16, seed=9),
                                    quality=50).jpeg_bytes]
        kw["chunk_bits"] = 256
    elif case == "quarantine":
        blobs, kw["validate"] = _quarantined(), True
    elif case == "planes":
        emit, kw["sync"] = "planes", "specmap"
    elif case == "segment-faithful":
        kw["sync"] = "faithful"
    dec = api.ParallelDecoder.from_bytes(blobs, device="cpu", **kw)
    if case == "bucket":
        assert dec.shape.n_chunks > dec.plan.n_chunks
    ref = dec.decode(emit=emit)
    out = dec.decode_on(Mesh([CPU] * blocks), emit=emit)
    assert torch.equal(out.coeffs.full(), ref.coeffs)
    assert (out.sync_rounds, out.converged) == (ref.sync_rounds,
                                                ref.converged)
    if emit == "rgb":
        assert torch.equal(out.rgb.full(), ref.rgb)
    else:
        assert out.rgb is None
        for got, exp in zip(out.planes, ref.planes):
            assert torch.equal(got.full(), exp)
    if blocks > 1:
        assert torch.equal(out.mesh["exits"].full(), single_exits(dec))
        assert out.mesh["copy_bytes"] == out.mesh["expected_bytes"]
        # each coefficient is sent at most once, in rows that a sequence
        # may share with the one before it
        assert out.mesh["copy_bytes"].get("rows", 0) <= 256 * (
            ref.coeffs.shape[0] + dec.plan.n_sequences)
        # contiguous row ranges that cover the output, one a block
        rows = out.mesh["rows"]
        assert rows[0][0] == 0 and rows[-1][1] == ref.coeffs.shape[0]
        assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
        assert out.coeffs.offsets == tuple(
            [r[0] for r in rows] + [rows[-1][1]])
    if case == "tiny":
        assert 0 in out.mesh["lanes"] or out.mesh["lanes"].count(
            max(out.mesh["lanes"])) < blocks
    if case == "segment":   # blocks cut inside the single-segment image
        assert sum(out.mesh["halo"]) > 0
    if case == "quarantine":
        np.testing.assert_array_equal(out.status, ref.status)


def test_layout_edges_and_rows():
    """An identity plan's blocks cut at sequence starts, each reading one
    edge state where its first lane continues a segment; a balanced plan
    over as many blocks cuts at its own lane blocks; rows follow images."""
    blobs = uniform_blobs()
    dec = api.ParallelDecoder.from_bytes(blobs, device="cpu", **KW)
    lay, _ = dec.mesh_layout(3)
    seq_first = dec._arrays["chunk_seq_first"]
    for blk in lay.blocks:
        assert blk.lo == len(seq_first) or seq_first[blk.lo]
        assert len(blk.halo) <= 1
    assert [b.images for b in lay.blocks] == [(0, 1), (1, 2), (2, 3)]
    units = dec.plan.total_units // 3
    assert [b.rows for b in lay.blocks] == [(0, units), (units, 2 * units),
                                            (2 * units, 3 * units)]
    bal = api.ParallelDecoder.from_bytes(blobs, device="cpu", balance="lpt",
                                         lanes=3, **KW)
    lay, _ = bal.mesh_layout(3)
    block = bal.shape.n_chunks // 3
    assert lay.bounds.tolist() == [0, block, 2 * block, 3 * block]
    loads = DP.plan_lane_loads(bal.plan, 3)
    assert int(loads.max() - loads.min()) <= KW["seq_chunks"]


def test_mesh_api():
    dec = api.ParallelDecoder.from_bytes(uniform_blobs(), device="cpu", **KW)
    ref = dec.decode(emit="coeffs")
    # a 2-D mesh is flattened to a 1-D mesh of its four entries
    m2 = make_mesh((2, 2), ("data", "model"), [CPU] * 4)
    out = dec.decode_on(m2, emit="coeffs")
    assert out.mesh["blocks"] == 4 and torch.equal(out.coeffs.full(),
                                                   ref.coeffs)
    with pytest.raises(ValueError, match="requires a 1-D mesh"):
        dec.decode_on(m2, emit="coeffs", rules={"chunks": ("data",)})
    # rules whose lane axis the mesh lacks: one block, decode() there
    one = dec.decode_on(Mesh([CPU] * 2), emit="coeffs",
                        rules={"chunks": ("model",)})
    assert one.mesh["blocks"] == 1 and torch.equal(one.coeffs.full(),
                                                   ref.coeffs)
    with pytest.raises(RuntimeError):
        Mesh([torch.device("cuda", 7)])
    with pytest.raises(ValueError):
        Mesh([CPU] * 2, ("data", "model"))
    with pytest.raises(ValueError, match="emit"):
        dec.decode_on(Mesh([CPU] * 2), emit="pixels")
    # decode_batch(mesh=): lanes default to the mesh size, the device to
    # the mesh's
    got = api.decode_batch(uniform_blobs(), emit="coeffs", balance="lpt",
                           mesh=Mesh([CPU] * 2), **KW)
    assert got.plan.n_lanes == 2 and torch.equal(got.coeffs.full(),
                                                 ref.coeffs)
    s = Sharded([torch.arange(3), torch.arange(3, 5)], [0, 3, 5])
    assert s.shape == (5,) and s.full().tolist() == list(range(5))
    with pytest.raises(ValueError):
        Sharded([torch.arange(3)], [0, 2])


def test_sharding_rules_equal_repro():
    """The decoder's logical-axis rules: ``resolve`` as ``repro``'s
    (a PartitionSpec's entries), ``logical_rules`` scoped, and the mesh
    axis the lanes ride."""
    from repro.dist import sharding as RS
    from repro_torch.dist import sharding as SH
    rules = {"batch": ("data",), "chunks": "data", "heads": ("model",),
             "mlp": ("model", "data")}
    for axes in [("batch", "embed"), ("chunks", None), ("mlp", "heads"),
                 ("batch", "mlp"), ("units",)]:
        assert SH.resolve(axes, rules) == tuple(RS.resolve(axes, rules))
    assert SH.current_rules() is None
    with SH.logical_rules(rules):
        assert SH.resolve(("batch",)) == ("data",)
    assert SH.current_rules() is None
    mesh = Mesh([CPU] * 2, ("data",))
    assert SH.lane_axis(mesh, SH.decode_rules(mesh.axis_names)) == "data"
    assert SH.lane_axis(mesh, {"chunks": ("model",)}) is None


def test_mesh_program_is_cached():
    """A second decode_on of one decoder allocates nothing and starts
    each loop from the last decode's iteration count (hints): fewer host
    checks."""
    api.clear_decode_programs()
    dec = api.ParallelDecoder.from_bytes(uniform_blobs(), device="cpu", **KW)
    mesh = Mesh([CPU] * 3)
    first = dec.decode_on(mesh, emit="coeffs")
    prog = [p for p in api.decode_programs()
            if isinstance(p, api.MeshProgram)][0]
    allocs = prog.allocations
    second = dec.decode_on(mesh, emit="coeffs")
    assert prog.allocations == allocs and prog.decodes == 2
    assert second.mesh["host_checks"] <= first.mesh["host_checks"]
    assert second.mesh["host_checks"] == 1
    stats = api.decode_program_stats()
    assert any(b["device"].startswith("Mesh(") for b in stats["buckets"])
    assert torch.equal(first.coeffs.full(), second.coeffs.full())
    json.dumps({k: v for k, v in second.mesh.items() if k != "exits"})
    api.clear_decode_programs()
