"""The benchmark's yardstick on the CPU: its encoder and reference against
the port's sequential reference codec (``repro_torch.jpeg.codec_ref``),
its counts against a hand count, the trace's reduction and the metric
readers on made-up traces, the import check and the ring's frame
orders."""
import numpy as np
import pytest
import torch

from perfbench import counts, harness, inputs, reference, tracing
from perfbench import jpeg_encoder as E
from repro_torch.jpeg import codec_ref as cr
from repro_torch.jpeg.format import (parse_jpeg, segment_byte_bounds,
                                     unstuff_scan)


@pytest.mark.parametrize("sub,restart", [("4:2:0", 0), ("4:2:0", 3),
                                         ("4:2:2", 2), ("4:4:4", 0)])
def test_encoder_and_reference_equal_the_reference_codec(sub, restart):
    """Bytes and coefficients equal ``encode_baseline``'s; the reference's
    RGB, float64 and from the coefficients, equals ``decode_baseline`` of
    the bytes; the segment lengths are the scan's."""
    rng = np.random.default_rng(7)
    img = E.synth_frame(rng, 37, 21, t=0.4)
    for q in (50, 95):
        enc = E.encode(img, q, sub, restart)
        ref = cr.encode_baseline(img, quality=q, subsampling=sub,
                                 restart_interval=restart)
        assert enc.jpeg_bytes == ref.jpeg_bytes
        np.testing.assert_array_equal(enc.coeff, ref.coeff_zigzag)
        clean, rst = unstuff_scan(parse_jpeg(enc.jpeg_bytes).scan_data)
        bounds = segment_byte_bounds(clean, rst)
        assert enc.segment_bytes == list(np.diff(bounds))
        got = reference.rgb(enc.coeff, E.geometry(37, 21, sub), q, restart,
                            "cpu")
        np.testing.assert_array_equal(got.numpy(),
                                      cr.decode_baseline(enc.jpeg_bytes))


def test_control_rounds_to_tf32_and_departs_from_the_reference():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -11, -1 - 2 ** -12,
                      1 + 2 ** -10])
    np.testing.assert_array_equal(
        reference.to_tf32(x).numpy(),
        np.array([1.0, 1.0, 1 + 2 ** -9, -1.0, 1 + 2 ** -10], np.float32))
    enc = inputs.encode_frame((3, 0, 64, 48, 95, "4:2:0", 0))
    g = E.geometry(64, 48, "4:2:0")
    cmp = reference.Comparison()
    cmp.add(reference.rgb(enc.coeff, g, 95, 0, "cpu", "tf32"),
            reference.rgb(enc.coeff, g, 95, 0, "cpu"))
    assert cmp.numbers()["rgb_off_share"] > 0.001


def test_counts_match_a_hand_count():
    g = E.geometry(48, 32, "4:2:0")        # 3 x 2 MCUs of 6 units
    segs = [[100, 33], [64]]
    w = counts.batch_work([0, 1, 0], segs, g, chunk_bits=256)
    # lanes: 800 bits -> 4, 264 -> 2, 512 -> 2
    assert (w.images, w.lanes, w.scan_bytes, w.units, w.pixels) == \
        (3, 4 + 2 + 2 + 4 + 2, 133 + 64 + 133, 3 * 36, 3 * 1536)
    assert w.sync_bytes == 330 + 16 * 14
    assert w.pixel_bytes == 108 * 64 * 2 + 4608 * 3
    assert w.pixel_flops == 108 * (1024 * 2 + 64) + 4608 * 8
    peaks = counts.PEAKS["H100"]
    t, bound = counts.least_seconds(w.pixel_bytes, w.pixel_flops, peaks)
    assert (t, bound) == (pytest.approx(27648 / 3.35e12), "bytes")
    assert counts.least_seconds(0, 67e6, peaks) == (pytest.approx(1e-6),
                                                    "operations")


def test_lanes_equal_the_programs_plan():
    from repro_torch.core.bitstream import build_batch_plan
    encs = [inputs.encode_frame((5, i, 64, 48, 90, "4:2:0", r))
            for i, r in ((0, 0), (1, 0))]
    for chunk in (64, 256):
        plan = build_batch_plan([e.jpeg_bytes for e in encs],
                                chunk_bits=chunk)
        assert plan.n_chunks == sum(counts.lanes_of(e.segment_bytes, chunk)
                                    for e in encs)


def _ops(*triples):
    return [tracing.Op(n, float(a), float(b)) for n, a, b in triples]


def test_trace_reduction_and_readers_on_a_made_up_trace():
    spans = _ops(("bench.decode", 0, 10), ("bench.wait", 10, 40),
                 ("bench.loop", 40, 45),
                 ("bench.decode", 45, 50), ("bench.wait", 50, 80),
                 ("bench.loop", 80, 82))
    device = _ops(("Memcpy HtoD", 2, 4), ("exits_kernel<1>", 5, 9),
                  ("exits_kernel<1>", 12, 14), ("streams_kernel", 15, 20),
                  ("index_put", 20, 25), ("pixels_kernel<0>", 26, 36),
                  ("exits_kernel<1>", 46, 49), ("store_kernel", 50, 60),
                  ("pixels_kernel<0>", 61, 71))
    t = tracing.reduce(device, spans)
    assert [len(b) for b in t.batches] == [6, 3]
    assert t.window_s == pytest.approx(82e-6)
    busy = 2 + 4 + 2 + 5 + 5 + 10 + 3 + 10 + 10
    assert t.busy_s == pytest.approx(busy * 1e-6)
    assert t.idle_gaps[0] == ("bench.wait", pytest.approx(11e-6))
    assert len(t.idle_gaps) <= tracing.BREAKDOWN_ENTRIES
    assert t.device_ops[0] == ("pixels_kernel<0>", pytest.approx(20e-6))

    work = counts.BatchWork(images=1, lanes=10, scan_bytes=3350,
                            units=10, pixels=100)
    run = harness.Run(setup_s=1.5, window_s=2.0, batch_s=[0.01] * 20,
                      images=80, rounds=[3, 5],
                      launches=[7, 9], trace=t, traced_work=[work, work],
                      peaks=counts.PEAKS["H100"])
    root = harness.ROOT

    def read(name):
        return harness.load_reader(root, name)(run)

    assert read("images_per_s") == 40.0
    assert read("batch_ms_p95") == pytest.approx(10.0)
    assert read("setup_s") == 1.5
    assert read("sync_rounds") == 4.0
    assert read("launches_per_batch") == 8.0
    assert read("idle_share") == pytest.approx(100 * (1 - busy / 82))
    # batch 1: streams 5 + index_put 5 between the last exit and pixels;
    # batch 2: the store kernel's 10
    assert read("write_pass_ms") == pytest.approx(0.010)
    sync_bound = 2 * (3350 + 160) / 3.35e12
    assert read("sync_roofline") == pytest.approx(
        100 * sync_bound / ((4 + 2 + 3) * 1e-6))
    pix_bound = 2 * work.pixel_bytes / 3.35e12
    assert read("pixels_roofline") == pytest.approx(
        100 * pix_bound / 20e-6)
    none = harness.Run(1.0, 1.0, [], 0, [], [], None, [], None)
    for name in ("sync_roofline", "pixels_roofline", "write_pass_ms",
                 "idle_share", "launches_per_batch", "sync_rounds",
                 "batch_ms_p95"):
        assert harness.load_reader(root, name)(none) is None


def test_batches_are_cut_by_the_devices_marks_across_a_clock_offset():
    """The device's clock runs 8 us behind the host's: batch 1's last
    copy appears after its wait span has ended. Host spans put it in
    batch 2; the decode spans' mirrors on the device keep it in batch 1."""
    spans = _ops(("bench.decode", 0, 10), ("bench.wait", 10, 40),
                 ("bench.loop", 40, 45),
                 ("bench.decode", 45, 50), ("bench.wait", 50, 80),
                 ("bench.loop", 80, 82))
    device = _ops(("Memcpy HtoD", 8, 12), ("pixels_kernel<0>", 30, 44),
                  ("copy", 46, 47.5),
                  ("Memcpy HtoD", 53, 57), ("pixels_kernel<0>", 70, 80),
                  ("copy", 81, 81.5))
    marks = _ops(("bench.decode", 8, 47.5), ("bench.decode", 53, 81.5))
    names = [[op.name for op in b]
             for b in tracing.reduce(device, spans, marks).batches]
    assert names == [["Memcpy HtoD", "pixels_kernel<0>", "copy"]] * 2
    host = [[op.name for op in b]
            for b in tracing.reduce(device, spans).batches]
    assert host[1][0] == "copy"


def test_import_check_compares_whole_top_level_names():
    assert harness.banned_modules(["repro_torch", "repro_torch.core.api",
                                   "reprox", "jaxtyping", "numpy"]) == []
    assert harness.banned_modules(["repro", "repro.core.sync", "jax",
                                   "jaxlib.xla_client", "flax.linen",
                                   "repro_torch"]) == \
        ["flax.linen", "jax", "jaxlib.xla_client", "repro",
         "repro.core.sync"]


def test_ring_slots_hold_the_same_frames_in_orders_from_the_seed():
    for seed in (0, 2 ** 31 + 5, 2 ** 63 + 11):
        slots = harness.ring_frames(8, 32, 3, seed)
        assert all(sorted(s) == sorted(np.repeat(np.arange(8), 4))
                   for s in slots)
        assert not np.array_equal(slots[0], slots[1])
        assert all(np.array_equal(a, b) for a, b in
                   zip(slots, harness.ring_frames(8, 32, 3, seed)))
    with pytest.raises(ValueError):
        harness.ring_frames(3, 32, 2, 0)
