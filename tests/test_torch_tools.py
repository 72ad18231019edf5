"""The chip tools' host halves, on the CPU: the variant sources of
``tools/kernel_times.py`` and the name and flag handling of
``tools/sass_diff.py`` (their builds and timings need nvcc and the card)."""
from __future__ import annotations

import re

import pytest

from repro_torch.kernels import build as B
from repro_torch.kernels import autotune as AT
from repro_torch.tools import kernel_times as KT
from repro_torch.tools import sass_diff as SD


@pytest.mark.parametrize("kind,entry,block", [
    ("exit", "rt_decode_exits", 64),
    ("stream", "rt_decode_streams", 128),
    ("store", "rt_decode_store", 512),
])
def test_variant_threads_pins_the_dispatch(kind, entry, block):
    texts = KT.variant_sources(kind, {"threads": str(block)}, B, 256)
    cu = texts[f"{KT.VARIANTS[kind][0]}.cu"]
    body = cu[cu.index(f"int {entry}("):]
    body = body[:body.index("\n}\n")]
    assert f"with_block<{block}>({block}" in body
    assert not re.search(r"with_block<[\d, ]+>\(threads", body)
    # the other entry points keep their candidates
    original = (B.CSRC / f"{KT.VARIANTS[kind][0]}.cu").read_text()
    assert cu.count("with_block<") == original.count("with_block<")
    occupancy = cu.split("kt_blocks_per_sm")[1]
    assert f", {block}>, {block}," in occupancy  # the kernel, its block


@pytest.mark.parametrize("kind,spec,where", [
    ("stream", {"kStreamBarrierRows": "4"}, "huffman.cu"),
    ("color", {"kColorRun": "16", "kRowsY": "4"}, "geometry.cuh"),
])
def test_variant_constants_land_where_they_are_defined(kind, spec, where):
    texts = KT.variant_sources(kind, spec, B,
                               AT.DEFAULT_LAUNCH.stream_threads)
    for const, value in spec.items():
        assert re.search(rf"constexpr int {const} = {value};", texts[where])
        original = (B.CSRC / where).read_text()
        assert not re.search(rf"constexpr int {const} = {value};", original)
    changed = [n for n, t in texts.items()
               if (B.CSRC / n).read_text() != t]
    assert sorted(changed) == sorted({where, f"{KT.VARIANTS[kind][0]}.cu"})


def test_variant_refuses_what_it_cannot_build():
    with pytest.raises(SystemExit, match="no single kNoSuchConstant"):
        KT.variant_sources("stream", {"kNoSuchConstant": "1"}, B, 1024)
    with pytest.raises(SystemExit, match="no threads knob"):
        KT.variant_sources("color", {"threads": "64"}, B, 0)


@pytest.mark.parametrize("name,expected", [
    ("void <unnamed>::pixels_kernel<(bool)1, (int)3>(const int *, "
     "rt::McuLayout, long long)", ("pixels_kernel", "(bool)1, (int)3")),
    ("void (anonymous namespace)::exits_kernel<true, 256>("
     "(anonymous namespace)::LaneInputs, int*)",
     ("exits_kernel", "true, 256")),
    ("void <unnamed>::streams_kernel<(bool)1>(<unnamed>::LaneInputs, "
     "int *)", ("streams_kernel", "(bool)1")),
    ("void rt_seed_kernel(const float *)", ("rt_seed_kernel", "")),
])
def test_sass_kernel_names(name, expected):
    assert SD.split_name(name) == expected


def test_sass_cubin_flags_drop_the_library_flags():
    release, checked = SD.cubin_flags(B, False), SD.cubin_flags(B, True)
    for flags in (release, checked):
        assert not {"-shared", "-fPIC", "-v", "-Xcompiler",
                    "-Xptxas"} & set(flags)
        assert "arch=compute_90a,code=sm_90a" in flags
    assert "-DRT_CHECK" in checked and "-DRT_CHECK" not in release


def test_sass_differing_counts_instructions():
    assert SD.differing(["A", "B", "C"], ["A", "B", "C"]) == 0
    assert SD.differing(["A", "B", "C"], ["A", "X", "C"]) == 2
    assert SD.differing(["A", "B"], ["A", "B", "C"]) == 1
