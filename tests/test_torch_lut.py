"""The exit kernel's compact decode tables (``ops.compact_luts``).

The tables are the kernel's only source of Huffman entries, so they must
be lossless: expanded the way ``csrc/huffman.cuh``'s ``CompactLut`` reads
them, they give back every one of the 65,536 entries of every LUT row,
including the invalid window's entry 0, which drives the garbage phase of
speculative decoding.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import decode as D
from repro_torch.core.bitstream import (build_batch_plan, build_plan_data,
                                        dev_from_numpy, plan_shape)
from repro_torch.core.state import DecodeState
from repro_torch.jpeg import tables as T
from repro_torch.kernels.fused import store as FS
from repro_torch.kernels.huffman import ops as HK

from _torch_corpus import CORPORA, corpus


def expand(tab: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """(L, 65536) int32: every window of every row, looked up as the
    kernel does: primary at the top 9 bits, then, where the entry points
    to a secondary, that secondary at the low 7."""
    t = tab.to(torch.int32) & 0xFFFF
    win = torch.arange(1 << 16, dtype=torch.int64)
    rows = []
    for s in start.tolist():
        e = t[s + (win >> 7)]
        ptr = ((e & 0x1F) == 0) & (e != 0)
        sec = torch.where(ptr, s + ((e.to(torch.int64) >> 5) << 7)
                          + (win & 127), 0)
        rows.append(torch.where(ptr, t[sec], e))
    return torch.stack(rows)


def row_ends(tab, start):
    return torch.cat([start[1:], torch.tensor([tab.numel()])]).tolist()


def plan_dev(blobs, chunk_bits=256, bucket=True):
    plan = build_batch_plan(blobs, chunk_bits=chunk_bits)
    data = build_plan_data(plan, plan_shape(plan, bucket=bucket))
    dev = dev_from_numpy(dict(data.arrays, words=data.words), "cpu")
    dev.update(HK.exit_tables(dev))
    return dev


def spec_lut(bits, vals, is_dc):
    spec = T.HuffmanSpec(np.asarray(bits, np.int32), np.asarray(vals, np.int32))
    return torch.from_numpy(T.build_decode_lut(spec, is_dc=is_dc))


@pytest.mark.parametrize("name", CORPORA)
@pytest.mark.parametrize("bucket", [True, False])
def test_compact_tables_expand_to_the_luts(name, bucket):
    dev = plan_dev(corpus(name), bucket=bucket)
    luts, tab = dev["luts"], dev["luts_compact"]
    _, start = HK.compact_luts(luts)
    assert tab.dtype == torch.int16 and tab.numel() % 128 == 0
    assert torch.equal(expand(tab, start), luts)
    # each row's pointers stay inside the row
    t = tab.to(torch.int32) & 0xFFFF
    for s, end in zip(start.tolist(), row_ends(tab, start)):
        prim = t[s:s + 512]
        ptr = prim[((prim & 0x1F) == 0) & (prim != 0)]
        assert bool(((ptr >> 5) >= 4).all())
        assert bool((s + ((ptr >> 5) + 1) * 128 <= end).all())
    # the kernel's per-slot row starts
    assert torch.equal(dev["unit_lut_off"],
                       start[dev["unit_lut_row"].to(torch.int64)])


def test_standard_tables_take_under_7_kb():
    """The four standard tables of a 4:2:0 batch: 3,456 entries (6,912
    bytes), against 1 MiB as int32 LUTs."""
    dev = plan_dev(corpus("420"), bucket=False)
    assert dev["luts"].shape[0] == 4
    assert dev["luts_compact"].numel() == 3456
    assert HK.exit_table_bytes(dev) == \
        3456 * 2 + 4 * dev["unit_lut_off"].numel()


@pytest.mark.parametrize("table", ["dc_luma", "ac_luma", "ac_16bit",
                                   "one_code_per_length"])
def test_compact_table_of_one_spec(table):
    """A DC table, the AC table whose ZRL entry is the largest (48,139,
    bit 15 set), and tables with 16-bit codes: under a 9-bit prefix of the
    16-bit ones lie codes of several lengths and the invalid window."""
    if table == "dc_luma":
        lut = spec_lut(T.STD_DC_LUMA_BITS, T.STD_DC_LUMA_VALS, True)
    elif table == "ac_luma":
        lut = spec_lut(T.STD_AC_LUMA_BITS, T.STD_AC_LUMA_VALS, False)
        assert int(lut.max()) == 48139
    elif table == "ac_16bit":
        # 1 code each of lengths 1..15 and 2 of length 16: a full code
        bits = [1] * 15 + [2]
        vals = [0x00, 0x01, 0x11, 0x02, 0x21, 0x31, 0x12, 0x41, 0x51, 0x03,
                0x22, 0x61, 0x71, 0x13, 0xF0, 0xFA, 0x32]
        lut = spec_lut(bits, vals, False)
        assert int((lut & 0x1F).max()) == 16
    else:
        # 1 code each of lengths 1..16: the all-ones window is invalid
        bits = [1] * 16
        vals = list(range(1, 17))
        lut = spec_lut(bits, vals, False)
        assert int(lut[-1]) == 0 and int((lut & 0x1F).max()) == 16
    luts = torch.stack([lut, torch.zeros_like(lut), lut])  # with a pad row
    tab, start = HK.compact_luts(luts)
    assert torch.equal(expand(tab, start), luts)
    assert start.tolist()[1] == tab.numel() - start.tolist()[1] - 512


@pytest.mark.parametrize("bad", [1 << 16, -1, 32])
def test_compact_luts_refuses_entries_it_cannot_hold(bad):
    """Entries past 16 bits, and a non-zero entry of code length 0, which
    the kernel would read as a pointer."""
    luts = torch.zeros((1, 1 << 16), dtype=torch.int32)
    luts[0, 1000] = bad
    with pytest.raises(ValueError):
        HK.compact_luts(luts)


def test_exit_kernel_operands_need_the_tables():
    """The plan's own tensors carry no compact tables (the kernel backend
    adds them once per plan); the exit kernel's operands refuse a plan
    without them instead of reading the LUTs."""
    plan = build_batch_plan(corpus("420"), chunk_bits=256)
    data = build_plan_data(plan, plan_shape(plan, bucket=True))
    dev = dev_from_numpy(dict(data.arrays, words=data.words), "cpu")
    assert "luts_compact" not in dev and "unit_lut_off" not in dev
    meta = D.chunk_meta(dev)
    entry = DecodeState.cold(dev["chunk_start"])
    with pytest.raises(ValueError, match="compact tables"):
        HK.exit_args(dev, meta, entry)
    dev.update(HK.exit_tables(dev))
    assert len(HK.exit_args(dev, meta, entry)) == 13


def test_store_kernel_operands_need_the_tables():
    """The store kernel reads the exit kernel's compact tables: its launch
    refuses a plan without them before reaching the card."""
    plan = build_batch_plan(corpus("420"), chunk_bits=256)
    data = build_plan_data(plan, plan_shape(plan, bucket=True))
    dev = dev_from_numpy(dict(data.arrays, words=data.words), "cpu")
    meta = D.chunk_meta(dev)
    entry = DecodeState.cold(dev["chunk_start"])
    lanes = entry.p.shape[0]
    base = torch.zeros(lanes, dtype=torch.int32)
    with pytest.raises(ValueError, match="compact tables"):
        FS.run_store_kernel(dev, meta, entry, base, base, 64, s_max=1,
                            min_code_bits=2, smem_budget=0)
