"""The pixel kernel's sample mapping (csrc/pixels.cuh) run on the host.

The fused pixel kernel finds each output pixel's three samples with the
``__host__ __device__`` functions of ``csrc/pixels.cuh`` (no integer
division: a reciprocal multiply and a shift). A g++ build of a small shim
runs them for every 3-component layout the planner accepts (at most 6
units per MCU) and every output pixel of the MCU; the result must be the
index math of ``fused_pixels_plain``, read off ``mcu_planes`` applied to
the units' sample indices.
"""
import ctypes
import itertools
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.fused import pixels as FP

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / \
    "kernels" / "csrc"

SHIM = r"""
#include "pixels.cuh"

// out[c][y][x] = pixel_source(layout, c, y, x) over the MCU's pixels
extern "C" void host_map(const int* comp_h, const int* comp_v, int* out) {
  const rt::McuLayout l = rt::make_layout(comp_h[0], comp_v[0], comp_h[1],
                                          comp_v[1], comp_h[2], comp_v[2]);
  const int mh = 8 * l.v_max, mw = 8 * l.h_max;
  for (int c = 0; c < 3; ++c)
    for (int y = 0; y < mh; ++y)
      for (int x = 0; x < mw; ++x)
        out[(c * mh + y) * mw + x] = rt::pixel_source(l, c, y, x);
}

// The standard layouts' constants equal make_layout's of their factors.
extern "C" int host_standard(int kind, const int* comp_h,
                             const int* comp_v) {
  const rt::McuLayout a = rt::standard_layout(kind);
  const rt::McuLayout b = rt::make_layout(comp_h[0], comp_v[0], comp_h[1],
                                          comp_v[1], comp_h[2], comp_v[2]);
  int same = a.upm == b.upm && a.h_max == b.h_max && a.v_max == b.v_max;
  for (int c = 0; c < 3; ++c) {
    same = same && a.comp_h[c] == b.comp_h[c] &&
           a.comp_off[c] == b.comp_off[c] && a.recip_h[c] == b.recip_h[c] &&
           a.recip_v[c] == b.recip_v[c];
  }
  return same;
}

// Quotients where div_small and integer division differ, over n < 1024
// and divisors 1..64.
extern "C" int host_div_mismatches() {
  int bad = 0;
  for (int d = 1; d <= 64; ++d)
    for (int n = 0; n < 1024; ++n)
      bad += rt::div_small(n, rt::recip16(d)) != n / d;
  return bad;
}
"""


def _layouts():
    """(comp_h, comp_v, the factors divide the largest) of every
    3-component layout of at most 6 units per MCU."""
    out = []
    for comps in itertools.product(itertools.product(range(1, 5), repeat=2),
                                   repeat=3):
        if sum(h * v for h, v in comps) > 6:
            continue
        comp_h = tuple(h for h, _ in comps)
        comp_v = tuple(v for _, v in comps)
        ok = all(max(comp_h) % h == 0 and max(comp_v) % v == 0
                 for h, v in comps)
        out.append((comp_h, comp_v, ok))
    return out


LAYOUTS = [(h, v) for h, v, ok in _layouts() if ok]
REFUSED = [(h, v) for h, v, ok in _layouts() if not ok]
STANDARD = {0: ((2, 1, 1), (2, 1, 1)),   # 4:2:0 (rt::k420)
            1: ((2, 1, 1), (1, 1, 1)),   # 4:2:2
            2: ((1, 1, 1), (1, 1, 1))}   # 4:4:4


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("pixel_layout")
    (d / "shim.cpp").write_text(SHIM)
    so = d / "libshim.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC",
                    f"-I{CSRC}", str(d / "shim.cpp"), "-o", str(so)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    ints = ctypes.POINTER(ctypes.c_int)
    lib.host_map.argtypes = [ints, ints, ctypes.c_void_p]
    lib.host_map.restype = None
    lib.host_standard.argtypes = [ctypes.c_int, ints, ints]
    lib.host_standard.restype = ctypes.c_int
    lib.host_div_mismatches.argtypes = []
    lib.host_div_mismatches.restype = ctypes.c_int
    return lib


def _ints(t):
    return (ctypes.c_int * 3)(*t)


def test_layouts_cover_the_standard_ones():
    assert len(LAYOUTS) == 54 and len(REFUSED) == 12
    assert all(s in LAYOUTS for s in STANDARD.values())


@pytest.mark.parametrize("comp_h,comp_v", LAYOUTS)
def test_sample_mapping_matches_plain(host_lib, comp_h, comp_v):
    h_max, v_max = max(comp_h), max(comp_v)
    upm = sum(h * v for h, v in zip(comp_h, comp_v))
    got = np.zeros((3, 8 * v_max, 8 * h_max), np.int32)
    host_lib.host_map(_ints(comp_h), _ints(comp_v),
                      ctypes.c_void_p(got.ctypes.data))
    # the plain version's plane assembly and upsample of the units'
    # sample indices: where each output pixel takes each component from
    idx = torch.arange(upm * 64, dtype=torch.int64).reshape(upm, 64)
    planes = FP.mcu_planes(idx, comp_h=comp_h, comp_v=comp_v, h_max=h_max,
                           v_max=v_max, upm=upm)
    exp = torch.stack([p[0] for p in planes]).numpy()
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("kind", sorted(STANDARD))
def test_standard_layout_constants(host_lib, kind):
    comp_h, comp_v = STANDARD[kind]
    assert host_lib.host_standard(kind, _ints(comp_h), _ints(comp_v)) == 1


def test_reciprocal_division_is_exact(host_lib):
    assert host_lib.host_div_mismatches() == 0


@pytest.mark.parametrize("comp_h,comp_v", REFUSED)
def test_layouts_whose_factors_do_not_divide_are_refused(comp_h, comp_v):
    """The replicate upsample needs every factor to divide the largest:
    the pixel stage refuses other layouts instead of reading past an
    MCU's units."""
    upm = sum(h * v for h, v in zip(comp_h, comp_v))
    coeffs = torch.zeros((upm, 64), dtype=torch.int32)
    m_t = torch.zeros((1, 64, 64))
    mrow = torch.zeros(upm, dtype=torch.int32)
    with pytest.raises(ValueError, match="divide the largest"):
        FP.fused_pixels(coeffs, m_t, mrow, comp_h=comp_h, comp_v=comp_v,
                        h_max=max(comp_h), v_max=max(comp_v), upm=upm)
