"""The color kernel's body (csrc/color.cuh) run on the host.

The color kernel colors a run of consecutive pixels of one row a thread,
with the ``__host__ __device__`` functions of ``csrc/color.cuh``: the
chroma factors of the standard layouts as template constants, a generic
form for the others, 16-byte loads where the planes allow them and one
sample at a time where they do not; 16-byte stores where every output row
is aligned to them, else a warp's runs staged and copied out together
(``rt::copy_span``, here run lane by lane). A g++ build of a small shim
(``-ffp-contract=off``: one rounding per operation, as the kernel's
intrinsics) runs that body over every row and run of the output, as the
kernel's grid does, with runs of 16 pixels (the kernel's) and of 8; the
RGB must equal ``core.decode.upsample_color`` bit for bit.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import decode as D
from repro_torch.kernels.color import ops as CK

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / \
    "kernels" / "csrc"

SHIM = r"""
#include "color.cuh"

// The kernel's work over every (image, row, run), as color.cu launches it.
template <int kRun>
void run(const float* p0, const float* p1, const float* p2, const int* h,
         const int* w, const int* fv, const int* fh, uint8_t* out,
         int n_images, int height, int width) {
  rt::ColorPlanes pl;
  const float* p[3] = {p0, p1, p2};
  for (int c = 0; c < 3; ++c) {
    pl.p[c] = p[c];
    pl.h[c] = h[c];
    pl.w[c] = w[c];
    pl.fv[c] = fv[c];
    pl.fh[c] = fh[c];
  }
  pl.vec_w = rt::vector_width(pl);
  const bool store_vec = rt::rows_aligned<kRun>(out, width);
  constexpr int kWords = 3 * kRun / 4, kLanes = 32;
  uint32_t stage[kLanes * kWords + 1];
  rt::with_form(pl, [&](auto form) {
    using F = decltype(form);
    for (int b = 0; b < n_images; ++b)
      for (int y = 0; y < height; ++y) {
        uint8_t* row = rt::row_out(out, b, y, height, width);
        // a warp's runs: colored, then stored each, or staged and copied
        for (int x_w = 0; x_w < width; x_w += kLanes * kRun) {
          for (int lane = 0; lane < kLanes; ++lane) {
            const int x0 = x_w + lane * kRun;
            if (x0 >= width) break;
            const int n = width - x0 < kRun ? width - x0 : kRun;
            uint32_t* words = stage + lane * kWords;
            rt::color_run<kRun, F::fh, F::fv>(pl, b, y, x0, n, words);
            if (store_vec) rt::store_run<kRun>(row + 3 * x0, words);
          }
          if (store_vec) continue;
          const int nbytes = rt::span_bytes<kRun, kLanes>(x_w, width);
          for (int lane = 0; lane < kLanes; ++lane) {
            rt::copy_span<kLanes>(row + 3 * x_w, stage, nbytes, lane);
          }
        }
      }
  });
}

#define ARGS                                                             \
  const float *p0, const float *p1, const float *p2, const int *h,       \
      const int *w, const int *fv, const int *fh, uint8_t *out,          \
      int n_images, int height, int width
#define PASS p0, p1, p2, h, w, fv, fh, out, n_images, height, width

extern "C" void host_color16(ARGS) { run<16>(PASS); }
extern "C" void host_color8(ARGS) { run<8>(PASS); }

// The form with_form picks: 0 generic, else 10 * fh + fv of the chroma.
extern "C" int host_form(const int* fv, const int* fh) {
  rt::ColorPlanes pl{};
  for (int c = 0; c < 3; ++c) {
    pl.fv[c] = fv[c];
    pl.fh[c] = fh[c];
  }
  int form = -1;
  rt::with_form(pl, [&](auto f) {
    using F = decltype(f);
    form = 10 * F::fh + F::fv;
  });
  return form;
}
"""

# (comp_h, comp_v, the form with_form picks)
LAYOUTS = {"4:2:0": ((2, 1, 1), (2, 1, 1), 22),
           "4:2:2": ((2, 1, 1), (1, 1, 1), 21),
           "4:4:4": ((1, 1, 1), (1, 1, 1), 11),
           "4:4:0": ((1, 1, 1), (2, 1, 1), 12),
           "4:1:1": ((4, 1, 1), (1, 1, 1), 0),
           "chroma larger": ((1, 2, 1), (1, 2, 1), 0)}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("color_layout")
    (d / "shim.cpp").write_text(SHIM)
    so = d / "libshim.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-ffp-contract=off", "-fno-strict-aliasing", f"-I{CSRC}",
                    str(d / "shim.cpp"), "-o", str(so)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    ints = ctypes.POINTER(ctypes.c_int)
    for fn in (lib.host_color16, lib.host_color8):
        fn.argtypes = [ctypes.c_void_p] * 3 + [ints] * 4 + \
            [ctypes.c_void_p] + [ctypes.c_int] * 3
        fn.restype = None
    lib.host_form.argtypes = [ints, ints]
    lib.host_form.restype = ctypes.c_int
    return lib


def _ints(t):
    return (ctypes.c_int * 3)(*t)


def planes_for(comp_h, comp_v, mcus_y, mcus_x, n_images, seed, values,
               misalign=False):
    """Component planes padded to the MCU grid, as ``assemble_planes``
    gives them: sample values from the IDCT (integers 0..255) or any
    float around and past that range (``values="float"``). ``misalign``:
    every plane starts one float past a 16-byte boundary."""
    rng = np.random.default_rng(seed)
    planes = []
    for h, v in zip(comp_h, comp_v):
        shape = (n_images, mcus_y * v * 8, mcus_x * h * 8)
        if values == "float":
            a = rng.uniform(-40.0, 300.0, shape).astype(np.float32)
        else:
            a = rng.integers(0, 256, shape).astype(np.float32)
        flat = torch.zeros(a.size + 8, dtype=torch.float32)
        off = (-flat.data_ptr() // 4) % 4 + (1 if misalign else 0)
        t = flat[off:off + a.size].view(shape)
        t.copy_(torch.from_numpy(a))
        planes.append(t)
    return planes


def host_color(lib, run, planes, comp_h, comp_v, height, width, misalign):
    """(B, height, width, 3) uint8 RGB from the host build; ``misalign``
    puts the output one byte past a 16-byte boundary."""
    h_max, v_max = max(comp_h), max(comp_v)
    n = planes[0].shape[0]
    size = n * height * width * 3
    buf = torch.zeros(size + 32, dtype=torch.uint8)
    off = (-buf.data_ptr()) % 16 + (1 if misalign else 0)
    out = buf[off:off + size]
    fn = lib.host_color16 if run == 16 else lib.host_color8
    fn(*(ctypes.c_void_p(p.data_ptr()) for p in planes),
       _ints([p.shape[1] for p in planes]),
       _ints([p.shape[2] for p in planes]),
       _ints([v_max // v for v in comp_v]),
       _ints([h_max // h for h in comp_h]),
       ctypes.c_void_p(out.data_ptr()), n, height, width)
    return out.view(n, height, width, 3)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_form_of_each_layout(host_lib, layout):
    comp_h, comp_v, form = LAYOUTS[layout]
    h_max, v_max = max(comp_h), max(comp_v)
    assert host_lib.host_form(_ints([v_max // v for v in comp_v]),
                              _ints([h_max // h for h in comp_h])) == form


# (MCUs down, MCUs across, rows and columns cropped off): whole planes at
# widths that are multiples of both runs and not; crops narrower and
# shorter than the plane, down to one pixel
SIZES = [(3, 4, 0, 0), (2, 5, 0, 0), (3, 4, 3, 11), (2, 7, 5, 13),
         (1, 2, 99, 99)]


@pytest.mark.parametrize("run", [16, 8])
@pytest.mark.parametrize("size", range(len(SIZES)))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_run_body_matches_plain(host_lib, layout, size, run):
    comp_h, comp_v, _ = LAYOUTS[layout]
    h_max, v_max = max(comp_h), max(comp_v)
    mcus_y, mcus_x, crop_y, crop_x = SIZES[size]
    height = max(1, mcus_y * 8 * v_max - crop_y)
    width = max(1, mcus_x * 8 * h_max - crop_x)
    for values, misalign in (("ints", False), ("float", False),
                             ("ints", True)):
        planes = planes_for(comp_h, comp_v, mcus_y, mcus_x, 2,
                            seed=size + 7 * run, values=values,
                            misalign=misalign)
        got = host_color(host_lib, run, planes, comp_h, comp_v, height,
                         width, misalign)
        exp = D.upsample_color(planes, comp_h, comp_v, h_max, v_max, height,
                               width)
        assert got.shape == exp.shape
        assert torch.equal(got, exp), (values, misalign)
        assert torch.equal(exp, CK.upsample_color(
            planes, comp_h, comp_v, h_max, v_max, height, width))
