"""dav1d_tpu_torch super-res resample (ops/resize.py) vs the JAX package,
bit-exact.

* the plain version vs dav1d_tpu/ops/resize._program (the XLA program
  the JAX chain applies to its resident planes) on the geometries of
  tests/test_ops_resize.py and on the 1080p super-res geometry of the
  committed stream superres_lr_1080p_8bit.ivf (luma 960 -> 1920, chroma
  480 -> 960), at bit depths 8/10/12, with random and extreme pixels;
* the wrapper on CPU tensors: the allocation-sized output of
  decode/frame.superres_geometry, zero outside the resampled rectangle,
  a new tensor; bad geometry refused;
* the kernel's own arithmetic, ``csrc/resize_core.cuh`` built as host
  C++ and run column by column (8 rows a thread, as the kernel) over the
  whole output plane, against the plain version; its filter table
  against tables.resize_filter.

The plain version is what the wrapper runs on CPU tensors; the CUDA
kernel is compared with it on the card by chip_smoke.py.
Tolerance: exact (integer codec)."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from dav1d_tpu.ops.resize import _program
from dav1d_tpu_torch import tables
from dav1d_tpu_torch.ops import resize as tresize

CSRC = Path(tresize.__file__).resolve().parent.parent / "csrc"


def _geometry(in_w, out_w):
    """(step, mx0) of the reference (src/decode.c:3524-3539)."""
    step = ((in_w << 14) + (out_w >> 1)) // out_w
    err = out_w * step - (in_w << 14)

    def cdiv(a, b):
        q = abs(a) // abs(b)
        return -q if (a < 0) != (b < 0) else q

    mx0 = (cdiv(-((out_w - in_w) << 13) + (out_w >> 1), out_w) + 128
           - cdiv(err, 2)) & 0x3FFF
    return step, mx0


CASES = [
    # (src_w coded width incl. padding, in_w, out_w): the JAX package's
    # tests/test_ops_resize.py CASES, then the 1080p luma and chroma
    (128, 120, 240),
    (256, 255, 510),
    (64, 36, 63),
    (192, 177, 320),
    (960, 960, 1920),
    (480, 480, 960),
]


def _rows(rng, n, w, bitdepth, content):
    hi = (1 << bitdepth) - 1
    if content == "random":
        return rng.integers(0, hi + 1, (n, w)).astype(np.int32)
    # extremes: 0 / 2^bd - 1 alternating in runs, where the negative
    # outer taps drive the sum below 0 and above the pixel range
    return (rng.random((n, w)) < 0.5).astype(np.int32) * hi


@pytest.mark.parametrize("content", ["random", "extremes"])
@pytest.mark.parametrize("bitdepth", [8, 10, 12])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_plain_matches_jax(case, bitdepth, content):
    src_w, in_w, out_w = case
    rng = np.random.default_rng(src_w * 7 + out_w + bitdepth)
    rows = _rows(rng, 6, src_w, bitdepth, content)
    step, mx0 = _geometry(in_w, out_w)
    want = np.asarray(_program(out_w, src_w, step, mx0, bitdepth)(rows))
    got = tresize.resize_plain(torch.from_numpy(rows), out_w, src_w, step,
                               mx0, bitdepth)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_plane_geometry():
    """resize_plane on a CPU plane: (H, alloc_w), the rectangle [0, h) x
    [0, out_w) resampled from [0, h) x [0, src_w) (columns beyond src_w
    not read), zero elsewhere, a new tensor; the input unchanged."""
    rng = np.random.default_rng(5)
    H, W, h, src_w, in_w, out_w, alloc_w = 40, 72, 35, 68, 60, 120, 128
    plane = torch.from_numpy(rng.integers(0, 1024, (H, W)).astype(np.int32))
    before = plane.clone()
    step, mx0 = _geometry(in_w, out_w)
    out = tresize.resize_plane(plane, out_w, src_w, step, mx0, h, alloc_w,
                               10)
    assert out.shape == (H, alloc_w) and out.dtype == torch.int32
    assert out.data_ptr() != plane.data_ptr()
    assert torch.equal(plane, before)
    assert torch.equal(out[:h, :out_w], tresize.resize_plain(
        plane[:h, :src_w], out_w, src_w, step, mx0, 10))
    assert not out[h:].any() and not out[:, out_w:].any()
    junk = plane.clone()
    junk[:, src_w:] = 1 << 20
    assert torch.equal(tresize.resize_plane(junk, out_w, src_w, step, mx0,
                                            h, alloc_w, 10), out)


@pytest.mark.parametrize("bad", [
    dict(src_w=73), dict(h=41), dict(out_w=129), dict(bitdepth=9)])
def test_wrapper_refuses_bad_geometry(bad):
    plane = torch.zeros((40, 72), dtype=torch.int32)
    step, mx0 = _geometry(60, 120)
    kw = dict(out_w=120, src_w=68, step=step, mx0=mx0, h=35, alloc_w=128,
              bitdepth=10)
    kw.update(bad)
    with pytest.raises(ValueError):
        tresize.resize_plane(plane, **kw)


_HARNESS = r"""
#include "resize_core.cuh"

// the kernel's threads in turn: one column of up to 8 rows each
extern "C" void resize_host(const int* src, int src_stride, int src_w,
                            int h, int* out, int out_rows, int out_stride,
                            int out_w, int step, int mx0, int bitdepth) {
    const rs::Params p{src, src_stride, src_w, h, out_w, out_stride,
                       step, mx0, (1 << bitdepth) - 1};
    for (int y0 = 0; y0 < out_rows; y0 += rs::ROWS)
        for (int x = 0; x < out_stride; x++)
            rs::column(p, x, y0,
                       out_rows - y0 < rs::ROWS ? out_rows - y0 : rs::ROWS,
                       out + y0 * out_stride + x);
}

extern "C" const signed char* resize_filter_host() {
    return &rs::FILTER[0][0];
}
"""


@pytest.fixture(scope="module")
def kernel_on_host(tmp_path_factory):
    """resize_core.cuh built as host C++ (ctypes)."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no C++ compiler")
    d = tmp_path_factory.mktemp("resize_host")
    (d / "harness.cpp").write_text(_HARNESS)
    so = d / "libresize_host.so"
    r = subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                        "-I", str(CSRC), "-o", str(so),
                        str(d / "harness.cpp")],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.resize_host.argtypes = [P, I, I, I, P, I, I, I, I, I, I]
    lib.resize_host.restype = None
    lib.resize_filter_host.restype = ctypes.POINTER(ctypes.c_int8)
    return lib


def test_kernel_filter_table_on_host(kernel_on_host):
    got = np.ctypeslib.as_array(kernel_on_host.resize_filter_host(),
                                (64, 8))
    np.testing.assert_array_equal(got, tables.resize_filter)


@pytest.mark.parametrize("content", ["random", "extremes"])
@pytest.mark.parametrize("bitdepth", [8, 10, 12])
@pytest.mark.parametrize("case", [c for c in CASES if c[0] < 960] +
                         [(960, 960, 1920)],
                         ids=lambda c: "x".join(map(str, c)))
def test_kernel_source_on_host(kernel_on_host, case, bitdepth, content):
    """resize_core.cuh thread by thread over an allocation-sized plane
    (rows beyond h and columns beyond out_w written 0; a last row block
    of fewer than 8 rows) equals the plain version; junk in the source
    beyond src_w and h is never read."""
    src_w, in_w, out_w = case
    rng = np.random.default_rng(src_w + out_w * 3 + bitdepth)
    h = 11
    H, W = h + 3, src_w + 5
    alloc_w = (out_w + 127) & ~127
    plane = np.full((H, W), 1 << 20, np.int32)
    plane[:h, :src_w] = _rows(rng, h, src_w, bitdepth, content)
    step, mx0 = _geometry(in_w, out_w)
    want = tresize.resize_plane_plain(torch.from_numpy(plane), out_w, src_w,
                                      step, mx0, h, alloc_w,
                                      bitdepth).numpy()
    got = np.full((H, alloc_w), -1, np.int32)
    kernel_on_host.resize_host(plane.ctypes.data, W, src_w, h,
                               got.ctypes.data, H, alloc_w, out_w, step,
                               mx0, bitdepth)
    np.testing.assert_array_equal(got, want)
