"""dav1d_tpu_torch film grain (ops/fg.py, recon/filmgrain.py) vs the JAX
package and the port's native host tier, bit-exact.

* :func:`scaling_segments` against dav1d_tpu/ops/fg.scaling_segments;
* the plain apply in both scale forms (the LUT gather and the 13
  closed-form segments with the two-stage sub-interpolation) against
  dav1d_tpu/ops/fg.fg_apply_batch at 8 and 10-bit, on the setup of
  tests/test_ops_device.py (random pixels, grain and LUT) and on the
  LUTs and segments of random scaling points;
* the block offsets (:func:`row_offsets`) against dav1d_tpu/recon/
  filmgrain._block_offsets, and the plain grain rows against its
  _grain_blocks over every block row, for luma and 4:2:0 / 4:2:2 / 4:4:4
  chroma, overlap on and off, odd widths and short last rows;
* a whole plane (:func:`apply_plane_plain`: grain rows, chroma index,
  apply) against the port's native host tier
  (recon/filmgrain._apply_grain_native): luma, chroma from luma, chroma
  with uv_mult, odd sizes, overlap on and off, restricted range, 8/10/12-
  bit;
* the kernel's phases, ``csrc/fg_core.cuh`` built as host C++ and run
  CTA by CTA as the kernel runs them (every thread's loads of its 4-pixel
  groups, the scaling LUT's staging, every thread's grain and stores),
  against the plain version on the same planes (``-k host``), 12-bit
  extremes included, with 1, 2, 4 and 8 rows a thread; and on planes whose
  rows are not 16-byte aligned (a row stride of w + 1, a ``src`` that
  starts 1-3 columns into its allocation), where the ragged groups take
  the scalar loads and stores.

Tolerance: exact (integer codec)."""

import ctypes
import shutil
import subprocess
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from dav1d_tpu.ops import fg as jfg
from dav1d_tpu.recon import filmgrain as jfilm
from dav1d_tpu_torch.headers import FilmGrainData, PixelLayout
from dav1d_tpu_torch.ops import fg as tfg
from dav1d_tpu_torch.recon import filmgrain as tfilm

CSRC = Path(tfg.__file__).resolve().parent.parent / "csrc"


def _points(rng, n):
    xs = np.sort(rng.choice(256, n, replace=False))
    return [(int(x), int(rng.integers(0, 256))) for x in xs]


def _data(rng, bitdepth, overlap=1, csfl=0, lag=2, restricted=0):
    d = FilmGrainData()
    d.seed = int(rng.integers(0, 1 << 16))
    d.num_y_points = int(rng.integers(2, 15))
    d.y_points = _points(rng, d.num_y_points)
    d.chroma_scaling_from_luma = csfl
    for uv in range(2):
        n = 0 if csfl else int(rng.integers(1, 11))
        d.num_uv_points[uv] = n
        d.uv_points[uv] = _points(rng, n)
        d.uv_mult[uv] = int(rng.integers(-128, 128))
        d.uv_luma_mult[uv] = int(rng.integers(-128, 128))
        d.uv_offset[uv] = int(rng.integers(-256, 256))
    d.scaling_shift = int(rng.integers(8, 12))
    d.ar_coeff_lag = lag
    n_y = 2 * lag * (lag + 1)
    d.ar_coeffs_y = [int(v) for v in rng.integers(-40, 40, n_y)]
    d.ar_coeffs_uv = [[int(v) for v in rng.integers(-40, 40, n_y + 1)]
                      for _ in range(2)]
    d.ar_coeff_shift = int(rng.integers(6, 10))
    d.grain_scale_shift = int(rng.integers(0, 2))
    d.overlap_flag = overlap
    d.clip_to_restricted_range = restricted
    return d


# ---- scale forms ---------------------------------------------------------

def test_scaling_segments_match_jax():
    rng = np.random.default_rng(1)
    for n in (0, 1, 2, 7, 14):
        pts = _points(rng, n)
        for a, b in zip(tfg.scaling_segments(pts, n),
                        jfg.scaling_segments(pts, n)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bitdepth", [8, 10])
def test_plain_apply_lut_matches_jax(bitdepth):
    """tests/test_ops_device.py:74's setup: random pixels, grain, LUT."""
    rng = np.random.default_rng(bitdepth)
    h, w = 96, 160
    src = rng.integers(0, 1 << bitdepth, (h, w), dtype=np.int64)
    gctr = 128 << (bitdepth - 8)
    grain = rng.integers(-gctr, gctr, (h, w), dtype=np.int64)
    lut = rng.integers(0, 256, 1 << bitdepth, dtype=np.int64)
    minv, maxv = 16 << (bitdepth - 8), 235 << (bitdepth - 8)
    want = jfg.fg_apply_batch(src, grain, lut, 8, minv, maxv)
    got = tfg.plain_apply(torch.from_numpy(src), torch.from_numpy(src),
                          torch.from_numpy(grain), 8, minv, maxv,
                          lut=torch.from_numpy(lut))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bitdepth", [8, 10])
@pytest.mark.parametrize("n", [1, 2, 9, 14])
def test_plain_apply_segments_match_jax(bitdepth, n):
    """The segments form against the JAX device program, and both forms
    against each other on the native scaling LUT of the same points."""
    from dav1d_tpu_torch.native import lib

    rng = np.random.default_rng(n * 3 + bitdepth)
    h, w = 64, 96
    pts = _points(rng, n)
    idx = rng.integers(0, 1 << bitdepth, (h, w), dtype=np.int64)
    src = rng.integers(0, 1 << bitdepth, (h, w), dtype=np.int64)
    gctr = 128 << (bitdepth - 8)
    grain = rng.integers(-gctr, gctr, (h, w), dtype=np.int64)
    seg = jfg.scaling_segments(pts, n)
    want = jfg.fg_apply_batch(src, grain, None, 10, 0, (1 << bitdepth) - 1,
                              idx=idx, segments=seg, bitdepth=bitdepth)
    t = torch.from_numpy
    got = tfg.plain_apply(t(src), t(idx), t(grain), 10, 0,
                          (1 << bitdepth) - 1,
                          segments=[t(a) for a in tfg.scaling_segments(pts,
                                                                       n)],
                          bitdepth=bitdepth)
    np.testing.assert_array_equal(got.numpy(), want)
    lut = tfilm._scaling(lib, bitdepth, pts, n)
    via_lut = tfg.plain_apply(t(src), t(idx), t(grain), 10, 0,
                              (1 << bitdepth) - 1, lut=t(lut))
    np.testing.assert_array_equal(via_lut.numpy(), want)


# ---- grain rows ----------------------------------------------------------

@pytest.mark.parametrize("overlap", [0, 1])
def test_row_offsets_match_jax(overlap):
    rng = np.random.default_rng(overlap)
    d = _data(rng, 8, overlap=overlap)
    offs = tfg.row_offsets(d.seed, overlap, 9, 13)
    for row in range(9):
        want, rows = jfilm._block_offsets(d, row, 13 * 32, 0)
        np.testing.assert_array_equal(offs[row, :, :rows], want[:, :rows])


# (ss_x, ss_y): luma, 4:2:0, 4:2:2, 4:4:4 chroma
LAYOUTS = {"luma": (0, 0), "420": (1, 1), "422": (1, 0), "444": (0, 0)}


@pytest.mark.parametrize("overlap", [0, 1])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("bitdepth", [8, 10])
def test_grain_rows_match_jax(layout, overlap, bitdepth):
    rng = np.random.default_rng(bitdepth * 7 + overlap)
    d = _data(rng, bitdepth, overlap=overlap)
    ss_x, ss_y = LAYOUTS[layout]
    lut_y = jfilm.generate_grain_y(d, bitdepth)
    lut = lut_y if layout == "luma" else \
        jfilm.generate_grain_uv(d, lut_y, 1, ss_x, ss_y, bitdepth)
    W, H = 203, 77  # odd: short last block and block row
    pw, ph = (W + ss_x) >> ss_x, (H + ss_y) >> ss_y
    gctr = 128 << (bitdepth - 8)
    bszy = 32 >> ss_y
    want = np.concatenate([
        jfilm._grain_blocks(d, lut, row, pw, min(bszy, ph - row * bszy),
                            ss_x, ss_y, -gctr, gctr - 1)
        for row in range(-(-ph // bszy))])
    offs = tfg.row_offsets(d.seed, overlap, -(-H // 32), -(-W // 32))
    got = tfg.plain_grain_rows(torch.from_numpy(lut.astype(np.int32)),
                               torch.from_numpy(offs), pw, ph, ss_x, ss_y,
                               overlap, bitdepth)
    np.testing.assert_array_equal(got.numpy(), want)


# ---- whole planes --------------------------------------------------------

# (layout, width, height, chroma_scaling_from_luma, overlap, restricted)
PLANES = [
    (PixelLayout.I420, 203, 77, 0, 1, 0),
    (PixelLayout.I420, 160, 96, 1, 0, 1),
    (PixelLayout.I422, 97, 70, 0, 0, 1),
    (PixelLayout.I444, 66, 45, 1, 1, 0),
    (PixelLayout.I400, 75, 33, 0, 1, 0),
]


def _picture(rng, layout, w, h, bitdepth, csfl, overlap, restricted,
             pixels="random"):
    d = _data(rng, bitdepth, overlap=overlap, csfl=csfl,
              restricted=restricted)
    ss_x = int(layout != PixelLayout.I444)
    ss_y = int(layout == PixelLayout.I420)
    dims = [(h, w)] + ([((h + ss_y) >> ss_y, (w + ss_x) >> ss_x)] * 2
                       if layout != PixelLayout.I400 else [])
    hi = (1 << bitdepth) - 1
    if pixels == "extremes":
        planes = [rng.choice(np.array([0, 1, hi - 1, hi]), s).astype(
            np.int32) for s in dims]
    else:
        planes = [rng.integers(0, hi + 1, s).astype(np.int32) for s in dims]
    hdr = types.SimpleNamespace(film_grain=types.SimpleNamespace(data=d))
    return types.SimpleNamespace(
        frame_hdr=hdr, seq_hdr=types.SimpleNamespace(mtrx=1), layout=layout,
        bitdepth=bitdepth, width=w, height=h, planes=planes)


def _plain_planes(pic):
    """Every plane with grain through apply_plane_plain."""
    _, tabs = tfilm.grain_tables(pic)
    prm = tfilm.plane_params(pic)
    d = pic.frame_hdr.film_grain.data
    offs = torch.from_numpy(tfg.row_offsets(
        d.seed, d.overlap_flag, -(-pic.height // 32), -(-pic.width // 32)))
    luma = torch.from_numpy(pic.planes[0])
    out = {}
    for pl, (lut, sc) in tabs.items():
        src = torch.from_numpy(pic.planes[pl])
        h, w = pic.planes[pl].shape
        out[pl] = tfg.apply_plane(src, luma, torch.from_numpy(lut),
                                  torch.from_numpy(sc), offs, w, h,
                                  pic.width, prm[pl]).numpy()
    return out, tabs, prm, offs


@pytest.mark.parametrize("bitdepth", [8, 10, 12])
@pytest.mark.parametrize("case", range(len(PLANES)))
def test_apply_plane_plain_matches_native(case, bitdepth):
    rng = np.random.default_rng(case * 5 + bitdepth)
    pic = _picture(rng, *PLANES[case][:3], bitdepth, *PLANES[case][3:])
    got, tabs, _, _ = _plain_planes(pic)
    tfilm._apply_grain_native(pic)
    assert sorted(got) == sorted(tabs)
    for pl, g in got.items():
        np.testing.assert_array_equal(g, pic.planes[pl], err_msg=f"pl {pl}")


def test_apply_grain_plain_device_path_matches_native():
    """recon/filmgrain.apply_grain on the CPU (uploads, one plain plane
    pass each, downloads) equals the host tier."""
    rng = np.random.default_rng(11)
    pic = _picture(rng, PixelLayout.I420, 131, 67, 10, 0, 1, 1)
    host = _picture(np.random.default_rng(11), PixelLayout.I420, 131, 67,
                    10, 0, 1, 1)
    tfilm.apply_grain(pic, torch.device("cpu"))
    tfilm._apply_grain_native(host)
    for a, b in zip(pic.planes, host.planes):
        np.testing.assert_array_equal(a, b)


# ---- the kernel's arithmetic on the host ---------------------------------

_HOST_SRC = r"""
#include <string.h>
#include "fg_core.cuh"

// The kernel (csrc/fg.cu fg_kernel) CTA by CTA, each phase run by the
// CTA's threads one after the other: every thread's loads, the scaling
// LUT's staging, every thread's grain, index, scale and stores.
template <bool CHROMA, int ROWS>
static void run(const fg::Planes& pl, const int* lut, const int* scaling,
                const int* offs, int n_blocks, const fg::Params& p) {
    static fg::Regs<CHROMA, ROWS> r[fg::THREADS];
    static short s_sc[4096];
    const int nx = (pl.w + fg::GX * 4 - 1) / (fg::GX * 4);
    const int ny = (pl.h + fg::GY * ROWS - 1) / (fg::GY * ROWS);
    for (int by = 0; by < ny; by++)
        for (int bx = 0; bx < nx; bx++) {
            // registers and shared memory start undefined
            memset(r, 0x5A, sizeof r);
            memset(s_sc, 0x5A, sizeof s_sc);
            for (int t = 0; t < fg::THREADS; t++)
                fg::load(r[t], pl, offs, n_blocks, fg::group_x(bx, t),
                         fg::group_y<ROWS>(by, t), p);
            for (int t = 0; t < fg::THREADS; t++)
                fg::stage_scaling(s_sc, scaling, p.bd, t, fg::THREADS);
            for (int t = 0; t < fg::THREADS; t++)
                fg::finish(r[t], s_sc, pl, lut, offs, n_blocks,
                           fg::group_x(bx, t), fg::group_y<ROWS>(by, t), p);
        }
}

extern "C" void fg_host(const int* src, long long ss, const int* luma,
                        long long ls, int lw, int* out, int w, int h,
                        const int* lut, const int* scaling, const int* offs,
                        int n_blocks, const int* prm) {
    const fg::Params p{prm[0], prm[1], prm[2], prm[3], prm[4], prm[5],
                       prm[6], prm[7], prm[8], prm[9], prm[10], prm[11]};
    const fg::Planes pl{src, ss, luma, ls, lw, out, w, h};
    if (p.pl)
        run<true, fg::ROWS_CHROMA>(pl, lut, scaling, offs, n_blocks, p);
    else
        run<false, fg::ROWS_LUMA>(pl, lut, scaling, offs, n_blocks, p);
}
"""


@pytest.fixture(scope="module")
def kernel_on_host(tmp_path_factory):
    """fg_core.cuh built as host C++ (ctypes)."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no C++ compiler")
    d = tmp_path_factory.mktemp("fg_host")
    (d / "fg_host.cc").write_text(_HOST_SRC)
    so = d / "libfg_host.so"
    r = subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                        "-I", str(CSRC), "-o", str(so), str(d / "fg_host.cc")],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    lib = ctypes.CDLL(str(so))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fg_host.argtypes = [P, L, P, L, I, P, I, I, P, P, P, I, P]
    lib.fg_host.restype = None
    return lib


def _host_planes(lib, pic, tabs, prm, offs, planes=None):
    """Every plane with grain through the host build; ``planes``: the
    int32 (possibly strided) views to read, default pic.planes."""
    planes = pic.planes if planes is None else planes
    luma = planes[0]
    o = np.ascontiguousarray(offs.numpy())
    out = {}
    for pl, (lut, sc) in tabs.items():
        src = planes[pl]
        h, w = src.shape
        out[pl] = np.zeros((h, w), np.int32)
        ints = (ctypes.c_int * tfg.N_PARAMS)(*prm[pl].ints())
        lib.fg_host(src.ctypes.data, src.strides[0] // 4, luma.ctypes.data,
                    luma.strides[0] // 4, pic.width, out[pl].ctypes.data, w,
                    h, lut.ctypes.data, sc.ctypes.data, o.ctypes.data,
                    o.shape[1], ints)
    return out


@pytest.mark.parametrize("pixels", ["random", "extremes"])
@pytest.mark.parametrize("bitdepth", [8, 10, 12])
@pytest.mark.parametrize("case", range(len(PLANES)))
def test_kernel_source_on_host(kernel_on_host, case, bitdepth, pixels):
    rng = np.random.default_rng(case * 13 + bitdepth)
    pic = _picture(rng, *PLANES[case][:3], bitdepth, *PLANES[case][3:],
                   pixels=pixels)
    want, tabs, prm, offs = _plain_planes(pic)
    got = _host_planes(kernel_on_host, pic, tabs, prm, offs)
    for pl in tabs:
        np.testing.assert_array_equal(got[pl], want[pl], err_msg=f"pl {pl}")


def _embed(a, extra, col):
    """``a`` as a view ``col`` columns into an allocation ``extra``
    columns wider (junk around it)."""
    h, w = a.shape
    big = np.full((h, w + extra), 12345, np.int32)
    big[:, col:col + w] = a
    return big[:, col:col + w]


def _groups(planes, pl, w, h):
    """(whole 16-byte-aligned groups, ragged groups) of plane ``pl`` as the
    kernel's loads see them."""
    a = planes[pl]
    base, ss = a.ctypes.data, a.strides[0]
    x0 = np.arange(0, w, 4)
    addr = base + np.arange(h)[:, None] * ss + x0[None, :] * 4
    whole = (addr % 16 == 0) & (x0 + 4 <= w)[None, :]
    return int(whole.sum()), int((~whole).sum())


# (PLANES case, extra allocation columns, first column): a row stride of
# w + 1 (odd widths: rows 16-byte aligned one in four), a src 1-3 columns
# into its allocation; where every plane's stride w + extra is a multiple
# of 4 words ((3, 2, *), (4, 5, 3), (1, 4, 2), (2, 3, 3)) and the src
# starts 1-3 columns in, no row is 16-byte aligned
RAGGED = [(0, 1, 0), (1, 1, 0), (2, 3, 1), (3, 2, 2), (4, 5, 3), (0, 3, 3),
          (3, 2, 1), (1, 4, 2), (2, 3, 3)]


@pytest.mark.parametrize("bitdepth", [8, 10, 12])
@pytest.mark.parametrize("case", range(len(RAGGED)))
def test_kernel_ragged_on_host(kernel_on_host, case, bitdepth):
    """Planes whose rows are not all 16-byte aligned: the whole groups of
    aligned rows take the 16-byte loads and stores, the rest the scalar
    path; both equal the plain version through the same strided views."""
    k, extra, col = RAGGED[case]
    rng = np.random.default_rng(case * 7 + bitdepth)
    pic = _picture(rng, *PLANES[k][:3], bitdepth, *PLANES[k][3:])
    views = [_embed(a, extra, col) for a in pic.planes]
    want, tabs, prm, offs = _plain_planes(pic)
    luma = torch.from_numpy(views[0])
    for pl, (lut, sc) in tabs.items():
        h, w = pic.planes[pl].shape
        plain = tfg.apply_plane(torch.from_numpy(views[pl]), luma,
                                torch.from_numpy(lut), torch.from_numpy(sc),
                                offs, w, h, pic.width, prm[pl])
        np.testing.assert_array_equal(plain.numpy(), want[pl])
        whole, ragged = _groups(views, pl, w, h)
        aligned_rows = (col + np.arange(h) * (w + extra)) % 4 == 0
        assert ragged > 0 and (whole > 0) == (aligned_rows.any() and w >= 4)
    got = _host_planes(kernel_on_host, pic, tabs, prm, offs, views)
    for pl in tabs:
        np.testing.assert_array_equal(got[pl], want[pl], err_msg=f"pl {pl}")
