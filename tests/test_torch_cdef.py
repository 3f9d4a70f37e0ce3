"""dav1d_tpu_torch CDEF (ops/cdef.py) vs the JAX package, bit-exact.

* the plain direction search vs ops/cdef.cdef_find_dir_maps_dev (the XLA
  program the chain runs) and the numpy golden batch;
* the plain resident filter vs pallas_cdef.cdef_filter_plane_resident
  (interpret mode on the CPU backend), luma and chroma, 4:2:0 and
  4:2:2, bit depths 8/10/12, random unit maps with absent units, units
  without direction, empty bands, and a plane larger than its filtered
  region;
* the port's cost-lattice bins and weights vs ops/cdef._cost_weights()
  and recon/cdef._onehot_maps();
* the direction kernel's own arithmetic, ``csrc/cdef_dir_core.cuh``
  built as host C++ and run block by block, as the kernel's threads run
  it, against the plain direction search: noise, flat blocks (tied
  costs: the first maximum wins), blocks at 0 and at 2^bd - 1 and
  0 / 2^bd - 1 checkerboards (the largest partial sums),
  transpose-symmetric blocks (costs tied between two directions),
  planes larger than their 8x8 grid, bit depths 8/10/12;
* the filter kernel's own arithmetic, ``csrc/cdef_core.cuh`` built as
  host C++ and run tile by tile, the CTA's 256 threads in turn per
  phase, against the plain filter: units 8x8 (luma, 4:4:4 chroma), 4x4
  (4:2:0) and 4x8 (4:2:2), filtered regions and planes that are not
  multiples of the 16 x 64 tile (one of them not a multiple of 4 wide:
  the scalar path), empty tiles, units beyond the direction maps, bit
  depths 8/10/12, noise and spikes (at mid range and up to 2^bd - 1);
* the filter's band form (the canvas of a row band with 0 or 2 halo
  rows above and below, recon/mesh_cdef.py): the plain version on every
  band of a plane cut into 64- or 32-row bands equals the whole-plane
  plain version on the band's rows, luma, 4:2:0, 4:2:2 and 4:4:4,
  bit depths 8/10/12, and the kernel's header built as host C++ runs
  the same bands equal to the plain band form; the wrapper refuses halo
  rows other than 0 or 2, and rows below a band not filtered to its end.

The plain versions are what the wrappers run on CPU tensors; the CUDA
kernels are compared with them on the card by chip_smoke.py.
Tolerance: exact (integer codec)."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dav1d_tpu.ops import cdef as dcdef
from dav1d_tpu.ops.pallas_cdef import cdef_filter_plane_resident
from dav1d_tpu.recon.cdef import cdef_find_dir_batch_np
from dav1d_tpu_torch import state
from dav1d_tpu_torch.ops import cdef as tcdef

CSRC = Path(tcdef.__file__).resolve().parent.parent / "csrc"


def test_cost_weights_match_reference():
    """state.cdef_bin_weights() (8, 15) laid out as the reference's
    (128, 8) matrix: the 8 partial-sum sets concatenated (15, 11, 8, 11,
    15, 11, 8, 11 bins), cost row d weighting set d."""
    bw = state.cdef_bin_weights()
    w = np.zeros((128, 8), dtype=np.int32)
    off = 0
    for d, n in enumerate((15, 11, 8, 11, 15, 11, 8, 11)):
        w[off:off + n, d] = bw[d, :n]
        assert not bw[d, n:].any()
        off += n
    assert np.array_equal(w, dcdef._cost_weights().astype(np.int32))


def test_bin_index_matches_onehot_maps():
    from dav1d_tpu.recon.cdef import _onehot_maps

    idx = state.cdef_bin_index()
    for d, m in enumerate(_onehot_maps()):
        assert np.array_equal(np.argmax(m, axis=1), idx[d])


def _dir_plane(rng, ph, pw, bitdepth):
    """Directional ramps plus noise, with a quarter of the 8x8 blocks
    flat mid-grey (every cost 0: the strict first maximum must pick
    direction 0) and a quarter flat at other levels."""
    hi = 1 << bitdepth
    yy, xx = np.mgrid[0:ph, 0:pw]
    plane = ((yy * 3 + xx * rng.integers(-4, 5)) * (hi // 256)
             + rng.integers(0, hi // 4, (ph, pw))) % hi
    kind = np.repeat(np.repeat(rng.integers(0, 4, (-(-ph // 8), -(-pw // 8))),
                               8, 0), 8, 1)[:ph, :pw]
    level = np.repeat(np.repeat(rng.integers(0, hi, (-(-ph // 8),
                                                     -(-pw // 8))),
                                8, 0), 8, 1)[:ph, :pw]
    plane = np.where(kind == 0, 128 << (bitdepth - 8), plane)
    plane = np.where(kind == 1, level, plane)
    return plane.astype(np.int32)


@pytest.mark.parametrize("bitdepth", [8, 10, 12])
@pytest.mark.parametrize("ph,pw", [(64, 96), (68, 100)])
def test_plain_dir_matches_xla(bitdepth, ph, pw):
    rng = np.random.default_rng(bitdepth + ph)
    plane = _dir_plane(rng, ph, pw, bitdepth)
    d_ref, v_ref = dcdef.cdef_find_dir_maps_dev(jnp.asarray(plane),
                                                bitdepth)
    d, v = tcdef.find_dir_maps(torch.from_numpy(plane), bitdepth)
    assert np.array_equal(d.numpy(), np.asarray(d_ref))
    assert np.array_equal(v.numpy(), np.asarray(v_ref))
    # and the numpy golden batch on the same blocks
    R8, W8 = ph // 8, pw // 8
    blk = plane[:R8 * 8, :W8 * 8].reshape(R8, 8, W8, 8) \
        .transpose(0, 2, 1, 3).reshape(-1, 8, 8)
    dg, vg = cdef_find_dir_batch_np(blk, bitdepth)
    assert np.array_equal(d.numpy().ravel(), dg)
    assert np.array_equal(v.numpy().ravel(), vg)


def _units(rng, nb, nc, bitdepth, frac_on=0.6):
    """Random unit strengths: absent units, pri-only, sec-only, both."""
    s = bitdepth - 8
    on = rng.random((nb, nc)) < frac_on
    pri = rng.integers(0, 16, (nb, nc)) * on
    sec = rng.integers(0, 4, (nb, nc))
    sec = (sec + (sec == 3)) * on
    return (pri << s).astype(np.int64), (sec << s).astype(np.int64)


CASES = [
    # (luma, layout_422, w, h, ph, pw, H, W)
    (True, False, 8, 8, 64, 96, 64, 96),
    (True, False, 8, 8, 60, 92, 64, 96),    # filtered region < plane
    (False, False, 4, 4, 32, 48, 32, 48),   # 4:2:0 chroma
    (False, True, 4, 8, 64, 48, 64, 48),    # 4:2:2 chroma
    (False, False, 4, 4, 30, 46, 32, 48),
]


@pytest.mark.parametrize("content", ["noise", "spikes", "top"])
@pytest.mark.parametrize("bitdepth", [8, 10, 12])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_plain_filter_matches_pallas_resident(case, bitdepth, content):
    """noise: random strengths over random pixels.  spikes: isolated
    bright pixels on a flat plane under the strongest strengths, where
    the [min, max] clip bites — also next to the plane edge, where the
    sentinel must not count as a minimum."""
    luma, l422, w, h, ph, pw, H, W = case
    rng = np.random.default_rng(bitdepth * 31 + ph + w)
    nb, nc = -(-ph // h), -(-pw // w)
    s = bitdepth - 8
    if content == "noise":
        plane = rng.integers(0, 1 << bitdepth, (H, W)).astype(np.int32)
        pri, sec = _units(rng, nb, nc, bitdepth)
    else:
        base = (1 << bitdepth) - 1 - (4 << s) if content == "top" \
            else 128 << s
        plane = base + ((rng.random((H, W)) < 0.1).astype(np.int32)
                        << (2 + s))
        pri = np.full((nb, nc), 15 << s, np.int64)
        sec = np.full((nb, nc), 4 << s, np.int64)
    uys, uxs = np.nonzero((pri | sec) != 0)
    uys, uxs = uys * h, uxs * w
    upri, usec = pri[uys // h, uxs // w], sec[uys // h, uxs // w]
    # direction / variance maps of a luma plane covering these units
    luma_plane = rng.integers(0, 1 << bitdepth,
                              (nb * 8, nc * 8)).astype(np.int32)
    dmap, vmap = dcdef.cdef_find_dir_maps_dev(jnp.asarray(luma_plane),
                                              bitdepth)
    damping = 4 + (bitdepth - 8) + int(rng.integers(0, 3)) - (0 if luma
                                                              else 1)
    want = np.asarray(cdef_filter_plane_resident(
        jnp.asarray(plane), dmap, vmap, ph, pw, uys, uxs, w, h, upri,
        usec, damping, bitdepth, luma, l422, interpret=True))
    got = tcdef.cdef_filter_plane_resident(
        torch.from_numpy(plane), torch.from_numpy(np.array(dmap)),
        torch.from_numpy(np.array(vmap)), ph, pw, uys, uxs, w, h, upri,
        usec, damping, bitdepth, luma, l422).numpy()
    assert np.array_equal(got, want), \
        f"mismatch at {np.argwhere(got != want)[:4]}"


@pytest.mark.parametrize("w,h", [(8, 8), (4, 4)])
def test_empty_bands_pass_through(w, h):
    """Units only in the first unit row: every later band passes
    through unchanged, in both tiers."""
    bitdepth, ph, pw = 8, 96, 192
    rng = np.random.default_rng(7 + w)
    plane = rng.integers(0, 256, (ph, pw)).astype(np.int32)
    nc = pw // w
    uys = np.zeros(nc, np.int64)
    uxs = np.arange(nc, dtype=np.int64) * w
    pri = rng.integers(1, 16, nc).astype(np.int64)
    sec = rng.integers(0, 5, nc).astype(np.int64)
    # one map cell per unit, as the luma 8x8 grid gives chroma units
    dmap = np.asarray(rng.integers(0, 8, (ph // h, pw // w)), np.int32)
    vmap = np.asarray(rng.integers(0, 1 << 12, dmap.shape), np.int32)
    luma = w == 8
    want = np.asarray(cdef_filter_plane_resident(
        jnp.asarray(plane), jnp.asarray(dmap), jnp.asarray(vmap), ph, pw,
        uys, uxs, w, h, pri, sec, 5 - (not luma), bitdepth, luma, False,
        interpret=True))
    got = tcdef.cdef_filter_plane_resident(
        torch.from_numpy(plane), torch.from_numpy(dmap),
        torch.from_numpy(vmap), ph, pw, uys, uxs, w, h, pri, sec,
        5 - (not luma), bitdepth, luma, False).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got[h:], plane[h:])


def test_wrappers_reject_bad_inputs():
    p = torch.zeros((16, 16), dtype=torch.int32)
    with pytest.raises(TypeError):
        tcdef.find_dir_maps(p.to(torch.int16), 8)
    with pytest.raises(ValueError):
        tcdef.find_dir_maps(p, 9)
    m = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError):  # map shape does not match the units
        tcdef.filter_plane(p, m[:1], m, m, m, 16, 16, 8, 8, 5, 8, True,
                           False)
    m1 = m[:, :1].contiguous()  # the grid of 8x16 units
    with pytest.raises(ValueError, match="unit 16x8"):
        tcdef.filter_plane(p, m1, m1, m, m, 16, 16, 16, 8, 5, 8, True,
                           False)
    with pytest.raises(ValueError):
        tcdef.filter_plane(p.to("meta"), m.to("meta"), m.to("meta"),
                           m.to("meta"), m.to("meta"), 16, 16, 8, 8, 5, 8,
                           True, False)


_HARNESS = r"""
#include "cdef_core.cuh"

extern "C" void cdef_host(const int* src, int* dst, int H, int W, int ph,
                          int pw, int top, int bot, const int* pm,
                          const int* sm, int ncols, const int* dmap,
                          const int* vmap, int R8, int W8, int lw, int lh,
                          int damping, int bitdepth, int luma, int l422,
                          int vec) {
    // src: the canvas of top + H + bot rows, as dtpu_cdef_filter takes it
    const cdef::Plane p{src + (long long)top * W, dst, H, W, ph, pw, top,
                        bot, pm, sm, (ph + (1 << lh) - 1) >> lh, ncols,
                        dmap, vmap, R8, W8, lw, lh, damping, bitdepth - 8,
                        luma, l422, vec};
    static cdef::Tile s;
    const int nt = 256;  // the kernel's CTA; each loop is one phase
    for (int y0 = 0; y0 < H; y0 += cdef::TILE_H)
        for (int x0 = 0; x0 < W; x0 += cdef::TILE_W) {
            if (y0 < ph && x0 < pw) {
                bool any = false;  // the kernel's __syncthreads_or
                for (int t = 0; t < nt; t++) {
                    any |= cdef::units(s, p, y0, x0, t, nt);
                    cdef::stage(s, p, y0, x0, t, nt);
                }
                if (any) {
                    for (int t = 0; t < nt; t++)
                        cdef::filter(s, p, y0, x0, t, nt);
                    continue;
                }
            }
            for (int t = 0; t < nt; t++) cdef::copy(p, y0, x0, t, nt);
        }
}
"""


@pytest.fixture(scope="module")
def kernel_on_host(tmp_path_factory):
    """The filter kernel's arithmetic header built as host C++ (a ctypes
    function running every tile's phases for 256 threads in turn)."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no C++ compiler")
    d = tmp_path_factory.mktemp("cdef_host")
    (d / "harness.cpp").write_text(_HARNESS)
    so = d / "libcdef_host.so"
    r = subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                        "-I", str(CSRC), "-o", str(so),
                        str(d / "harness.cpp")],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.cdef_host.argtypes = [P, P, I, I, I, I, I, I, P, P, I, P, P, I, I,
                              I, I, I, I, I, I, I]
    lib.cdef_host.restype = None
    return lib


HOST_CASES = [
    # (luma, layout_422, w, h, ph, pw, H, W): planes not a multiple of
    # the 16 x 64 tile; the first region ends on a tile edge, where the
    # halo beyond it must read the sentinel
    (True, False, 8, 8, 32, 64, 40, 72),
    (True, False, 8, 8, 37, 131, 40, 136),
    (False, False, 8, 8, 40, 72, 44, 80),     # 4:4:4 chroma
    (False, False, 4, 4, 18, 66, 20, 70),     # 4:2:0, W % 4 != 0
    (False, True, 4, 8, 36, 66, 40, 68),      # 4:2:2
]


@pytest.mark.parametrize("content", ["noise", "spikes", "top"])
@pytest.mark.parametrize("bitdepth", [8, 10, 12])
@pytest.mark.parametrize("case", HOST_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_kernel_source_on_host(kernel_on_host, case, bitdepth, content):
    """cdef_core.cuh's phases equal the plain filter exactly.  The unit
    maps leave one band of tiles without an active unit and stop short of
    the last unit row and column (units beyond them read dir = var = 0);
    spikes: strongest strengths on a flat plane with bright pixels, where
    the [min, max] clip bites next to the sentinel; top: the same with
    the spikes at the largest pixel value, 2^bitdepth - 1."""
    luma, l422, w, h, ph, pw, H, W = case
    rng = np.random.default_rng(bitdepth * 7 + ph + w + len(content))
    nb, nc = -(-ph // h), -(-pw // w)
    s = bitdepth - 8
    if content == "noise":
        plane = rng.integers(0, 1 << bitdepth, (H, W)).astype(np.int32)
        pri, sec = _units(rng, nb, nc, bitdepth)
    else:
        base = (1 << bitdepth) - 1 - (4 << s) if content == "top" \
            else 128 << s
        plane = base + ((rng.random((H, W)) < 0.1).astype(np.int32)
                        << (2 + s))
        pri = np.full((nb, nc), 15 << s, np.int64)
        sec = np.full((nb, nc), 4 << s, np.int64)
    band = 16 // h  # unit rows of the second tile row: none active
    pri[band:2 * band] = sec[band:2 * band] = 0
    pm = torch.from_numpy(pri.astype(np.int32))
    sm = torch.from_numpy(sec.astype(np.int32))
    dmap = rng.integers(0, 8, (nb - 1, nc - 1)).astype(np.int32)
    vmap = rng.integers(0, 1 << 12, dmap.shape).astype(np.int32)
    vmap[rng.random(dmap.shape) < 0.2] = 0
    damping = 3 + int(rng.integers(0, 4)) + s - (not luma)
    want = tcdef.filter_plane_plain(
        torch.from_numpy(plane), pm, sm, torch.from_numpy(dmap),
        torch.from_numpy(vmap), ph, pw, w, h, damping, bitdepth, luma,
        l422).numpy()
    got = np.full_like(plane, -1)
    kernel_on_host.cdef_host(
        plane.ctypes.data, got.ctypes.data, H, W, ph, pw, 0, 0,
        pm.numpy().ctypes.data, sm.numpy().ctypes.data, nc,
        dmap.ctypes.data, vmap.ctypes.data, *dmap.shape, w.bit_length() - 1,
        h.bit_length() - 1, damping, bitdepth, luma, l422, W % 4 == 0)
    assert np.array_equal(got, want), \
        f"mismatch at {np.argwhere(got != want)[:4]}"
    assert not np.array_equal(want[:ph, :pw], plane[:ph, :pw])


# (luma, layout_422, w, h, ph, pw, H, W, band rows): row bands of 64 rows
# (the mesh's alignment) and of 32 (4x4 and 4x8 units, tiles that straddle
# nothing), a last band cut short by ph, and one wholly past it
BAND_CASES = [
    (True, False, 8, 8, 150, 72, 160, 72, 64),
    (False, False, 4, 4, 75, 40, 80, 40, 32),    # 4:2:0 chroma
    (False, True, 4, 8, 128, 36, 136, 40, 32),   # 4:2:2: ph on a band edge
    (False, False, 8, 8, 100, 66, 104, 68, 32),  # 4:4:4, W % 4 != 0
]


def _band_inputs(case, bitdepth, seed):
    """A plane, its unit grids, maps and damping (noise content, a band
    of unit rows with no unit), as test_kernel_source_on_host makes
    them."""
    luma, l422, w, h, ph, pw, H, W, _ = case
    rng = np.random.default_rng(seed)
    nb, nc = -(-ph // h), -(-pw // w)
    plane = rng.integers(0, 1 << bitdepth, (H, W)).astype(np.int32)
    pri, sec = _units(rng, nb, nc, bitdepth)
    pri[1:2] = sec[1:2] = 0
    dmap = rng.integers(0, 8, (nb - 1, nc)).astype(np.int32)
    vmap = rng.integers(0, 1 << 12, dmap.shape).astype(np.int32)
    damping = 3 + int(rng.integers(0, 4)) + bitdepth - 8 - (not luma)
    return (plane, pri.astype(np.int32), sec.astype(np.int32), dmap, vmap,
            damping)


def _bands(case):
    """(band, first row, top, bottom, band's ph) of every band of the
    case's rows, and the bands past ph (ph_b <= 0)."""
    ph, H, bh = case[4], case[6], case[8]
    for b in range(-(-H // bh) + 1):
        y0 = b * bh
        ph_b = min(bh, ph - y0)
        yield (b, y0, 2 if b and ph_b > 0 else 0,
               2 if y0 + bh < ph else 0, ph_b)


def _band_canvas(plane, y0, bh, top, bottom):
    """Rows y0 - top .. y0 + bh + bottom of ``plane``, zero past it."""
    H, W = plane.shape
    c = np.zeros((top + bh + bottom, W), np.int32)
    a, b = y0 - top, min(y0 + bh + bottom, H)
    c[:max(b - a, 0)] = plane[a:b]
    return c


def _band_maps(m, y0, h, ph_b):
    """Rows of a unit grid or map from the band's first unit row."""
    return np.ascontiguousarray(m[y0 // h:y0 // h + -(-ph_b // h)])


@pytest.mark.parametrize("bitdepth", [8, 10, 12])
@pytest.mark.parametrize("case", BAND_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_band_form_plain_matches_whole_plane(case, bitdepth):
    """The plain filter's band form (top / bottom halo rows of 0 or 2)
    equals the whole-plane plain filter on the band's rows, for every
    band: the first (no halo above), inner ones (both halos), the one
    that holds ph (no halo below, rows past ph pass through) and one
    past ph (no filtered row: the wrapper refuses it, the rows are the
    plane's)."""
    luma, l422, w, h, ph, pw, H, W, bh = case
    plane, pri, sec, dmap, vmap, damping = _band_inputs(case, bitdepth,
                                                        bitdepth + ph)
    t = torch.from_numpy
    args = (damping, bitdepth, luma, l422)
    want = tcdef.filter_plane_plain(t(plane), t(pri), t(sec), t(dmap),
                                    t(vmap), ph, pw, w, h, *args).numpy()
    seen = set()
    for b, y0, top, bottom, ph_b in _bands(case):
        canvas = t(_band_canvas(plane, y0, bh, top, bottom))
        if ph_b <= 0:
            with pytest.raises(ValueError):
                tcdef.filter_plane(canvas, t(pri[:0]), t(sec[:0]), t(dmap),
                                   t(vmap), ph_b, pw, w, h, *args, top,
                                   bottom)
            continue
        seen.add((top, bottom))
        got = tcdef.filter_plane(
            canvas, t(_band_maps(pri, y0, h, ph_b)),
            t(_band_maps(sec, y0, h, ph_b)),
            t(np.ascontiguousarray(dmap[y0 // h:])),
            t(np.ascontiguousarray(vmap[y0 // h:])), ph_b, pw, w, h, *args,
            top, bottom).numpy()
        n = min(bh, H - y0)
        assert got.shape == (bh, W)
        assert np.array_equal(got[:n], want[y0:y0 + n]), \
            f"band {b}: mismatch at {np.argwhere(got[:n] != want[y0:y0 + n])[:4]}"
    assert {(0, 2), (2, 2), (2, 0)} <= seen


@pytest.mark.parametrize("bitdepth", [8, 10, 12])
@pytest.mark.parametrize("case", BAND_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_band_form_kernel_source_on_host(kernel_on_host, case, bitdepth):
    """cdef_core.cuh's phases with a band origin (the canvas's top halo
    rows above the band's row 0) equal the plain band form exactly."""
    luma, l422, w, h, ph, pw, H, W, bh = case
    plane, pri, sec, dmap, vmap, damping = _band_inputs(case, bitdepth,
                                                        bitdepth * 3 + pw)
    t = torch.from_numpy
    for b, y0, top, bottom, ph_b in _bands(case):
        if ph_b <= 0:
            continue
        canvas = _band_canvas(plane, y0, bh, top, bottom)
        pm, sm = _band_maps(pri, y0, h, ph_b), _band_maps(sec, y0, h, ph_b)
        dm = np.ascontiguousarray(dmap[y0 // h:])
        vm = np.ascontiguousarray(vmap[y0 // h:])
        want = tcdef.filter_plane_plain(
            t(canvas), t(pm), t(sm), t(dm), t(vm), ph_b, pw, w, h, damping,
            bitdepth, luma, l422, top, bottom).numpy()
        got = np.full((bh, W), -1, np.int32)
        kernel_on_host.cdef_host(
            canvas.ctypes.data, got.ctypes.data, bh, W, ph_b, pw, top,
            bottom, pm.ctypes.data, sm.ctypes.data, pm.shape[1],
            dm.ctypes.data, vm.ctypes.data, *dm.shape, w.bit_length() - 1,
            h.bit_length() - 1, damping, bitdepth, luma, l422, W % 4 == 0)
        assert np.array_equal(got, want), \
            f"band {b}: mismatch at {np.argwhere(got != want)[:4]}"


def test_band_form_refusals():
    """The band wrapper refuses halo rows other than 0 or 2, and rows
    below a band that is not filtered to its end."""
    p = torch.zeros((20, 16), dtype=torch.int32)
    m = torch.zeros((2, 2), dtype=torch.int32)
    for top, bottom in ((1, 0), (4, 0), (0, 3), (-2, 0)):
        with pytest.raises(ValueError, match="halo rows"):
            tcdef.filter_plane(p, m, m, m, m, 16, 16, 8, 8, 5, 8, True,
                               False, top, bottom)
    with pytest.raises(ValueError, match="halo rows below"):
        tcdef.filter_plane(p, m[:1].contiguous(), m[:1].contiguous(), m, m,
                           8, 16, 8, 8, 5, 8, True, False, 2, 2)


_DIR_HARNESS = r"""
#include "cdef_dir_core.cuh"

extern "C" void cdef_dir_host(const int* plane, int H, int W, int bitdepth,
                              const int* bw, int* dir, int* var) {
    const int W8 = W / 8;
    for (int i = 0; i < (H / 8) * W8; i++)  // the kernel's thread i
        cdir::block(plane, W, bitdepth - 8, bw, i / W8, i % W8, dir + i,
                    var + i);
}
"""


@pytest.fixture(scope="module")
def dir_kernel_on_host(tmp_path_factory):
    """The direction kernel's arithmetic header built as host C++ (a
    ctypes function running every block as the kernel's threads do)."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no C++ compiler")
    d = tmp_path_factory.mktemp("cdef_dir_host")
    (d / "harness.cpp").write_text(_DIR_HARNESS)
    so = d / "libcdef_dir_host.so"
    r = subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                        "-I", str(CSRC), "-o", str(so),
                        str(d / "harness.cpp")],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.cdef_dir_host.argtypes = [P, I, I, I, P, P, P]
    lib.cdef_dir_host.restype = None
    return lib


def _dir_blocks(rng, H, W, bitdepth, content):
    """(H, W) int32 plane of 8x8 blocks of one kind of content."""
    hi = (1 << bitdepth) - 1
    nby, nbx = -(-H // 8), -(-W // 8)
    if content == "noise":
        return rng.integers(0, hi + 1, (H, W)).astype(np.int32)
    blocks = np.empty((nby, nbx, 8, 8), np.int64)
    yy, xx = np.mgrid[0:8, 0:8]
    for by in range(nby):
        for bx in range(nbx):
            k = int(rng.integers(0, 4))
            if content == "flat":
                lvl = (128 << (bitdepth - 8)) if k == 0 else \
                    int(rng.integers(0, hi + 1))
                b = np.full((8, 8), lvl)
            elif content == "extremes":
                b = [np.zeros((8, 8)), np.full((8, 8), hi),
                     ((yy + xx) % 2) * hi, (yy % 2) * hi][k]
            else:  # ties: transpose-symmetric blocks
                f = rng.integers(0, hi + 1, 8)
                g = rng.integers(0, hi + 1, 15)
                b = [(f[yy] + f[xx]) // 2, g[yy + xx], g[7 + yy - xx],
                     np.maximum(f[yy], f[xx])][k]
            blocks[by, bx] = b
    plane = blocks.transpose(0, 2, 1, 3).reshape(nby * 8, nbx * 8)
    return np.clip(plane[:H, :W], 0, hi).astype(np.int32)


@pytest.mark.parametrize("content", ["noise", "flat", "extremes", "ties"])
@pytest.mark.parametrize("bitdepth", [8, 10, 12])
def test_dir_kernel_source_on_host(dir_kernel_on_host, bitdepth, content):
    """cdef_dir_core.cuh's arithmetic equals the plain direction search
    exactly; planes of 96 blocks, 55 blocks (rows 90 wide, two columns
    past the 8x8 grid) and 15 blocks (rows and columns past it)."""
    rng = np.random.default_rng(bitdepth * 13 + len(content))
    bw = state.cdef_bin_weights().astype(np.int32)
    ties = 0
    for H, W in ((64, 96), (40, 90), (30, 44)):
        plane = _dir_blocks(rng, H, W, bitdepth, content)
        want_d, want_v = tcdef.find_dir_maps_plain(torch.from_numpy(plane),
                                                   bitdepth)
        d = np.full((H // 8, W // 8), -1, np.int32)
        v = np.full_like(d, -1)
        dir_kernel_on_host.cdef_dir_host(plane.ctypes.data, H, W, bitdepth,
                                         bw.ctypes.data, d.ctypes.data,
                                         v.ctypes.data)
        assert np.array_equal(d, want_d.numpy()), \
            f"dir mismatch at {np.argwhere(d != want_d.numpy())[:4]}"
        assert np.array_equal(v, want_v.numpy())
        if content in ("flat", "ties"):
            R8, W8 = H // 8, W // 8
            blk = torch.from_numpy(plane[:R8 * 8, :W8 * 8]).reshape(
                R8, 8, W8, 8).permute(0, 2, 1, 3).reshape(-1, 64).long()
            px = (blk >> (bitdepth - 8)) - 128
            tb = state.tables(torch.device("cpu"))
            cost = torch.stack([
                (torch.zeros((px.shape[0], 15), dtype=torch.int64)
                 .index_add_(1, tb.bin_index[k], px) ** 2
                 * tb.bin_weights[k].long()).sum(1) for k in range(8)], 1)
            best = cost.max(1).values[:, None]
            ties += int(((cost == best).sum(1) > 1).sum())
    if content in ("flat", "ties"):
        assert ties > 0  # the first maximum decided some blocks
