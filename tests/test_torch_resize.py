"""dav1d_tpu_torch super-res resample (ops/resize.py) vs the JAX package,
bit-exact.

* the plain version vs dav1d_tpu/ops/resize._program (the XLA program
  the JAX chain applies to its resident planes) on the geometries of
  tests/test_ops_resize.py and on the 1080p super-res geometry of the
  committed stream superres_lr_1080p_8bit.ivf (luma 960 -> 1920, chroma
  480 -> 960), at bit depths 8/10/12, with random and extreme pixels;
* the batched wrapper (:func:`resize_planes`, plain on the CPU) on a
  frame's three planes and its pre-CDEF snapshot's, in the geometry of
  decode/frame.superres_geometry for every super-res denominator 9-16
  at 1080p widths (rows cut to a few: the resample is per row) in 4:2:0,
  4:2:2 and 4:4:4, bit depths 8/10/12, random and extreme pixels, junk
  in the rows below h and the columns beyond src_w: plane by plane equal
  to :func:`resize_plane_plain` and to the JAX program;
* the wrapper on CPU tensors: the allocation-sized output, zero outside
  the resampled rectangle, a new tensor; bad geometry, mismatched lists,
  more than six planes and a step beyond 2^14 refused;
* the kernel's own arithmetic, ``csrc/resize_core.cuh`` built as host
  C++ and run CTA by CTA over each CTA's run of tiles, each phase (the
  tile's span, the staging of its source rows with their clamps and
  aligned start, the taps of a lane's 4 columns once a strip, the zero
  region) by the 256 threads in turn, over batches of up to six planes
  split among 1 to 528 CTAs, against the plain version: the 16-byte
  copies on
  aligned rows, the element copies at the clamped edges and on rows that
  are not 16-byte aligned, ragged last tiles; its filter table against
  tables.resize_filter.

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
from dav1d_tpu_torch.decode.frame import superres_geometry
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


# ---- the batched wrapper ---------------------------------------------------

LAYOUTS = {"420": (1, 1), "422": (1, 0), "444": (0, 0)}


def _frame(denom, layout, w1=1920, height=1080):
    """The attributes decode/frame.superres_geometry reads, for a frame
    w1 wide upscaled from a super-res denominator ``denom`` (9-16;
    obu.py: w0 = max((w1 * 8 + denom // 2) // denom, min(16, w1)))."""
    from types import SimpleNamespace

    w0 = max((w1 * 8 + (denom >> 1)) // denom, min(16, w1))
    ss_hor, ss_ver = LAYOUTS[layout]
    hdr = SimpleNamespace(width=(w0, w1), height=height)
    return SimpleNamespace(frame_hdr=hdr, ss_hor=ss_hor, ss_ver=ss_ver,
                           bw=((w0 + 7) >> 3) << 1)


def _batch(rng, denom, layout, bitdepth, rows=5, pad=3):
    """A frame's three planes (random pixels) and its snapshot's (extreme
    pixels) as ``rows``-row cuts, the plane ``pad`` rows taller and 8
    columns wider than its coded width (which is a multiple of 4), with
    junk (2^20) there; their geometries (frame/superres_geometry with
    h = rows)."""
    f = _frame(denom, layout)
    planes, geoms = [], []
    for content in ("random", "extremes"):
        for pl in range(3):
            out_w, src_w, step, mx0, _, alloc_w = superres_geometry(f, pl)
            plane = np.full((rows + pad, src_w + 8), 1 << 20, np.int32)
            plane[:rows, :src_w] = _rows(rng, rows, src_w, bitdepth, content)
            planes.append(plane)
            geoms.append((out_w, src_w, step, mx0, rows, alloc_w))
    return planes, geoms


@pytest.mark.parametrize("bitdepth", [8, 10, 12])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("denom", range(9, 17))
def test_planes_match_plain_and_jax(denom, layout, bitdepth):
    """resize_planes (plain, on CPU tensors) on a 1080p frame's three
    planes and its snapshot's: plane by plane resize_plane_plain, and the
    JAX program on the resampled rectangle, 0 elsewhere."""
    rng = np.random.default_rng(denom * 100 + bitdepth + len(layout))
    planes, geoms = _batch(rng, denom, layout, bitdepth)
    got = tresize.resize_planes([torch.from_numpy(p) for p in planes],
                                geoms, bitdepth)
    assert len(got) == 6
    for plane, g, out in zip(planes, geoms, got):
        out_w, src_w, step, mx0, h, alloc_w = g
        assert out.shape == (plane.shape[0], alloc_w)
        assert torch.equal(out, tresize.resize_plane_plain(
            torch.from_numpy(plane), *g, bitdepth))
        want = np.asarray(_program(out_w, src_w, step, mx0, bitdepth)(
            np.ascontiguousarray(plane[:h, :src_w])))
        np.testing.assert_array_equal(out[:h, :out_w].numpy(), want)
        assert not out[h:].any() and not out[:, out_w:].any()


@pytest.mark.parametrize("bad", ["lengths", "seven planes", "no planes",
                                 "src_w", "step", "geometry tuple",
                                 "bitdepth"])
def test_planes_wrapper_refuses(bad):
    """resize_planes refuses mismatched lists, more than six planes (or
    none), a geometry outside its plane, a step the kernel's staged rows
    cannot hold (beyond 2^14: not an upscale), a malformed geometry and a
    bit depth the codec does not have."""
    step, mx0 = _geometry(60, 120)
    planes = [torch.zeros((40, 72), dtype=torch.int32)] * 2
    g = (120, 68, step, mx0, 35, 128)
    geoms, bd = [g, g], 10
    if bad == "lengths":
        geoms = [g]
    elif bad == "seven planes":
        planes, geoms = [planes[0]] * 7, [g] * 7
    elif bad == "no planes":
        planes, geoms = [], []
    elif bad == "src_w":
        geoms = [g, (120, 73, step, mx0, 35, 128)]
    elif bad == "step":
        geoms = [g, (120, 68, (1 << 14) + 1, mx0, 35, 128)]
    elif bad == "geometry tuple":
        geoms = [g, g[:5]]
    else:
        bd = 9
    with pytest.raises(ValueError):
        tresize.resize_planes(planes, geoms, bd)


_HARNESS = r"""
#include "resize_core.cuh"

// The kernel's CTAs in turn (at most `ctas`), each its run of strip rows
// tile by tile, each
// phase run by the 256 threads one after the other (the copies land at
// once here), the taps once a strip as the kernel keeps them; counts[0]
// += tiles of planes whose rows take 16-byte copies, counts[1] += of
// planes whose rows do not,
// counts[2] += tiles with nothing to stage, counts[3] += strips whose
// taps a CTA computed.  Returns 0 on a batch the kernel refuses.
extern "C" int resize_host(const int* const* srcs, int* const* outs,
                           const int* geo, int n, int bitdepth, int ctas,
                           int* counts) {
    static rs::Batch b;
    static int raw[rs::TR * rs::SW], filt[rs::FILTER_WORDS];
    static rs::Taps taps[rs::THREADS];
    if (!rs::make_batch(b, srcs, outs, geo, n, bitdepth, ctas)) return 0;
    for (int tid = 0; tid < rs::THREADS; tid++) rs::load_filter(filt, tid);
    for (int c = 0; c < b.ctas; c++) {
        int u, u1;
        rs::run_of(b, c, &u, &u1);
        int strip = -1;
        while (u < u1) {
            rs::Tile T;
            rs::tile_of(b, u, u1, T);
            const rs::Plane& p = b.p[T.k];
            counts[T.rows == 0 ? 2 : (T.vec ? 0 : 1)]++;
            memset(raw, 0x5A, sizeof raw);  // shared memory starts undefined
            for (int tid = 0; tid < rs::THREADS; tid++)
                rs::stage(p, T, raw, tid);
            if (T.k * 65536 + T.tx != strip) {
                strip = T.k * 65536 + T.tx;
                counts[3]++;
                for (int tid = 0; tid < rs::THREADS; tid++)
                    rs::taps_of(p, T, filt, taps[tid], tid);
            }
            for (int tid = 0; tid < rs::THREADS; tid++)
                rs::compute(p, T, taps[tid], raw, b.maxp, tid);
            u += T.ny;
        }
    }
    return 1;
}

extern "C" int resize_tile_rows() { return rs::TR; }

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
    lib.resize_host.argtypes = [P, P, P, I, I, I, P]
    lib.resize_host.restype = I
    lib.resize_filter_host.restype = ctypes.POINTER(ctypes.c_int8)
    return lib


def _on_host(lib, planes, geoms, bitdepth, alloc=None, ctas=7):
    """The host build on numpy planes (geometries as resize_planes takes
    them) with at most ``ctas`` CTAs, into planes filled with -1 first
    (``alloc``: the output row strides, default each geometry's alloc_w);
    returns (outputs, [tiles of 16-byte aligned planes, of unaligned ones,
    tiles with nothing staged, strips whose taps a CTA computed])."""
    n = len(planes)
    alloc = alloc or [g[5] for g in geoms]
    outs = [np.full((p.shape[0], a), -1, np.int32)
            for p, a in zip(planes, alloc)]
    srcs = (ctypes.c_void_p * n)(*(p.ctypes.data for p in planes))
    dsts = (ctypes.c_void_p * n)(*(o.ctypes.data for o in outs))
    geo = (ctypes.c_int * (8 * n))(*(
        v for p, (out_w, src_w, step, mx0, h, _), a in zip(planes, geoms,
                                                          alloc)
        for v in (p.shape[1], src_w, h, out_w, p.shape[0], a, step, mx0)))
    counts = np.zeros(4, np.int32)
    assert lib.resize_host(srcs, dsts, geo, n, bitdepth, ctas,
                           counts.ctypes.data) == 1
    return outs, counts.tolist()


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
    """resize_core.cuh tile by tile over an allocation-sized plane (rows
    beyond h and columns beyond out_w written 0; a last tile of fewer
    rows) equals the plain version; junk in the source beyond src_w and
    h is never used."""
    src_w, in_w, out_w = case
    rng = np.random.default_rng(src_w + out_w * 3 + bitdepth)
    h = 19
    H, W = h + 3, src_w + 5
    alloc_w = (out_w + 127) & ~127
    plane = np.full((H, W), 1 << 20, np.int32)
    plane[:h, :src_w] = _rows(rng, h, src_w, bitdepth, content)
    step, mx0 = _geometry(in_w, out_w)
    g = (out_w, src_w, step, mx0, h, alloc_w)
    want = tresize.resize_plane_plain(torch.from_numpy(plane), *g,
                                      bitdepth).numpy()
    for ctas in (1, 3):
        (got,), _ = _on_host(kernel_on_host, [plane], [g], bitdepth,
                             ctas=ctas)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rows", [(5, 3), (21, 12), (40, 70)],
                         ids=lambda r: f"h{r[0]}+{r[1]}")
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("denom", [9, 12, 16])
def test_kernel_batch_on_host(kernel_on_host, denom, layout, rows):
    """A frame's three planes and its snapshot's in one batch of the host
    build, 1080p widths, ``rows`` = (h, junk rows below it), its strip
    rows dealt to 1, 5 and 528 CTAs: every plane equals the plain
    version.  The rows
    are 16-byte aligned, so the tiles take 16-byte copies but where a
    group of 4 columns needs the clamp (the first strip's span starts
    left of column 0, the last reaches past src_w); tiles wholly below h
    stage nothing."""
    rng = np.random.default_rng(denom * 7 + len(layout) + rows[0])
    planes, geoms = _batch(rng, denom, layout, 10, *rows)
    want = tresize.resize_planes_plain(
        [torch.from_numpy(p) for p in planes], geoms, 10)
    h, pad = rows
    n_strips = sum(-(-g[5] // 128) for g in geoms)
    for ctas in (1, 5, 528):
        got, (vec, elem, empty, strips) = _on_host(kernel_on_host, planes,
                                                   geoms, 10, ctas=ctas)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.numpy())
        assert vec > 0 and elem == 0
        # a tile is at most TR rows: a pad of 2 TR holds one wholly
        tr = kernel_on_host.resize_tile_rows()
        assert empty > 0 or pad < 2 * tr
        # one CTA walks every strip once; more CTAs split strips
        assert (strips == n_strips) if ctas == 1 else strips >= n_strips


@pytest.mark.parametrize("bitdepth", [8, 12])
def test_kernel_unaligned_and_ragged_on_host(kernel_on_host, bitdepth):
    """Rows that are not 16-byte aligned (an odd row stride) take the
    element copies in every tile; an output row stride that is not a
    multiple of the 128-column tile (nor of 4) ends in a ragged tile;
    denominators 9 and 13 (a phase for every lane of a warp)."""
    rng = np.random.default_rng(bitdepth)
    planes, geoms = [], []
    for denom in (9, 13):
        f = _frame(denom, "444", w1=700, height=23)
        out_w, src_w, step, mx0, h, alloc_w = superres_geometry(f, 0)
        plane = np.full((h + 2, src_w + 3), 1 << 20, np.int32)
        plane[:h, :src_w] = _rows(rng, h, src_w, bitdepth, "random")
        planes.append(plane)
        geoms.append((out_w, src_w, step, mx0, h, alloc_w))
    alloc = [geoms[0][0] + 5, geoms[1][0] + 130]
    want = [tresize.resize_plane_plain(torch.from_numpy(p),
                                       *g[:5], a, bitdepth).numpy()
            for p, g, a in zip(planes, geoms, alloc)]
    got, (vec, elem, _, _) = _on_host(kernel_on_host, planes, geoms,
                                      bitdepth, alloc)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert vec == 0 and elem > 0
