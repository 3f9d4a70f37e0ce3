"""dav1d_tpu_torch loop restoration (ops/lr.py) vs the JAX package,
bit-exact.

* the plain Wiener units vs dav1d_tpu/ops/lr._jit_wiener, and the plain
  self-guided units (variants 0/1/2, the sgr_params indices of
  tests/test_ops_device.py) vs ops/lr._jit_sgr, at bit depths 8/10/12
  with random pixels and with the extreme pixels {0, 1, 2^bd-2, 2^bd-1}
  that maximise the self-guided products (the plain version keeps the
  JAX package's int32 split multiply);
* the plain group functions (:func:`wiener_plain`, :func:`sgr_plain`:
  gather the padded units from the post-CDEF plane and the pre-CDEF
  snapshot, filter, write the rectangles) vs
  dav1d_tpu/recon/device_chain._jit_lr_group, on units of two
  geometries covering all 16 edge combinations;
* the output is a new tensor and neither input changes; an output that
  aliases an input is refused; the chain's earlier stages (deblock,
  CDEF, resize) also return new tensors, which is what lets the chain
  keep its pre-CDEF snapshot as references (recon/device_chain.py);
* the kernels' own arithmetic, ``csrc/lr_core.cuh`` built as host C++
  and run CTA by CTA, 256 threads in turn per phase (the Wiener kernel:
  a CTA per chunk table row, its row and column tables, then sub-band
  by sub-band the copies, the horizontal pass into the ring and the
  vertical pass out of it; the self-guided kernel: a CTA per row of its
  own chunk table, the copies, the column sums, the (A, B) rows and the
  filter), against the plain group functions on job
  tables with the stream's unit sizes (uw 128/192/256/384, stripe
  heights 28/32/56/64, several chunks a unit) and every edge
  combination, at 8/10/12-bit, the 12-bit self-guided case on extreme
  pixels, where its two products need int64; the Wiener kernel also
  with bands of 64, 32, 16, 13 and 5 rows and sub-bands of 16 and 32
  rows,
  on units narrower than a 16-byte copy (1-3 columns) or a chunk (37,
  65) and stripes of 4, 13 and 28 rows, on planes whose rows take the
  16-byte copies and on a plane whose rows do not; the self-guided
  kernel with bands of 16, 12, 8 and 4 rows and the wrapper's own
  (16) on the same units, all 16 edge combinations, variants 0/1/2,
  at 8/10/12-bit, the 12-bit case on extreme pixels; the header's
  x_by_x table against tables.sgr_x_by_x;
* both chunk tables (:func:`chunk_table`, ``sgr=True`` for the
  self-guided one, whose bands start on even unit rows) cover every
  output pixel once, and :func:`check_chunks` refuses malformed tables
  (also through the wrappers on CPU tensors), the self-guided one also
  a band that starts on an odd unit row or holds more than 16 rows.

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

from dav1d_tpu.ops.lr import _jit_sgr, _jit_wiener
from dav1d_tpu.recon.device_chain import _jit_lr_group
from dav1d_tpu_torch import tables
from dav1d_tpu_torch.ops import cdef as tcdef
from dav1d_tpu_torch.ops import lf as tlf
from dav1d_tpu_torch.ops import lr as tlr
from dav1d_tpu_torch.ops import resize as tresize
from dav1d_tpu_torch.recon.lr_apply import _pad_unit_indices

CSRC = Path(tlr.__file__).resolve().parent.parent / "csrc"

# (sgr_params index, variant): mix, 5x5 only, 3x3 only
SGR = [(0, 2), (14, 0), (10, 1)]


def _pixels(rng, shape, bitdepth, content):
    """random: uniform; smooth: a ramp with small noise (where the
    self-guided filter acts: on uniform noise its variance term zeroes
    it); extremes: 8x8 blocks of the pixels {0, 1, 2^bd-2, 2^bd-1}, half
    of them near-flat (0/1 or 2^bd-2/2^bd-1: box sums at their largest
    with x_by_x near 255, the largest A products) and half mixed (the
    largest variance terms p * s)."""
    hi = (1 << bitdepth) - 1
    if content == "random":
        return rng.integers(0, hi + 1, shape).astype(np.int32)
    *lead, H, W = shape
    if content == "smooth":
        yy, xx = np.mgrid[0:H, 0:W]
        ramp = ((xx * 3 + yy * 2) % (hi + 1 - 64)) + 32
        return np.clip(ramp + rng.integers(-6, 7, shape), 0,
                       hi).astype(np.int32)
    vals = np.array([0, 1, hi - 1, hi], np.int32)
    blocks = (*lead, -(-H // 8), -(-W // 8))
    mixed = rng.random(blocks) < 0.5
    base = rng.integers(0, 2, blocks) * 2
    up = lambda a: np.repeat(np.repeat(a, 8, -2), 8, -1)[..., :H, :W]
    pick = np.where(up(mixed), rng.integers(0, 4, shape),
                    up(base) + rng.integers(0, 2, shape))
    return vals[pick]


def _wiener_filters(rng, n):
    """Half filters in the bitstream's ranges (taps 0..2: [-5, 10],
    [-23, 8], [-17, 46])."""
    return np.stack([rng.integers(-5, 11, n), rng.integers(-23, 9, n),
                     rng.integers(-17, 47, n)], 1).astype(np.int32)


def _sgr_params(rng, n, sgr_idx):
    """(s0, s1, w0, w1) columns: strengths of sgr_params[sgr_idx], the
    coded weights in their ranges ([-96, 31], [-32, 95]), w1 derived."""
    s0, s1 = (int(v) for v in tables.sgr_params[sgr_idx])
    w0 = rng.integers(-96, 32, n)
    w1 = 128 - (w0 + rng.integers(-32, 96, n))
    return np.stack([np.full(n, s0), np.full(n, s1), w0, w1],
                    1).astype(np.int32)


# ---- unit filters --------------------------------------------------------

@pytest.mark.parametrize("content", ["random", "extremes"])
@pytest.mark.parametrize("bitdepth", [8, 10, 12])
@pytest.mark.parametrize("uw,sh", [(32, 16), (16, 7)])
def test_wiener_units_match_jax(uw, sh, bitdepth, content):
    rng = np.random.default_rng(uw + sh * 5 + bitdepth)
    B = 6
    P = _pixels(rng, (B, sh + 6, uw + 6), bitdepth, content)
    fh, fv = _wiener_filters(rng, B), _wiener_filters(rng, B)
    want = np.asarray(_jit_wiener(uw, sh, bitdepth)(
        jnp.asarray(P), jnp.asarray(fh), jnp.asarray(fv)))
    got = tlr.wiener_units_plain(torch.from_numpy(P), torch.from_numpy(fh),
                                 torch.from_numpy(fv), bitdepth)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("content", ["smooth", "extremes"])
@pytest.mark.parametrize("bitdepth", [8, 10, 12])
@pytest.mark.parametrize("sgr_idx,variant", SGR)
@pytest.mark.parametrize("uw,sh", [(32, 16), (24, 9)])
def test_sgr_units_match_jax(uw, sh, sgr_idx, variant, bitdepth, content):
    rng = np.random.default_rng(sgr_idx * 31 + bitdepth + uw + sh)
    B = 4
    P = _pixels(rng, (B, sh + 6, uw + 6), bitdepth, content)
    src = np.ascontiguousarray(P[:, 3:3 + sh, 3:3 + uw])
    prm = _sgr_params(rng, B, sgr_idx)
    want = np.asarray(_jit_sgr(uw, sh, bitdepth, variant)(
        jnp.asarray(P), jnp.asarray(src), *(jnp.asarray(c) for c in prm.T)))
    got = tlr.sgr_units_plain(torch.from_numpy(P), torch.from_numpy(src),
                              *torch.from_numpy(prm).T, bitdepth, variant)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# ---- group functions -----------------------------------------------------

def _grid(rng, units, W, margin=4):
    """Place ``units`` [(uw, sh, edges)] row by row in a plane W wide, a
    ``margin`` of pixels around each, so that every edge combination
    reads inside the plane; returns (job rows without parameters, H).
    Every second unit's plane height ``h`` ends just below its bottom
    context, where min(y + sh + 1, h - 1) clamps."""
    rows, x, y, row_h = [], margin, margin, 0
    for uw, sh, e in units:
        if x + uw + margin > W:
            x, y, row_h = margin, y + row_h + 2 * margin, 0
        rows.append([x, y, uw, sh, e])
        x += uw + 2 * margin
        row_h = max(row_h, sh)
    H = y + row_h + margin
    out = []
    for i, (x, y, uw, sh, e) in enumerate(rows):
        h = y + sh + 1 if i % 2 else H
        out.append([x, y, uw, sh, e, h])
    return np.asarray(out, np.int64), H


def _jobs(rng, geo, params):
    """Job table: geometry rows + parameter columns (padded to 6)."""
    p = np.zeros((len(geo), 6), np.int64)
    p[:, :params.shape[1]] = params
    return np.concatenate([geo, p], 1).astype(np.int32)


def _jax_groups(post, pre, jobs, bitdepth, sgr):
    """dav1d_tpu's _jit_lr_group, one call per (uw, sh[, variant]) group,
    each scattering into the previous result and gathering from the
    unchanged post / pre stack (as dav1d_tpu/recon/device_chain.py
    _lr_resident runs them)."""
    H, W = post.shape
    dst = jnp.asarray(post)
    snap = jnp.concatenate([jnp.asarray(post), jnp.asarray(pre)])
    cols = [tlr.J_UW, tlr.J_SH] + ([tlr.J_P + 4] if sgr else [])
    for key in sorted({tuple(r) for r in jobs[:, cols].tolist()}):
        g = jobs[(jobs[:, cols] == key).all(1)]
        uw, sh = key[:2]
        idx = [_pad_unit_indices(x, y, uw, sh, h, e, W, H)
               for x, y, e, h in g[:, [tlr.J_X, tlr.J_Y, tlr.J_EDGES,
                                       tlr.J_H]]]
        rows = jnp.asarray(np.stack([r for r, _ in idx]))
        cidx = jnp.asarray(np.stack([c for _, c in idx]))
        prm = g[:, tlr.J_P:]
        params = ([prm[:, :3], prm[:, 3:6]] if not sgr else
                  [prm[:, k] for k in range(4)])
        fn = _jit_lr_group("s" if sgr else "w", uw, sh, bitdepth,
                           key[2] if sgr else 0)
        dst = fn(dst, snap, rows, cidx, jnp.asarray(g[:, tlr.J_Y]),
                 jnp.asarray(g[:, tlr.J_X]),
                 *(jnp.asarray(np.ascontiguousarray(p)) for p in params))
    return np.asarray(dst)


@pytest.mark.parametrize("bitdepth", [8, 10, 12])
@pytest.mark.parametrize("kind", ["wiener", "sgr0", "sgr1", "sgr2"])
def test_group_matches_jax(kind, bitdepth):
    """Units of two geometries (16 x 8 and 24 x 5), each geometry in all
    16 edge combinations, through the plain group function and through
    _jit_lr_group: the same plane."""
    rng = np.random.default_rng(bitdepth * 3 + len(kind))
    units = [(uw, sh, e) for uw, sh in ((16, 8), (24, 5))
             for e in range(16)]
    geo, H = _grid(rng, units, W=160)
    W = 160
    post = _pixels(rng, (H, W), bitdepth, "smooth")
    pre = _pixels(rng, (H, W), bitdepth, "smooth")
    if kind == "wiener":
        jobs = _jobs(rng, geo, np.concatenate(
            [_wiener_filters(rng, len(geo)), _wiener_filters(rng, len(geo))],
            1))
        fn = tlr.wiener_plain
    else:
        variant = int(kind[-1])
        sgr_idx = next(i for i, v in SGR if v == variant)
        prm = _sgr_params(rng, len(geo), sgr_idx)
        jobs = _jobs(rng, geo, np.concatenate(
            [prm, np.full((len(geo), 1), variant)], 1))
        fn = tlr.sgr_plain
    want = _jax_groups(post, pre, jobs, bitdepth, kind != "wiener")
    got = fn(torch.from_numpy(post), torch.from_numpy(pre),
             torch.from_numpy(jobs), bitdepth)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != post).any()


def test_job_tables():
    """lr_apply geometry items -> job rows, per plane and kind; a unit
    beyond the kernels' 384 x 64 refused."""
    geom = {("w", 128, 56): [(0, 0, 0, 2, 1080, (1, 2, 3), (4, 5, 6)),
                             (1, 64, 0, 3, 540, (0, -1, 2), (0, 3, -4))],
            ("s", 256, 32, 2): [(0, 128, 56, 15, 1080, 140, 3236, -32,
                                 50)]}
    w, s = tlr.job_tables(geom, 0)
    assert w.tolist() == [[0, 0, 128, 56, 2, 1080, 1, 2, 3, 4, 5, 6]]
    assert s.tolist() == [[128, 56, 256, 32, 15, 1080, 140, 3236, -32, 50,
                           2, 0]]
    w, s = tlr.job_tables(geom, 1)
    assert w.tolist() == [[64, 0, 128, 56, 3, 540, 0, -1, 2, 0, 3, -4]]
    assert s.shape == (0, tlr.JOB_COLS) and s.dtype == np.int32
    assert [t.shape for t in tlr.job_tables(geom, 2)] == \
        [(0, tlr.JOB_COLS)] * 2
    with pytest.raises(ValueError, match="beyond"):
        tlr.job_tables({("w", 400, 64): []}, 0)


# ---- new tensors ---------------------------------------------------------

@pytest.mark.parametrize("fn", ["wiener", "sgr"])
def test_output_is_a_new_tensor(fn):
    """The wrapper writes a new plane (a clone of post, or the ``out`` it
    is given) and leaves post and the snapshot as they were; an ``out``
    that is post or pre is refused."""
    rng = np.random.default_rng(3)
    geo, H = _grid(rng, [(16, 8, e) for e in range(16)], W=120)
    post = torch.from_numpy(_pixels(rng, (H, 120), 10, "smooth"))
    pre = torch.from_numpy(_pixels(rng, (H, 120), 10, "smooth"))
    prm = (np.concatenate([_wiener_filters(rng, 16)] * 2, 1) if fn ==
           "wiener" else np.concatenate(
               [_sgr_params(rng, 16, 0), np.full((16, 1), 2)], 1))
    jobs = torch.from_numpy(_jobs(rng, geo, prm))
    before = post.clone(), pre.clone()
    wrap = getattr(tlr, fn)
    out = wrap(post, pre, jobs, 10)
    assert out.data_ptr() not in (post.data_ptr(), pre.data_ptr())
    assert torch.equal(post, before[0]) and torch.equal(pre, before[1])
    assert not torch.equal(out, post)
    given = torch.full_like(post, -1)
    assert wrap(post, pre, jobs, 10, out=given) is given
    inside = torch.zeros_like(post, dtype=torch.bool)
    for x, y, uw, sh in geo[:, :4].tolist():
        inside[y:y + sh, x:x + uw] = True
    assert torch.equal(given[inside], out[inside])
    assert (given[~inside] == -1).all()
    for alias in (post, pre):
        with pytest.raises(ValueError, match="aliases"):
            wrap(post, pre, jobs, 10, out=alias)


def test_chain_stages_write_new_planes():
    """Deblock, CDEF and resize return new tensors and leave their input
    as it was: the device chain keeps its pre-CDEF snapshot as references
    to the post-deblock planes (recon/device_chain.py) on that ground."""
    rng = np.random.default_rng(11)
    H, W = 32, 48
    plane = torch.from_numpy(rng.integers(0, 256, (H, W)).astype(np.int32))
    before = plane.clone()
    cells = torch.zeros(((H + 3) >> 2, (W + 3) >> 2), dtype=torch.int32)
    cells[:, 2] = 40 | (20 << 8) | (2 << 16) | (1 << 24)  # E, I, H, class
    pm = torch.full((H // 8, W // 8), 8, dtype=torch.int32)
    sm = torch.full_like(pm, 2)
    dmap, vmap = tcdef.find_dir_maps(plane, 8)
    outs = [tlf.deblock(plane, cells, True, 8, True),
            tcdef.filter_plane(plane, pm, sm, dmap, vmap, H, W, 8, 8, 4, 8,
                               True, False),
            tresize.resize_plane(plane, 64, W, 12288, 0, H, 128, 8)]
    for out in outs:
        assert out.data_ptr() != plane.data_ptr()
        assert torch.equal(plane, before)


# ---- the kernels' arithmetic on the host ---------------------------------

_HARNESS = r"""
#include <string.h>
#include "lr_core.cuh"

// The Wiener kernel (csrc/lr.cu lr_wiener_kernel) CTA by CTA, each phase
// between two barriers run by the 256 threads one after the other (the
// copies land at once here); counts[0] += bands staged by 16-byte copies,
// counts[1] += the others.
static void wiener(const lr::Planes& p, const int* chunks, int n_chunks,
                   int* counts) {
    static lr::WienerRing s;
    const int nt = lr::WIENER_THREADS;
    for (int ci = 0; ci < n_chunks; ci++) {
        lr::Band b;
        lr::load_band(b, chunks, ci, p, lr::WIENER_CW, false);
        counts[b.vec ? 0 : 1]++;
        memset(&s, 0x5A, sizeof s);  // shared memory starts undefined
        for (int t = 0; t < nt; t++) lr::wiener_setup(s, b, p, t);
        for (int t = 0; t < nt; t++) lr::wiener_issue(s, b, 0, t);
        for (int t = 0; t < nt; t++) lr::wiener_issue(s, b, 1, t);
        for (int g = 0; g < lr::sub_bands(b); g++) {
            for (int t = 0; t < nt; t++) lr::wiener_hpass(s, b, g, p.bd, t);
            for (int t = 0; t < nt; t++) lr::wiener_issue(s, b, g + 2, t);
            for (int t = 0; t < nt; t++) lr::wiener_vpass(s, b, g, p, t);
        }
    }
}

// The self-guided kernel (csrc/lr.cu lr_sgr_kernel) CTA by CTA, each
// phase between two barriers run by the 256 threads one after the other;
// counts as the Wiener kernel's.
static void sgr(const lr::Planes& p, const int* chunks, int n_chunks,
                int* counts) {
    static lr::SgrTile ss;
    const int nt = lr::SGR_THREADS;
    for (int ci = 0; ci < n_chunks; ci++) {
        lr::Band b;
        lr::load_band(b, chunks, ci, p, lr::SGR_CW, true);
        counts[b.vec ? 0 : 1]++;
        memset(&ss, 0x5A, sizeof ss);  // shared memory starts undefined
        for (int t = 0; t < nt; t++) lr::sgr_setup(ss, t);
        for (int t = 0; t < nt; t++) lr::sgr_issue(ss, b, p, t);
        for (int t = 0; t < nt; t++) lr::sgr_vsum(ss, b, t);
        for (int t = 0; t < nt; t++) lr::sgr_ab(ss, b, p.bd, t);
        for (int t = 0; t < nt; t++) lr::sgr_filter(ss, b, p, t);
    }
}

extern "C" void lr_host(const int* post, const int* pre, int* out, int H,
                        int W, const int* chunks, int n_chunks, int sgr_,
                        int bitdepth, int* counts) {
    const lr::Planes p{post, pre, out, H, W, bitdepth};
    if (sgr_)
        sgr(p, chunks, n_chunks, counts);
    else
        wiener(p, chunks, n_chunks, counts);
}

extern "C" int lr_sgr_tile_bytes() { return (int)sizeof(lr::SgrTile); }

extern "C" int lr_ring_bytes() { return (int)sizeof(lr::WienerRing); }

extern "C" const int* lr_x_by_x_host() { return lr::X_BY_X; }
"""


@pytest.fixture(scope="module")
def kernel_on_host(tmp_path_factory):
    """lr_core.cuh built as host C++ (ctypes)."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no C++ compiler")
    d = tmp_path_factory.mktemp("lr_host")
    (d / "harness.cpp").write_text(_HARNESS)
    so = d / "liblr_host.so"
    r = subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                        "-I", str(CSRC), "-o", str(so),
                        str(d / "harness.cpp")],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.lr_host.argtypes = [P, P, P, I, I, P, I, I, I, P]
    lib.lr_host.restype = None
    lib.lr_x_by_x_host.restype = ctypes.POINTER(ctypes.c_int)
    return lib


def test_kernel_x_by_x_table_on_host(kernel_on_host):
    got = np.ctypeslib.as_array(kernel_on_host.lr_x_by_x_host(), (256,))
    np.testing.assert_array_equal(got, tables.sgr_x_by_x)


# the stream's unit widths and stripe heights (uw 384 is the widest a
# unit of 256 gets at the frame's right edge), each in 4 of the 16 edge
# combinations, the 16 spread over the geometries
HOST_UNITS = [(uw, sh, (4 * i + k) % 16)
              for i, (uw, sh) in enumerate([(128, 56), (192, 28), (256, 32),
                                            (384, 64)])
              for k in range(4)] + [(80, 4, 3), (160, 8, 15), (37, 13, 9)]


@pytest.mark.parametrize("kind", ["wiener", "sgr0", "sgr1", "sgr2"])
@pytest.mark.parametrize("bitdepth,content", [(8, "smooth"),
                                              (10, "smooth"),
                                              (12, "extremes")])
def test_kernel_source_on_host(kernel_on_host, kind, bitdepth, content):
    """lr_core.cuh's phases equal the plain group functions, exactly."""
    rng = np.random.default_rng(bitdepth + len(kind) * 13)
    W = 1000
    geo, H = _grid(rng, HOST_UNITS, W)
    post = _pixels(rng, (H, W), bitdepth, content)
    pre = _pixels(rng, (H, W), bitdepth, content)
    n = len(geo)
    if kind == "wiener":
        prm = np.concatenate([_wiener_filters(rng, n),
                              _wiener_filters(rng, n)], 1)
    else:
        variant = int(kind[-1])
        sgr_idx = next(i for i, v in SGR if v == variant)
        prm = np.concatenate([_sgr_params(rng, n, sgr_idx),
                              np.full((n, 1), variant)], 1)
    jobs = _jobs(rng, geo, prm)
    plain = tlr.wiener_plain if kind == "wiener" else tlr.sgr_plain
    want = plain(torch.from_numpy(post), torch.from_numpy(pre),
                 torch.from_numpy(jobs), bitdepth).numpy()
    got = _on_host(kernel_on_host, post, pre, jobs, bitdepth,
                   kind != "wiener")[0]
    np.testing.assert_array_equal(got, want)
    assert (want != post).any()


def _on_host(lib, post, pre, jobs, bitdepth, sgr=False, band=0):
    """The host build over the job table's chunk table (Wiener or, with
    ``sgr``, self-guided) of ``band``-row bands (0: as the wrapper
    chooses them), into a copy of ``post``; returns (plane, [bands staged
    by 16-byte copies, other bands])."""
    H, W = post.shape
    chunks = tlr.chunk_table(jobs, band, sgr=sgr)
    tlr.check_chunks(jobs, chunks, sgr=sgr)
    counts = np.zeros(2, np.int32)
    got = post.copy()
    lib.lr_host(post.ctypes.data, pre.ctypes.data, got.ctypes.data, H, W,
                chunks.ctypes.data, len(chunks), int(sgr), bitdepth,
                counts.ctypes.data)
    return got, counts.tolist()


# units narrower than a 16-byte copy or a chunk, stripes that are not a
# multiple of a band, beside the stream's sizes; each in 4 of the 16
# edge combinations
NARROW_UNITS = [(uw, sh, (5 * i + k) % 16)
                for i, (uw, sh) in enumerate([(1, 13), (2, 4), (3, 28),
                                              (37, 13), (65, 28), (128, 4),
                                              (192, 64), (384, 13)])
                for k in range(0, 16, 4)]


@pytest.mark.parametrize("band", [64, 32, 16, 13, 7, 5, 1])
@pytest.mark.parametrize("bitdepth,content", [(8, "smooth"),
                                              (10, "random"),
                                              (12, "extremes")])
@pytest.mark.parametrize("W", [1000, 998])
def test_wiener_bands_on_host(kernel_on_host, W, bitdepth, content, band):
    """The Wiener kernel with bands of ``band`` rows (one to three
    sub-bands) equals the plain group function, exactly, on narrow units
    and short stripes.  W = 1000: the interior chunks take the 16-byte
    copies, the clamped ones the element copies; W = 998: rows not
    16-byte aligned, element copies only."""
    rng = np.random.default_rng(W + bitdepth + band * 3)
    geo, H = _grid(rng, NARROW_UNITS, W)
    post = _pixels(rng, (H, W), bitdepth, content)
    pre = _pixels(rng, (H, W), bitdepth, content)
    assert post.ctypes.data % 16 == 0 and pre.ctypes.data % 16 == 0
    n = len(geo)
    jobs = _jobs(rng, geo, np.concatenate([_wiener_filters(rng, n),
                                           _wiener_filters(rng, n)], 1))
    want = tlr.wiener_plain(torch.from_numpy(post), torch.from_numpy(pre),
                            torch.from_numpy(jobs), bitdepth).numpy()
    got, (vec, other) = _on_host(kernel_on_host, post, pre, jobs, bitdepth,
                                 band=band)
    np.testing.assert_array_equal(got, want)
    assert other > 0 and (vec > 0) == (W % 4 == 0)


@pytest.mark.parametrize("band", [16, 12, 8, 4, 0])
@pytest.mark.parametrize("variant", [0, 1, 2])
@pytest.mark.parametrize("bitdepth,content", [(8, "smooth"),
                                              (10, "random"),
                                              (12, "extremes")])
def test_sgr_bands_on_host(kernel_on_host, bitdepth, content, variant, band):
    """The self-guided kernel with bands of ``band`` rows (0: the
    wrapper's, 16 rows) equals the
    plain group function, exactly, on narrow units and short or odd
    stripes in all 16 edge combinations; on 16-byte aligned rows the
    interior chunks take the 16-byte copies, the clamped ones the element
    copies.  The 12-bit case on the extreme pixels, where z and A need
    int64."""
    W = 1000
    rng = np.random.default_rng(bitdepth * 7 + variant + band)
    geo, H = _grid(rng, NARROW_UNITS, W)
    post = _pixels(rng, (H, W), bitdepth, content)
    pre = _pixels(rng, (H, W), bitdepth, content)
    n = len(geo)
    sgr_idx = next(i for i, v in SGR if v == variant)
    jobs = _jobs(rng, geo, np.concatenate(
        [_sgr_params(rng, n, sgr_idx), np.full((n, 1), variant)], 1))
    want = tlr.sgr_plain(torch.from_numpy(post), torch.from_numpy(pre),
                         torch.from_numpy(jobs), bitdepth).numpy()
    got, (vec, other) = _on_host(kernel_on_host, post, pre, jobs, bitdepth,
                                 sgr=True, band=band)
    np.testing.assert_array_equal(got, want)
    assert vec > 0 and other > 0
    assert (want != post).any()


def test_sgr_tile_bytes_on_host(kernel_on_host):
    """The self-guided CTA's shared memory (csrc/lr.cu's note): 20,880
    bytes for a 16-row band, against the 46,544 of the whole-window
    tile it replaces."""
    assert kernel_on_host.lr_sgr_tile_bytes() == 20880


def test_wiener_ring_bytes_on_host(kernel_on_host):
    """The Wiener CTA's shared memory (csrc/lr.cu's note): 30,024 bytes
    with sub-bands of 32 rows, against the 37,520 of the stage-then-filter
    tile."""
    assert kernel_on_host.lr_ring_bytes() == 30024


def test_wiener_on_cuda_needs_chunks(monkeypatch):
    """On CUDA tensors the wrapper takes its chunk table from the caller
    (who checked it against the jobs) and refuses to run without one; the
    device test is stubbed so that this runs without a card."""
    jobs = torch.from_numpy(_chunk_jobs())
    post = torch.zeros((100, 400), dtype=torch.int32)
    monkeypatch.setattr(tlr.build, "on_cuda", lambda *ts: True)
    with pytest.raises(ValueError, match="chunk table"):
        tlr.wiener(post, post.clone(), jobs, 8)


def test_sgr_on_cuda_needs_chunks(monkeypatch):
    """The self-guided wrapper takes its chunk table as the Wiener one
    does, and refuses to run on CUDA tensors without one."""
    jobs = torch.from_numpy(_chunk_jobs())
    post = torch.zeros((100, 400), dtype=torch.int32)
    monkeypatch.setattr(tlr.build, "on_cuda", lambda *ts: True)
    with pytest.raises(ValueError, match="chunk table"):
        tlr.sgr(post, post.clone(), jobs, 8)


# ---- the chunk table -----------------------------------------------------

def _chunk_jobs():
    geo = np.array([[0, 0, 128, 64, 15, 100], [200, 0, 37, 13, 0, 100],
                    [0, 70, 384, 28, 3, 100]])
    return _jobs(None, geo, np.zeros((3, 6), np.int64))


def test_chunk_table_band_by_launch_size():
    """Band 0 takes 64-row bands while they give WIENER_MIN_CTAS CTAs,
    then 32, then 16: a small launch gets more, shorter CTAs."""
    one = _chunk_jobs()[:1]  # a 128 x 64 unit: 2 chunks
    for n, band in ((132, 64), (131, 32), (66, 32), (65, 16), (1, 16)):
        c = tlr.chunk_table(np.repeat(one, n, 0))
        assert c[:, tlr.C_NR].max() == band, (n, band)
        assert len(c) == n * 2 * (64 // band)


@pytest.mark.parametrize("band", [64, 32, 16, 13, 1])
def test_chunk_table(band):
    """One row per (unit, 64-column chunk, band), covering every output
    pixel of every unit once."""
    jobs = _chunk_jobs()
    c = tlr.chunk_table(jobs, band)
    tlr.check_chunks(jobs, c)
    assert c.dtype == np.int32 and c.shape[1] == tlr.CHUNK_COLS
    cover = np.zeros((3, 64, 384), np.int32)
    np.testing.assert_array_equal(c[:, tlr.C_ROW:], jobs[c[:, tlr.C_JOB]])
    for job, cx, r0, nr in c[:, :tlr.C_ROW].tolist():
        cw = min(64, jobs[job, tlr.J_UW] - cx)
        cover[job, r0:r0 + nr, cx:cx + cw] += 1
    for j, (uw, sh) in enumerate(jobs[:, [tlr.J_UW, tlr.J_SH]].tolist()):
        assert (cover[j, :sh, :uw] == 1).all()
        assert cover[j].sum() == uw * sh
    n_chunks = [2, 1, 6]
    assert len(c) == sum(k * -(-sh // band) for k, sh in
                         zip(n_chunks, jobs[:, tlr.J_SH]))
    assert tlr.chunk_table(jobs[:0], band).shape == (0, tlr.CHUNK_COLS)


def _broken(c, how):
    c = c.copy()
    if how == "job":
        c[0, tlr.C_JOB] = 3
    elif how == "negative job":
        c[0, tlr.C_JOB] = -1
    elif how == "column":
        c[0, tlr.C_X] = 32
    elif how == "past the unit":
        c[1, tlr.C_X] = 128
    elif how == "no rows":
        c[0, tlr.C_NR] = 0
    elif how == "past the stripe":
        c[0, tlr.C_NR] += 1
    elif how == "overlap":
        c[1, tlr.C_R0] -= 1
    elif how == "missing":
        c = c[1:]
    elif how == "twice":
        c = np.concatenate([c, c[:1]])
    elif how == "shape":
        c = c[:, :3]
    elif how == "job row":
        c[0, tlr.C_ROW + tlr.J_UW] += 64
    return c


@pytest.mark.parametrize("how", ["job", "negative job", "column",
                                 "past the unit", "no rows",
                                 "past the stripe", "overlap", "missing",
                                 "twice", "shape", "job row"])
def test_check_chunks_refuses(how):
    """check_chunks refuses a table the kernel would trap on or that
    misses or repeats pixels, and so does the wrapper on CPU tensors."""
    jobs = _chunk_jobs()
    bad = _broken(tlr.chunk_table(jobs, 16), how)
    with pytest.raises(ValueError, match="chunks"):
        tlr.check_chunks(jobs, bad)
    post = torch.zeros((100, 400), dtype=torch.int32)
    with pytest.raises(ValueError, match="chunks"):
        tlr.wiener(post, post.clone(), torch.from_numpy(jobs), 8,
                   chunks=torch.from_numpy(np.ascontiguousarray(bad)))


def test_sgr_chunk_table_band_by_launch_size():
    """Band 0 of the self-guided table is SGR_SB (16) rows at every
    launch size: the stream's 16-unit call (256 x 28 / 32 units) gets
    256 CTAs; a band longer than 16 rows is refused."""
    assert tlr.SGR_SB == 16
    one = _chunk_jobs()[:1]  # a 128 x 64 unit: 4 chunks of 32 columns
    for n in (33, 32, 17, 16, 9, 8, 1):
        c = tlr.chunk_table(np.repeat(one, n, 0), sgr=True)
        assert c[:, tlr.C_NR].max() == 16, n
        assert len(c) == n * 4 * 4
    stream = _jobs(None, np.array([[256 * (1 + i % 2), 28 + 32 * (i // 2),
                                    256, 32 if i > 1 else 28, 15, 540]
                                   for i in range(16)]),
                   np.zeros((16, 6), np.int64))
    c = tlr.chunk_table(stream, sgr=True)
    assert c[:, tlr.C_NR].max() == 16 and len(c) == 256
    for band in (18, 32, 64):
        with pytest.raises(ValueError, match="at most 16"):
            tlr.chunk_table(stream, band, sgr=True)


@pytest.mark.parametrize("band", [16, 12, 8, 4, 2])
def test_sgr_chunk_table(band):
    """One row per (unit, 32-column chunk, band), every band starting on
    an even unit row, covering every output pixel of every unit once; an
    odd band is refused."""
    jobs = _chunk_jobs()
    c = tlr.chunk_table(jobs, band, sgr=True)
    tlr.check_chunks(jobs, c, sgr=True)
    assert c.dtype == np.int32 and c.shape[1] == tlr.CHUNK_COLS
    assert not (c[:, tlr.C_R0] % 2).any()
    assert not (c[:, tlr.C_X] % tlr.SGR_CW).any()
    cover = np.zeros((3, 64, 384), np.int32)
    np.testing.assert_array_equal(c[:, tlr.C_ROW:], jobs[c[:, tlr.C_JOB]])
    for job, cx, r0, nr in c[:, :tlr.C_ROW].tolist():
        cw = min(tlr.SGR_CW, jobs[job, tlr.J_UW] - cx)
        cover[job, r0:r0 + nr, cx:cx + cw] += 1
    for j, (uw, sh) in enumerate(jobs[:, [tlr.J_UW, tlr.J_SH]].tolist()):
        assert (cover[j, :sh, :uw] == 1).all()
        assert cover[j].sum() == uw * sh
    n_chunks = [4, 2, 12]
    assert len(c) == sum(k * -(-sh // band) for k, sh in
                         zip(n_chunks, jobs[:, tlr.J_SH]))
    with pytest.raises(ValueError, match="even"):
        tlr.chunk_table(jobs, band + 1, sgr=True)


@pytest.mark.parametrize("how", ["odd start", "long band", "overlap",
                                 "missing", "twice", "job row", "job",
                                 "column", "past the stripe"])
def test_sgr_check_chunks_refuses(how):
    """check_chunks(sgr=True) refuses a band that starts on an odd unit
    row, a band of more than 16 rows, an overlap, a gap, a repeated band,
    a foreign job row, a job out of range, a column off the 32-column
    grid and a band past the stripe; and so does the self-guided wrapper
    on CPU tensors."""
    jobs = _chunk_jobs()
    c = tlr.chunk_table(jobs, 16, sgr=True)
    if how == "odd start":
        c[1, tlr.C_R0] += 1
        c[1, tlr.C_NR] -= 1
        c[0, tlr.C_NR] += 1
    elif how == "long band":  # bands 0 and 1 of a chunk as one
        c[0, tlr.C_NR] += c[1, tlr.C_NR]
        c = np.delete(c, 1, 0)
    elif how == "column":
        c[0, tlr.C_X] = 16
    else:
        c = _broken(c, how)
    with pytest.raises(ValueError, match="chunks"):
        tlr.check_chunks(jobs, c, sgr=True)
    post = torch.zeros((100, 400), dtype=torch.int32)
    with pytest.raises(ValueError, match="chunks"):
        tlr.sgr(post, post.clone(), torch.from_numpy(jobs), 8,
                chunks=torch.from_numpy(np.ascontiguousarray(c)))
