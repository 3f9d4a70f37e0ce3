"""dav1d_tpu_torch MC (ops/mc.py) vs the JAX package, bit-exact.

* the plain job-list put_8tap vs ops/mc._put_8tap_resident_prog (the
  XLA clamped-gather program): square blocks 4/8/16 at bit depths
  8/10/12 with subpel, identity and random signed filter rows; windows
  inside the plane, over every edge and farther out than the reference's
  MC_PAD border; allocation rows and columns beyond the coded size
  filled with junk (the reference runs on the cropped plane, so the port
  must clamp to the coded size, not the allocation);
* one job list mixing every block size the device-MC selection takes,
  luma and chroma planes and several references, against the reference
  program per (plane, size) group;
* the same plain version on the raw planes vs the reference's stacked
  Pallas tier: pallas_mc._gather_put_prog (interpret mode) on the
  pipeline._stack_prog stack, with the offsets moved by MC_PAD: the
  one-kernel form equals the TPU's interior tier;
* the kernel's tile list: every output pixel of every job covered
  exactly once, no tile outside its job or above the tile size;
* the kernel's own arithmetic, ``csrc/mc_core.cuh`` built as host C++
  and run tile by tile, one warp's 32 threads in turn per phase, on the
  mixed job list at bit depths 8/10/12 (128x128 jobs split into 32
  tiles, 4x4 chroma jobs one tile each), against the plain version.

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

import jax.numpy as jnp

from dav1d_tpu.ops.mc import _put_8tap_resident_prog
from dav1d_tpu.ops.pallas_mc import BB, _gather_put_prog
from dav1d_tpu.pipeline import MC_PAD, _slot_rows, _stack_prog
from dav1d_tpu_torch import devrt, tables
from dav1d_tpu_torch.ops import mc as tmc

CSRC = Path(tmc.__file__).resolve().parent.parent / "csrc"


def _filters(rng, n, w):
    """(n, 8) int32 rows: subpel rows of every set (4-tap sets for 4-px
    sides), identity rows and random signed taps."""
    subf = tables.mc_subpel_filters.astype(np.int32)
    kind = rng.integers(0, 3, n)
    sets = rng.integers(0, 3, n)
    sets = np.where(np.broadcast_to(w, n) > 4, sets, 3 + (sets & 1))
    rows = subf[sets, rng.integers(0, 15, n)]
    rows[kind == 1] = 0
    rows[kind == 1, 3] = 64
    rand = rng.integers(-64, 128, (n, 8)).astype(np.int32)
    rows[kind == 2] = rand[kind == 2]
    return rows.astype(np.int32)


def _origins(rng, n, vh, vw, w, h):
    """Block origins inside the plane, over every edge, and farther out
    than MC_PAD."""
    lo_y, hi_y = -h - 3 * MC_PAD, vh + 3 * MC_PAD
    lo_x, hi_x = -w - 3 * MC_PAD, vw + 3 * MC_PAD
    dy = rng.integers(lo_y, hi_y, n)
    dx = rng.integers(lo_x, hi_x, n)
    q = n // 4
    dy[:q] = rng.integers(0, max(1, vh - h), q)     # inside
    dx[:q] = rng.integers(0, max(1, vw - w), q)
    dy[q:2 * q] = rng.integers(-h - 4, 4, q)        # top edge
    dx[2 * q:3 * q] = rng.integers(vw - w - 4, vw + 4, q)  # right edge
    return dy.astype(np.int32), dx.astype(np.int32)


def _junk_plane(rng, vh, vw, PH, PW, bitdepth):
    plane = rng.integers(0, 1 << bitdepth, (PH, PW)).astype(np.int32)
    plane[vh:, :] = rng.integers(-(1 << 20), 1 << 20, (PH - vh, PW))
    plane[:, vw:] = rng.integers(-(1 << 20), 1 << 20, (PH, PW - vw))
    return plane


def _ref(plane, vh, vw, dy, dx, fh, fv, w, h, bitdepth):
    return np.asarray(_put_8tap_resident_prog(
        jnp.asarray(plane[:vh, :vw]), jnp.asarray(dy), jnp.asarray(dx),
        jnp.asarray(fh), jnp.asarray(fv), np.int32(vw), np.int32(vh),
        w=w, h=h, bitdepth=bitdepth)).astype(np.int64)


def _layout(w, h, stride=None):
    """Output offsets of (N,) blocks ``w`` x ``h`` written at a stride
    (default: their width), back to back with a gap row between blocks
    that no job writes: (offsets, strides, output size)."""
    stride = w if stride is None else np.broadcast_to(stride, len(w))
    size = (h + 1) * stride
    return np.cumsum(size) - size, stride, int(size.sum())


def _port(planes, coded, entry, dy, dx, w, h, fh, fv, bitdepth,
          stride=None):
    """The plain job-list version on CPU tensors, the blocks laid out by
    :func:`_layout`.  Returns the (N, h, w) block of each job when w and
    h are scalars, else (output, offsets, stride)."""
    n = len(dy)
    wv = np.broadcast_to(w, n).astype(np.int64)
    hv = np.broadcast_to(h, n).astype(np.int64)
    off, stride, n_out = _layout(wv, hv, stride)
    jobs, tiles, n_pix = tmc.job_table(entry, dy, dx, wv, hv, off, stride,
                                       fh, fv, n_out)
    assert n_pix == int((wv * hv).sum())
    before = dict(devrt.LAUNCHES)
    out = tmc.put_8tap_resident(
        [torch.from_numpy(p) for p in planes], coded,
        torch.from_numpy(jobs), torch.from_numpy(tiles), n_pix, n_out,
        bitdepth)
    assert dict(devrt.LAUNCHES) == before  # CPU tensors launch nothing
    assert out.dtype == (torch.uint8 if bitdepth == 8 else torch.int16)
    out = out.numpy().astype(np.int64)
    # the pixels no job writes stay 0
    written = np.zeros(out.size, dtype=bool)
    for o, s, ww, hh in zip(off, stride, wv, hv):
        written[(o + s * np.arange(hh)[:, None] + np.arange(ww)).ravel()] = \
            True
    assert not out[~written].any()
    if np.ndim(w) == 0 and np.ndim(h) == 0:
        idx = off[:, None, None] + stride[:, None, None] * \
            np.arange(h)[:, None] + np.arange(w)
        return out[idx]
    return out, off, stride


@pytest.mark.parametrize("bitdepth", [8, 10, 12])
@pytest.mark.parametrize("wh", [4, 8, 16])
def test_plain_matches_resident_prog(wh, bitdepth):
    w = h = wh
    rng = np.random.default_rng(wh * 10 + bitdepth)
    vh, vw, PH, PW = 72, 136, 80, 160  # coded size inside the allocation
    plane = _junk_plane(rng, vh, vw, PH, PW, bitdepth)
    n = 96
    dy, dx = _origins(rng, n, vh, vw, w, h)
    fh, fv = _filters(rng, n, w), _filters(rng, n, h)
    want = _ref(plane, vh, vw, dy, dx, fh, fv, w, h, bitdepth)
    got = _port([plane], [(vh, vw)], np.zeros(n, np.int32), dy, dx, w, h,
                fh, fv, bitdepth, stride=w + 5)
    np.testing.assert_array_equal(got, want)


def _mixed_frame(rng, bitdepth):
    """Two references x (luma, two 4:2:0 chroma planes) with junk beyond
    the coded size, and 8 jobs per plane for every block size the
    selection can produce (luma sides 8..128, chroma 4..64), windows
    inside, over every edge and beyond the border, in no particular
    order: (planes, coded, entry, dy, dx, w, h, fh, fv)."""
    bdim = tables.block_dimensions[:22]
    sel = (bdim[:, 0] > 1) & (bdim[:, 1] > 1)  # 4:2:0: not sub-8x8
    coded, planes, ent_pl = [], [], []
    for _ in range(2):
        for pl in range(3):
            vh, vw = (100, 180) if pl == 0 else (50, 90)
            PH, PW = (128, 192) if pl == 0 else (64, 96)
            planes.append(_junk_plane(rng, vh, vw, PH, PW, bitdepth))
            coded.append((vh, vw))
            ent_pl.append(pl)
    jobs = []
    for bw4, bh4 in bdim[sel, :2]:
        for e, pl in enumerate(ent_pl):
            w = int(bw4) * (4 >> (pl > 0))
            h = int(bh4) * (4 >> (pl > 0))
            vh, vw = coded[e]
            dy, dx = _origins(rng, 8, vh, vw, w, h)
            for i in range(8):
                jobs.append((e, int(dy[i]), int(dx[i]), w, h))
    jobs = [jobs[i] for i in rng.permutation(len(jobs))]
    e, dy, dx, w, h = (np.array(c, dtype=np.int32) for c in zip(*jobs))
    fh, fv = _filters(rng, len(jobs), w), _filters(rng, len(jobs), h)
    return planes, coded, e, dy, dx, w, h, fh, fv


def test_plain_mixed_frame_job_list():
    """One call, as the decoder makes it: :func:`_mixed_frame`."""
    rng = np.random.default_rng(7)
    bitdepth = 10
    planes, coded, e, dy, dx, w, h, fh, fv = _mixed_frame(rng, bitdepth)
    got, off, stride = _port(planes, coded, e, dy, dx, w, h, fh, fv,
                             bitdepth)
    for k in {(int(a), int(b), int(c)) for a, b, c in zip(e, w, h)}:
        g = np.flatnonzero((e == k[0]) & (w == k[1]) & (h == k[2]))
        ww, hh = k[1], k[2]
        vh, vw = coded[k[0]]
        want = _ref(planes[k[0]], vh, vw, dy[g], dx[g], fh[g], fv[g], ww,
                    hh, bitdepth)
        seg = got[off[g][:, None, None] + stride[g][:, None, None]
                  * np.arange(hh)[:, None] + np.arange(ww)]
        np.testing.assert_array_equal(seg, want)


@pytest.mark.parametrize("wh,bitdepth", [(4, 8), (8, 10), (16, 12)])
def test_plain_matches_stacked_pallas_tier(wh, bitdepth):
    w = h = wh
    rng = np.random.default_rng(wh + bitdepth)
    vh, vw, PH, PW = 40, 72, 48, 96
    planes = [_junk_plane(rng, vh, vw, PH, PW, bitdepth) for _ in range(2)]
    stack = _stack_prog(2, PH, PW, vh, vw)(*map(jnp.asarray, planes))
    n = 2 * BB
    slot = np.repeat(np.arange(2, dtype=np.int32), BB)
    # the Pallas tier's contract: windows within the MC_PAD border
    dy = rng.integers(3 - MC_PAD, vh + MC_PAD - h - 4 + 1, n)
    dx = rng.integers(3 - MC_PAD, vw + MC_PAD - w - 4 + 1, n)
    dy, dx = dy.astype(np.int32), dx.astype(np.int32)
    fh, fv = _filters(rng, n, w), _filters(rng, n, h)
    want = np.asarray(_gather_put_prog(
        stack, jnp.asarray(dy + MC_PAD + slot * _slot_rows(vh)),
        jnp.asarray(dx + MC_PAD), jnp.asarray(fh), jnp.asarray(fv),
        w=w, h=h, bitdepth=bitdepth, interpret=True)).astype(np.int64)
    got = _port(planes, [(vh, vw)] * 2, slot, dy, dx, w, h, fh, fv,
                bitdepth)
    np.testing.assert_array_equal(got, want)


def test_wrapper_checks_inputs():
    plane = torch.zeros((16, 16), dtype=torch.int32)
    jobs = torch.zeros((1, tmc.JOB_COLS), dtype=torch.int32)
    tiles = torch.zeros((1, tmc.TILE_COLS), dtype=torch.int32)
    with pytest.raises(ValueError, match="coded size"):
        tmc.put_8tap_resident([plane], [(17, 16)], jobs, tiles, 16, 16, 8)
    with pytest.raises(TypeError, match="dtype"):
        tmc.put_8tap_resident([plane.to(torch.int16)], [(16, 16)], jobs,
                              tiles, 16, 16, 8)
    with pytest.raises(ValueError, match="bitdepth"):
        tmc.put_8tap_resident([plane], [(16, 16)], jobs, tiles, 16, 16, 9)
    with pytest.raises(ValueError, match="tiles"):
        tmc.put_8tap_resident([plane], [(16, 16)], jobs, tiles[:, :4],
                              16, 16, 8)
    rows = np.zeros((1, 8), np.int32)
    with pytest.raises(ValueError, match="outside the output"):
        # a 4x4 block at stride 4 from offset 4 needs 20 output pixels
        tmc.job_table([0], [0], [0], 4, 4, [4], 4, rows, rows, 19)
    with pytest.raises(ValueError, match="multiples of 4"):
        tmc.job_table([0], [0], [0], 6, 4, [0], 8, rows, rows, 64)
    with pytest.raises(ValueError, match="multiples of 4"):
        tmc.job_table([0], [0], [0], 4, 2, [0], 4, rows, rows, 64)


def test_tile_list_covers_every_pixel_once():
    """Every output pixel of every job in exactly one tile, no tile
    outside its job or above TILE_H x TILE_W."""
    rng = np.random.default_rng(11)
    bdim = tables.block_dimensions[:22]
    w = np.concatenate([bdim[:, 0] * 4, bdim[:, 0] * 2,
                        rng.integers(1, 41, 200) * 4])
    h = np.concatenate([bdim[:, 1] * 4, bdim[:, 1] * 2,
                        rng.integers(1, 41, 200) * 4])
    tiles = tmc.tile_list(w, h)
    job, ty, tx, th, tw = tiles.T.astype(np.int64)
    assert tiles.dtype == np.int32 and tiles.shape[1] == tmc.TILE_COLS
    assert (th >= 1).all() and (tw >= 1).all()
    assert (th <= tmc.TILE_H).all() and (tw <= tmc.TILE_W).all()
    assert (ty >= 0).all() and (tx >= 0).all()
    assert (ty + th <= h[job]).all() and (tx + tw <= w[job]).all()
    off = np.cumsum(w * h) - w * h
    hits = np.zeros(int((w * h).sum()), dtype=np.int64)
    for j, y, x, hh, ww in zip(job, ty, tx, th, tw):
        np.add.at(hits, (off[j] + (y + np.arange(hh))[:, None] * w[j]
                         + x + np.arange(ww)).ravel(), 1)
    assert (hits == 1).all()
    # a 128x128 block is 32 tiles, a 4x4 block one
    assert len(tmc.tile_list([128], [128])) == 32
    assert len(tmc.tile_list([4], [4])) == 1
    assert tmc.tile_list([], []).shape == (0, tmc.TILE_COLS)


_HARNESS = r"""
#include <stdint.h>
#include "mc_core.cuh"

template <typename T>
static void run(const long long* table, const int* jobs, const int* tiles,
                int n_tiles, T* out, int ib, int maxp) {
    static mc::Tile s;
    const int nt = 32;  // the kernel's warp; each loop is one phase
    for (int t = 0; t < n_tiles; t++) {
        const int* tl = tiles + t * mc::TILE_COLS;
        const int ty = tl[mc::T_Y], tx = tl[mc::T_X];
        const int th = tl[mc::T_H], tw = tl[mc::T_W];
        for (int i = 0; i < nt; i++)
            mc::load_job(s, jobs + tl[mc::T_JOB] * mc::JOB_COLS, i, nt);
        const long long* tb = table + 4 * s.job[mc::J_ENTRY];
        const mc::Ref ref{(const int*)(intptr_t)tb[0], tb[1], (int)tb[2],
                          (int)tb[3]};
        for (int i = 0; i < nt; i++) mc::stage(s, ref, ty, tx, th, tw, i, nt);
        for (int i = 0; i < nt; i++) mc::hpass(s, th, tw, ib, i, nt);
        for (int i = 0; i < nt; i++)
            mc::vpass<T>(s, out, ty, tx, th, tw, ib, maxp, i, nt);
    }
}

extern "C" void mc_host(const long long* table, const int* jobs,
                        const int* tiles, int n_tiles, void* out,
                        int bitdepth) {
    const int ib = bitdepth == 8 ? 4 : 14 - bitdepth;
    const int maxp = (1 << bitdepth) - 1;
    if (bitdepth == 8)
        run<uint8_t>(table, jobs, tiles, n_tiles, (uint8_t*)out, ib, maxp);
    else
        run<int16_t>(table, jobs, tiles, n_tiles, (int16_t*)out, ib, maxp);
}
"""


@pytest.fixture(scope="module")
def kernel_on_host(tmp_path_factory):
    """The kernel's arithmetic header built as host C++ (a ctypes
    function running every tile's phases for 32 threads in turn)."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no C++ compiler")
    d = tmp_path_factory.mktemp("mc_host")
    (d / "harness.cpp").write_text(_HARNESS)
    so = d / "libmc_host.so"
    r = subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                        "-I", str(CSRC), "-o", str(so),
                        str(d / "harness.cpp")],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lib = ctypes.CDLL(str(so))
    lib.mc_host.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int,
                                                    ctypes.c_void_p,
                                                    ctypes.c_int]
    lib.mc_host.restype = None
    return lib


@pytest.mark.parametrize("bitdepth", [8, 10, 12])
def test_kernel_source_on_host(kernel_on_host, bitdepth):
    """mc_core.cuh's phases on the mixed job list (split 128x128 jobs,
    one-tile 4x4 jobs, windows beyond every edge, junk past the coded
    size) equal the plain version exactly."""
    rng = np.random.default_rng(400 + bitdepth)
    planes, coded, e, dy, dx, w, h, fh, fv = _mixed_frame(rng, bitdepth)
    wv, hv = w.astype(np.int64), h.astype(np.int64)
    off, stride, n_out = _layout(wv, hv, wv + 3)
    jobs, tiles, n_pix = tmc.job_table(e, dy, dx, wv, hv, off, stride, fh,
                                       fv, n_out)
    assert (tiles[:, tmc.T_H] * tiles[:, tmc.T_W] == 16).any()
    assert (np.bincount(tiles[:, tmc.T_JOB]) == 32).any()
    table = np.array([(p.ctypes.data, p.shape[1], vh, vw)
                      for p, (vh, vw) in zip(planes, coded)], np.int64)
    got = np.zeros(n_out, np.uint8 if bitdepth == 8 else np.int16)
    kernel_on_host.mc_host(table.ctypes.data, jobs.ctypes.data,
                           tiles.ctypes.data, len(tiles), got.ctypes.data,
                           bitdepth)
    want = tmc.put_8tap_resident_plain(
        [torch.from_numpy(p) for p in planes], coded,
        torch.from_numpy(jobs), torch.from_numpy(tiles), n_pix, n_out,
        bitdepth).numpy()
    assert np.array_equal(got, want), \
        f"mismatch at {np.flatnonzero(got != want)[:4]}"
