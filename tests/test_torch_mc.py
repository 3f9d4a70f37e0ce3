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
* compound jobs (CT_AVG and CT_WEIGHTED_AVG) of the plain version vs
  the reference's ops/mc.prep_8tap of each reference followed by
  ops/mc.avg / w_avg, at bit depths 8/10/12, windows inside and over
  each of the four edges, both references in one call;
* the kernel's own arithmetic, ``csrc/mc_core.cuh`` built as host C++
  and run tile by tile, one warp's 32 threads in turn per phase, on the
  mixed job list at bit depths 8/10/12 (128x128 jobs split into 32
  tiles, 4x4 chroma jobs one tile each), alone and with a third of its
  jobs made compound, against the plain version.

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

from dav1d_tpu.ops.mc import _put_8tap_resident_prog, avg, prep_8tap, w_avg
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


def _edge_origins(rng, n, vh, vw, w, h):
    """Block origins: a fifth inside the plane, a fifth over each of the
    four edges (reads clamped there)."""
    dy = rng.integers(0, vh - h, n)
    dx = rng.integers(0, vw - w, n)
    q = n // 5
    dy[q:2 * q] = rng.integers(-h - 6, 3, q)           # top
    dy[2 * q:3 * q] = rng.integers(vh - h - 3, vh + 6, q)  # bottom
    dx[3 * q:4 * q] = rng.integers(-w - 6, 3, q)       # left
    dx[4 * q:] = rng.integers(vw - w - 3, vw + 6, n - 4 * q)  # right
    return dy.astype(np.int32), dx.astype(np.int32)


def _prep_ref(plane, vh, vw, dy, dx, fh, fv, w, h, bitdepth):
    """The reference's prep_8tap over clamped windows."""
    ys = np.clip(dy[:, None] + np.arange(-3, h + 4), 0, vh - 1)
    xs = np.clip(dx[:, None] + np.arange(-3, w + 4), 0, vw - 1)
    src = plane[ys[:, :, None], xs[:, None, :]]
    return prep_8tap(jnp.asarray(src), jnp.asarray(fh), jnp.asarray(fv),
                     w=w, h=h, bitdepth=bitdepth)


def _compound_cols(rng, n, e1, dy1, dx1, w, h, every=1):
    """Second-reference columns for job_table: every ``every``-th job
    compound (CT_AVG or CT_WEIGHTED_AVG, jnt weights of the codec's
    table and the ends of 0..16), the rest single-reference."""
    comp = np.where(rng.integers(0, 2, n) == 0, tmc.CT_AVG,
                    tmc.CT_WEIGHTED_AVG).astype(np.int32)
    comp[np.arange(n) % every != 0] = tmc.CT_NONE
    jw = rng.choice([0, 2, 3, 4, 5, 7, 9, 11, 12, 13, 14, 16], n)
    return (e1, dy1, dx1, _filters(rng, n, w), _filters(rng, n, h), comp,
            jw.astype(np.int32))


@pytest.mark.parametrize("ct", ["avg", "w_avg"])
@pytest.mark.parametrize("bitdepth", [8, 10, 12])
def test_plain_compound_matches_prep_and_blend(bitdepth, ct):
    """Compound jobs of several sizes from two references equal the
    reference's prep_8tap of each followed by avg / w_avg."""
    rng = np.random.default_rng(900 + bitdepth * 2 + (ct == "avg"))
    vh, vw, PH, PW = 60, 100, 64, 112
    planes = [_junk_plane(rng, vh, vw, PH, PW, bitdepth) for _ in range(2)]
    code = tmc.CT_AVG if ct == "avg" else tmc.CT_WEIGHTED_AVG
    for w, h in ((4, 4), (8, 16), (32, 8)):
        n = 40
        dy0, dx0 = _edge_origins(rng, n, vh, vw, w, h)
        dy1, dx1 = _edge_origins(rng, n, vh, vw, w, h)
        dy1, dx1 = dy1[rng.permutation(n)], dx1[rng.permutation(n)]
        fh0, fv0, fh1, fv1 = (_filters(rng, n, s) for s in (w, h, w, h))
        jw = rng.choice([2, 3, 4, 5, 7, 9, 11, 12, 13, 14], n)
        off, stride, n_out = _layout(np.full(n, w), np.full(n, h))
        jobs, tiles, n_pix = tmc.job_table(
            np.zeros(n, np.int32), dy0, dx0, w, h, off, stride, fh0, fv0,
            n_out, compound=(np.ones(n, np.int32), dy1, dx1, fh1, fv1,
                             code, jw))
        got = tmc.put_8tap_resident(
            [torch.from_numpy(p) for p in planes], [(vh, vw)] * 2,
            torch.from_numpy(jobs), torch.from_numpy(tiles), n_pix, n_out,
            bitdepth).numpy().astype(np.int64)
        t1 = _prep_ref(planes[0], vh, vw, dy0, dx0, fh0, fv0, w, h,
                       bitdepth)
        t2 = _prep_ref(planes[1], vh, vw, dy1, dx1, fh1, fv1, w, h,
                       bitdepth)
        want = np.asarray(
            avg(t1, t2, bitdepth=bitdepth) if ct == "avg" else
            w_avg(t1, t2, jnp.asarray(jw[:, None, None]),
                  bitdepth=bitdepth)).astype(np.int64)
        idx = off[:, None, None] + stride[:, None, None] * \
            np.arange(h)[:, None] + np.arange(w)
        np.testing.assert_array_equal(got[idx], want, err_msg=f"{w}x{h}")


def test_job_table_checks_compound():
    rows = np.zeros((1, 8), np.int32)
    for comp, jw in ((3, 8), (4, 8), (1, 17), (2, -1)):
        with pytest.raises(ValueError, match="compound"):
            tmc.job_table([0], [0], [0], 4, 4, [0], 4, rows, rows, 16,
                          compound=([0], [0], [0], rows, rows, comp, jw))
    jobs, _, _ = tmc.job_table([0], [1], [2], 4, 4, [0], 4, rows, rows, 16)
    assert jobs.shape == (1, tmc.JOB_COLS)
    assert not jobs[:, tmc.J_ENTRY1:].any()  # single: CT_NONE, no ref 1
    jobs, _, _ = tmc.job_table([0], [1], [2], 4, 4, [0], 4, rows, rows, 16,
                               compound=([3], [5], [6], rows + 1, rows + 2,
                                         tmc.CT_WEIGHTED_AVG, 11))
    j = jobs[0]
    assert (j[tmc.J_ENTRY1], j[tmc.J_DY1], j[tmc.J_DX1]) == (3, 5, 6)
    assert (j[tmc.J_FH1:tmc.J_FH1 + 8] == 1).all()
    assert (j[tmc.J_FV1:tmc.J_FV1 + 8] == 2).all()
    assert (j[tmc.J_COMP], j[tmc.J_JW]) == (tmc.CT_WEIGHTED_AVG, 11)
    assert (j[tmc.J_ENTRY], j[tmc.J_DY], j[tmc.J_DX]) == (0, 1, 2)


def test_mc_select_takes_average_compound_only():
    """pipeline.mc_select takes plain single-reference blocks and
    CT_AVG / CT_WEIGHTED_AVG compound blocks, and leaves to the host
    CT_SEG, CT_WEDGE, compound with a global-motion warp on either
    reference, OBMC, local warp, interintra, scaled references, the
    switchable filter2d values above 8 and sub-8x8 chroma."""
    import types

    from dav1d_tpu_torch.native.decode_glue import CAP_BLOCK_DT
    from dav1d_tpu_torch.pipeline import mc_select

    def hdr(w, h):
        return types.SimpleNamespace(width=[w, w], height=h)

    slot = types.SimpleNamespace(planes=[None], frame_hdr=hdr(64, 64))
    scaled = types.SimpleNamespace(planes=[None], frame_hdr=hdr(32, 32))
    # refs 0-2 unscaled, 3 scaled, 4 unscaled with a global-motion warp
    f = types.SimpleNamespace(
        frame_hdr=hdr(64, 64), refp=[slot, slot, slot, scaled, slot, None,
                                     None],
        gmv_warp_allowed=[0, 0, 0, 0, 1, 0, 0], ss_hor=1, ss_ver=1)
    cases = {  # name: (fields, taken)
        "single": ({}, True),
        "avg": ({"comp_type": 2, "pad1": 2}, True),
        "weighted avg": ({"comp_type": 1, "pad1": 3}, True),
        "avg, global mv unwarped": ({"comp_type": 2, "pad1": 2,
                                     "inter_mode": 6}, True),
        "single, global mv unwarped": ({"inter_mode": 2}, True),
        "seg": ({"comp_type": 3, "pad1": 2}, False),
        "wedge": ({"comp_type": 4, "pad1": 2}, False),
        "avg, ref 1 warped": ({"comp_type": 2, "pad1": 5,
                               "inter_mode": 6}, False),
        "avg, ref 0 warped": ({"comp_type": 2, "pad0": 5, "pad1": 2,
                               "inter_mode": 6}, False),
        "single, warped": ({"pad0": 5, "inter_mode": 2}, False),
        "obmc": ({"motion_mode": 1}, False),
        "local warp": ({"motion_mode": 2}, False),
        "interintra": ({"interintra_type": 1}, False),
        "scaled ref 0": ({"pad0": 4}, False),
        "avg, scaled ref 1": ({"comp_type": 2, "pad1": 4}, False),
        "avg, empty ref 1": ({"comp_type": 2, "pad1": 6}, False),
        "filter2d 9": ({"filter2d": 9}, False),
        "sub-8x8 chroma": ({"bs": 18}, False),
        "intra": ({"kind": 0}, False),
    }
    cb = np.zeros(len(cases), CAP_BLOCK_DT)
    cb["kind"], cb["bs"], cb["pad0"] = 1, 3, 1  # 16x16 from ref 0
    for i, (fields, _) in enumerate(cases.values()):
        for k, v in fields.items():
            cb[k][i] = v
    sel, ref0, ref1 = mc_select(f, cb)
    got = dict(zip(cases, sel.tolist()))
    assert got == {k: v[1] for k, v in cases.items()}
    assert ref0[0] == 0 and ref1[0] == -1 and ref1[1] == 1


def test_native_job_table():
    """The port's native C (``dtpu_mc_jobs``) writes, for a 4:2:0
    frame's single-reference, CT_AVG and CT_WEIGHTED_AVG blocks, the
    rows ops/mc.job_table makes of their columns (plane-major, the
    second reference's columns zero on single-reference jobs, 4-tap
    sets on 4-pixel sides, identity rows at phase 0) and their
    tile_list; it counts the tiles without a table, and refuses a block
    that leaves the output."""
    from dav1d_tpu_torch.native import lib
    from dav1d_tpu_torch.native.decode_glue import (CAP_BLOCK_DT,
                                                    CInterCtx, CReplayCtx)

    subf = tables.mc_subpel_filters.astype(np.int32)
    # (bs, bx, by, pad0, pad1, mv0, mv1, filter2d, comp_type)
    # on a 96x64 frame: 16x16, 16x32, 8x8 (4x4 chroma) and 8x16 at the
    # bottom-right corner
    blocks = [(12, 4, 2, 1, 0, (5, -13), (0, 0), 4, 0),
              (11, 8, 4, 2, 3, (-7, 22), (3, 1), 0, 2),
              (17, 0, 0, 1, 2, (0, 0), (-1, -17), 8, 1),
              (16, 22, 12, 3, 0, (-40, 9), (0, 0), 5, 0)]
    cb = np.zeros(len(blocks), CAP_BLOCK_DT)
    for i, (bs, bx, by, p0, p1, m0, m1, f2d, ct) in enumerate(blocks):
        cb[i]["bs"], cb[i]["bx"], cb[i]["by"] = bs, bx, by
        cb[i]["pad0"], cb[i]["pad1"] = p0, p1
        cb[i]["mv"] = (m0, m1)
        cb[i]["filter2d"], cb[i]["comp_type"], cb[i]["kind"] = f2d, ct, 1
    rc, ic = CReplayCtx(), CInterCtx()
    rc.layout, rc.ss_hor, rc.ss_ver = 1, 1, 1
    rc.cap_blocks = cb.ctypes.data
    bdim = np.ascontiguousarray(tables.block_dimensions, dtype=np.uint8)
    rc.block_dim = bdim.ctypes.data
    filt = np.ascontiguousarray(tables.mc_subpel_filters, dtype=np.int8)
    ic.subpel_filters = filt.ctypes.data
    for i in range(7):
        for j in range(7):
            ic.jnt_weights[i][j] = (3 * i + j) % 17
    ent = (np.arange(21, dtype=np.int32) + 100).reshape(7, 3)
    shapes = [(64, 96), (32, 48), (32, 48)]
    base = np.cumsum([0] + [h * w for h, w in shapes], dtype=np.int64)
    stride = np.array([w for _, w in shapes], dtype=np.int64)
    idxs = np.array([2, 0, 1, 3], dtype=np.int64)

    def run(n_out, with_table=True):
        nj = 3 * len(idxs)
        jobs = np.full((nj, tmc.JOB_COLS), -7, np.int32)
        tiles = np.full((nj * 32, tmc.TILE_COLS), -7, np.int32)
        n_pix = ctypes.c_int64()
        nt = lib.dtpu_mc_jobs(
            ctypes.byref(rc), ctypes.byref(ic), idxs.ctypes.data,
            len(idxs), ent.ctypes.data, base.ctypes.data,
            stride.ctypes.data, n_out,
            jobs.ctypes.data if with_table else None,
            tiles.ctypes.data if with_table else None, ctypes.byref(n_pix))
        return nt, jobs, tiles[:max(nt, 0)], n_pix.value

    def taps(sets, phase):
        rows = np.zeros((len(phase), 8), np.int32)
        rows[:, 3] = 64
        nz = phase != 0
        rows[nz] = subf[sets[nz], phase[nz] - 1]
        return rows

    cols = {k: [] for k in ("e0", "dy0", "dx0", "fh0", "fv0", "e1", "dy1",
                            "dx1", "fh1", "fv1", "w", "h", "out", "st",
                            "ct", "jw")}
    for pl in range(3):
        ss = 1 if pl else 0
        for i in idxs:
            bs, bx, by, p0, p1, m0, m1, f2d, ct = blocks[i]
            w = int(tables.block_dimensions[bs, 0]) * (4 >> ss)
            h = int(tables.block_dimensions[bs, 1]) * (4 >> ss)
            ht, vt = (0, 0, 0, 2, 2, 2, 1, 1, 1)[f2d], f2d % 3
            hs = np.array([ht if w > 4 else 3 + (ht & 1)])
            vs = np.array([vt if h > 4 else 3 + (vt & 1)])
            for k, (p, (my, mx)) in enumerate(((p0, m0), (p1, m1))):
                on = k == 0 or ct
                cols[f"e{k}"].append(ent[p - 1, pl] if on else 0)
                cols[f"dy{k}"].append(by * (4 >> ss) + (my >> (3 + ss))
                                      if on else 0)
                cols[f"dx{k}"].append(bx * (4 >> ss) + (mx >> (3 + ss))
                                      if on else 0)
                ph = np.array([(mx & (15 >> (1 - ss))) << (1 - ss)])
                pv = np.array([(my & (15 >> (1 - ss))) << (1 - ss)])
                cols[f"fh{k}"].append(taps(hs, ph)[0] if on else [0] * 8)
                cols[f"fv{k}"].append(taps(vs, pv)[0] if on else [0] * 8)
            cols["w"].append(w)
            cols["h"].append(h)
            cols["out"].append(base[pl] + (by * 4 >> ss) * stride[pl]
                               + (bx * 4 >> ss))
            cols["st"].append(stride[pl])
            cols["ct"].append(ct)
            cols["jw"].append((3 * (p0 - 1) + p1 - 1) % 17 if ct else 0)
    c = {k: np.array(v) for k, v in cols.items()}
    want, want_tiles, want_pix = tmc.job_table(
        c["e0"], c["dy0"], c["dx0"], c["w"], c["h"], c["out"], c["st"],
        c["fh0"], c["fv0"], int(base[-1]),
        compound=(c["e1"], c["dy1"], c["dx1"], c["fh1"], c["fv1"], c["ct"],
                  c["jw"]))
    nt, jobs, tiles, n_pix = run(int(base[-1]))
    np.testing.assert_array_equal(jobs, want)
    np.testing.assert_array_equal(tiles, want_tiles)
    assert (nt, n_pix) == (len(want_tiles), want_pix)
    assert run(int(base[-1]), with_table=False)[0] == nt
    # the last chroma block ends past an output one pixel shorter
    assert run(int(base[-1]) - 1)[0] == -1


_HARNESS = r"""
#include <stdint.h>
#include "mc_core.cuh"

static mc::Ref ref_of(const long long* table, int entry) {
    const long long* tb = table + 4 * entry;
    return mc::Ref{(const int*)(intptr_t)tb[0], tb[1], (int)tb[2],
                   (int)tb[3]};
}

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
        for (int i = 0; i < nt; i++)
            mc::stage(s, ref_of(table, s.job[mc::J_ENTRY]), 0, ty, tx, th,
                      tw, i, nt);
        for (int i = 0; i < nt; i++) mc::hpass(s, 0, th, tw, ib, i, nt);
        if (s.job[mc::J_COMP] == mc::CT_NONE) {
            for (int i = 0; i < nt; i++)
                mc::vpass<T>(s, out, ty, tx, th, tw, ib, maxp, i, nt);
            continue;
        }
        // a compound tile: each thread's Acc carries its registers from
        // vprep to vblend
        static mc::Acc acc[32];
        for (int i = 0; i < nt; i++) mc::vprep(s, acc[i], th, tw, i, nt);
        for (int i = 0; i < nt; i++)
            mc::stage(s, ref_of(table, s.job[mc::J_ENTRY1]), 1, ty, tx, th,
                      tw, i, nt);
        for (int i = 0; i < nt; i++) mc::hpass(s, 1, th, tw, ib, i, nt);
        for (int i = 0; i < nt; i++)
            mc::vblend<T>(s, acc[i], out, ty, tx, th, tw, ib, maxp, i, nt);
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


def _check_kernel_source(lib, bitdepth, compound):
    """mc_core.cuh's phases on the mixed job list (split 128x128 jobs,
    one-tile 4x4 jobs, windows beyond every edge, junk past the coded
    size; with ``compound``, every third job blending a second
    reference of its plane kind) equal the plain version exactly."""
    rng = np.random.default_rng(400 + bitdepth + 10 * compound)
    planes, coded, e, dy, dx, w, h, fh, fv = _mixed_frame(rng, bitdepth)
    wv, hv = w.astype(np.int64), h.astype(np.int64)
    off, stride, n_out = _layout(wv, hv, wv + 3)
    comp = None
    if compound:
        # the other reference's plane of the same kind (entries 0-2 and
        # 3-5), its own origin anywhere the mixed frame's may lie
        e1 = (e + 3) % 6
        o = rng.permutation(len(e))
        comp = _compound_cols(rng, len(e), e1, dy[o], dx[o], w, h, every=3)
    jobs, tiles, n_pix = tmc.job_table(e, dy, dx, wv, hv, off, stride, fh,
                                       fv, n_out, compound=comp)
    if compound:
        assert (jobs[:, tmc.J_COMP] == tmc.CT_AVG).any()
        assert (jobs[:, tmc.J_COMP] == tmc.CT_WEIGHTED_AVG).any()
    assert (tiles[:, tmc.T_H] * tiles[:, tmc.T_W] == 16).any()
    assert (np.bincount(tiles[:, tmc.T_JOB]) == 32).any()
    table = np.array([(p.ctypes.data, p.shape[1], vh, vw)
                      for p, (vh, vw) in zip(planes, coded)], np.int64)
    got = np.zeros(n_out, np.uint8 if bitdepth == 8 else np.int16)
    lib.mc_host(table.ctypes.data, jobs.ctypes.data, tiles.ctypes.data,
                len(tiles), got.ctypes.data, bitdepth)
    want = tmc.put_8tap_resident_plain(
        [torch.from_numpy(p) for p in planes], coded,
        torch.from_numpy(jobs), torch.from_numpy(tiles), n_pix, n_out,
        bitdepth).numpy()
    assert np.array_equal(got, want), \
        f"mismatch at {np.flatnonzero(got != want)[:4]}"


@pytest.mark.parametrize("bitdepth", [8, 10, 12])
def test_kernel_source_on_host(kernel_on_host, bitdepth):
    """mc_core.cuh's phases on the mixed job list, single-reference jobs
    (:func:`_check_kernel_source`)."""
    _check_kernel_source(kernel_on_host, bitdepth, compound=False)


@pytest.mark.parametrize("bitdepth", [8, 10, 12])
def test_kernel_source_on_host_compound(kernel_on_host, bitdepth):
    """The same with a third of the jobs compound (CT_AVG and
    CT_WEIGHTED_AVG): the kernel's two-pass tile with reference 0's
    prep values carried from vprep to vblend."""
    _check_kernel_source(kernel_on_host, bitdepth, compound=True)
