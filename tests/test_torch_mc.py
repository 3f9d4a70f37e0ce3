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
  one-kernel form equals the TPU's interior tier.

The plain version is what the wrapper runs on CPU tensors; the CUDA
kernel is compared with it on the card by chip_smoke.py.
Tolerance: exact (integer codec)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dav1d_tpu.ops.mc import _put_8tap_resident_prog
from dav1d_tpu.ops.pallas_mc import BB, _gather_put_prog
from dav1d_tpu.pipeline import MC_PAD, _slot_rows, _stack_prog
from dav1d_tpu_torch import devrt, tables
from dav1d_tpu_torch.ops import mc as tmc


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


def _port(planes, coded, entry, dy, dx, w, h, fh, fv, bitdepth,
          stride=None):
    """The plain job-list version on CPU tensors.  Each job's block is
    written at a stride (default: its width, blocks back to back), with
    a gap row between blocks that no job writes.  Returns the (N, h, w)
    block of each job when w and h are scalars, else (output, offsets,
    stride)."""
    n = len(dy)
    wv = np.broadcast_to(w, n).astype(np.int64)
    hv = np.broadcast_to(h, n).astype(np.int64)
    stride = wv if stride is None else np.broadcast_to(stride, n)
    size = (hv + 1) * stride
    off = np.cumsum(size) - size
    jobs, n_pix = tmc.job_table(entry, dy, dx, wv, hv, off, stride, fh, fv,
                                int(size.sum()))
    assert n_pix == int((wv * hv).sum())
    before = dict(devrt.LAUNCHES)
    out = tmc.put_8tap_resident(
        [torch.from_numpy(p) for p in planes], coded,
        torch.from_numpy(jobs), n_pix, int(size.sum()), bitdepth)
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


def test_plain_mixed_frame_job_list():
    """One call, as the decoder makes it: two references x (luma, two
    4:2:0 chroma planes), every block size the selection can produce
    (luma sides 8..128, chroma 4..64), jobs in no particular order."""
    rng = np.random.default_rng(7)
    bitdepth = 10
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
    with pytest.raises(ValueError, match="coded size"):
        tmc.put_8tap_resident([plane], [(17, 16)], jobs, 16, 16, 8)
    with pytest.raises(TypeError, match="dtype"):
        tmc.put_8tap_resident([plane.to(torch.int16)], [(16, 16)], jobs,
                              16, 16, 8)
    with pytest.raises(ValueError, match="bitdepth"):
        tmc.put_8tap_resident([plane], [(16, 16)], jobs, 16, 16, 9)
    rows = np.zeros((1, 8), np.int32)
    with pytest.raises(ValueError, match="outside the output"):
        # a 4x4 block at stride 4 from offset 4 needs 20 output pixels
        tmc.job_table([0], [0], [0], 4, 4, [4], 4, rows, rows, 19)
