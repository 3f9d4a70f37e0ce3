"""Batched translational motion compensation on device tensors
(counterpart of dav1d_tpu/ops/mc.py and ops/pallas_mc.py).

The reference's put_8tap (src/mc_tmpl.c:130-180) in the fused form of
dav1d_tpu/ops/mc.py: the H-only / V-only / copy cases collapse into the
separable H+V path with an identity filter row ([.., 64, ..] at tap 3),
bit-exact by the nested-floor identity argued there, so one filter
covers every subpel combination:

    mid[y, x] = rnd(sum_t fh[t] * src[y + t - 3, x + t - 3], 6 - ib)
    out[y, x] = clip(rnd(sum_t fv[t] * mid[y + t, x], 6 + ib), 0, 2^bd-1)

with ``rnd(v, s) = (v + ((1 << s) >> 1)) >> s`` and every read clamped
to the reference's coded size (emu_edge, src/mc_tmpl.c; the TPU
replicates it with a MC_PAD border, dav1d_tpu/pipeline.py:181-207).
All arithmetic is int32.

A frame's work is a flat job list over resident reference planes: one
job is one block of one plane, a row of :func:`job_table`.  Its
predictions are written, narrow (uint8 at 8-bit, int16 above, as
``devrt.narrow_cast``), as an h x w block at the job's offset and row
stride into one flat output buffer (the decoder lays the current
frame's planes out there, so the predictions land in place).  The
buffer starts zeroed; pixels no job writes stay 0.

A compound job (``J_COMP`` = ``CT_AVG`` or ``CT_WEIGHTED_AVG``) also
names a second reference, origin and filter pair: both predictions are
made in the reference's prep form (prep_8tap_c: the vertical sum rounded
by 6, less PREP_BIAS above 8-bit) and blended per pixel, avg_c
``clip((p0 + p1 + rnd) >> (ib + 1))`` or w_avg_c
``clip((p0 * jw + p1 * (16 - jw) + rnd) >> (ib + 4))`` with the job's
jnt weight ``jw`` (src/mc_tmpl.c; dav1d_tpu/ops/mc.py prep_8tap, avg,
w_avg).  A single-reference job has ``J_COMP`` = ``CT_NONE``.

* :func:`put_8tap_resident_plain` is the plain PyTorch version: per
  (plane, w, h) group, the clamped index gather and the separable filter
  of the reference's ``_put_8tap_resident_prog``/``_put_core``
  (dav1d_tpu/ops/mc.py:42-57, 82-104).
* :func:`put_8tap_resident` is the wrapper: the plain version for CPU
  tensors, the CUDA kernel ``csrc/mc.cu`` (arithmetic in
  ``csrc/mc_core.cuh``) for CUDA tensors (launch counted under the tag
  ``mc``), over the :func:`tile_list` that :func:`job_table` returns
  beside the jobs.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import devrt
from ..kernels import build

# columns of a job row (int32; csrc/mc_core.cuh J_*): reference plane,
# block origin, size, output offset and row stride, taps
J_ENTRY, J_DY, J_DX, J_W, J_H, J_OUT, J_OSTRIDE = range(7)
J_FH = 7      # 8 horizontal taps
J_FV = 15     # 8 vertical taps
# a compound job's second reference (plane, origin, taps), its blend and
# jnt weight (0 on single-reference jobs)
J_ENTRY1, J_DY1, J_DX1 = 23, 24, 25
J_FH1 = 26
J_FV1 = 34
J_COMP, J_JW = 42, 43
JOB_COLS = 44
# J_COMP values (levels.CompInterType)
CT_NONE, CT_WEIGHTED_AVG, CT_AVG = 0, 1, 2
# columns of a tile row (int32; mc_core.cuh T_*): job, origin inside the
# job's block, size; and the largest tile (one warp of the kernel each)
T_JOB, T_Y, T_X, T_H, T_W = range(5)
TILE_COLS = 5
TILE_H, TILE_W = 16, 32


def intermediate_bits(bitdepth: int) -> int:
    # reference src/mc_tmpl.c:40-47
    return 4 if bitdepth == 8 else 14 - bitdepth


def out_dtype(bitdepth: int) -> torch.dtype:
    return torch.uint8 if bitdepth == 8 else torch.int16


def tile_list(w, h) -> np.ndarray:
    """The kernel's work list for jobs of sizes ``w`` x ``h``: (N, TILE_COLS)
    int32 rows (job, tile row, tile column, tile h, tile w) cutting each
    job's block into tiles of at most TILE_H x TILE_W, in job order."""
    w = np.asarray(w, dtype=np.int32)
    h = np.asarray(h, dtype=np.int32)
    nx = (w + TILE_W - 1) // TILE_W
    cnt = nx * ((h + TILE_H - 1) // TILE_H)
    job = np.repeat(np.arange(len(w), dtype=np.int32), cnt)
    first = np.cumsum(cnt, dtype=np.int32) - cnt
    ty, tx = np.divmod(np.arange(job.size, dtype=np.int32)
                       - np.repeat(first, cnt), nx[job])
    tiles = np.empty((job.size, TILE_COLS), dtype=np.int32)
    tiles[:, T_JOB] = job
    tiles[:, T_Y] = ty * TILE_H
    tiles[:, T_X] = tx * TILE_W
    np.minimum(TILE_H, h[job] - tiles[:, T_Y], out=tiles[:, T_H])
    np.minimum(TILE_W, w[job] - tiles[:, T_X], out=tiles[:, T_W])
    return tiles


def job_table(entry, dy, dx, w, h, out_off, out_stride, fh, fv, n_out,
              compound=None):
    """The job rows for :func:`put_8tap_resident`: the table entry
    (reference plane) each job reads, its block origin (dy, dx) in that
    plane (signed: it may lie outside), its size, the output offset of
    its top-left pixel and its output row stride, and its two 8-tap
    filter rows; with ``compound`` = (entry1, dy1, dx1, fh1, fv1,
    comp_type, jnt_weight), each job's second reference, origin and
    filter rows, its ``CT_*`` blend (``CT_NONE``: a single-reference job,
    whose second-reference columns are ignored) and its jnt weight.
    Returns ((N, JOB_COLS) int32 rows, their :func:`tile_list`, number
    of pixels); raises if a job's block leaves the ``n_out``-pixel output
    or a side is not a positive multiple of 4 (every MC block of the
    codec; the kernel makes 4 outputs a thread), or on a blend other
    than CT_NONE / CT_WEIGHTED_AVG / CT_AVG or a weight outside 0..16."""
    n = len(dy)
    w = np.broadcast_to(w, n).astype(np.int64)
    h = np.broadcast_to(h, n).astype(np.int64)
    out_off = np.broadcast_to(out_off, n).astype(np.int64)
    out_stride = np.broadcast_to(out_stride, n).astype(np.int64)
    if n and (w.min() < 4 or h.min() < 4 or ((w | h) & 3).any()):
        raise ValueError("job sides must be positive multiples of 4")
    last = out_off + (h - 1) * out_stride + w - 1
    if n and (out_off.min() < 0 or last.max() >= n_out
              or (out_stride < w).any()):
        raise ValueError("job blocks outside the output")
    jobs = np.zeros((n, JOB_COLS), dtype=np.int32)
    for col, v in ((J_ENTRY, entry), (J_DY, dy), (J_DX, dx), (J_W, w),
                   (J_H, h), (J_OUT, out_off), (J_OSTRIDE, out_stride)):
        jobs[:, col] = v
    jobs[:, J_FH:J_FH + 8] = fh
    jobs[:, J_FV:J_FV + 8] = fv
    if compound is not None:
        entry1, dy1, dx1, fh1, fv1, comp, jw = compound
        comp = np.broadcast_to(comp, n)
        jw = np.broadcast_to(jw, n)
        if n and (~np.isin(comp, (CT_NONE, CT_WEIGHTED_AVG, CT_AVG)).any()
                  or jw.min() < 0 or jw.max() > 16):
            raise ValueError("compound jobs blend by CT_AVG or "
                             "CT_WEIGHTED_AVG, with a weight in 0..16")
        for col, v in ((J_ENTRY1, entry1), (J_DY1, dy1), (J_DX1, dx1),
                       (J_COMP, comp), (J_JW, jw)):
            jobs[:, col] = v
        jobs[:, J_FH1:J_FH1 + 8] = fh1
        jobs[:, J_FV1:J_FV1 + 8] = fv1
    return jobs, tile_list(w, h), int((w * h).sum())


def _rnd_shift(x: torch.Tensor, sh: int) -> torch.Tensor:
    return (x + ((1 << sh) >> 1)) >> sh


def _vsums(planes, coded, g, e, w, h, cols, ib):
    """The unrounded vertical 8-tap sums (n, h, w) of the jobs ``g``,
    all of plane ``e`` and size w x h, through the reference whose
    origin and taps lie at ``cols`` = (J_DY, J_DX, J_FH, J_FV) or the
    second reference's columns; every read clamped to ``coded[e]``."""
    c_dy, c_dx, c_fh, c_fv = cols
    dev = g.device
    vh, vw = coded[e]
    ys = torch.clamp(g[:, c_dy, None]
                     + torch.arange(-3, h + 4, device=dev), 0, vh - 1)
    xs = torch.clamp(g[:, c_dx, None]
                     + torch.arange(-3, w + 4, device=dev), 0, vw - 1)
    src = planes[e][ys[:, :, None], xs[:, None, :]]  # (n, h+7, w+7)
    fh = g[:, c_fh:c_fh + 8]
    fv = g[:, c_fv:c_fv + 8]
    mid = sum(src[:, :, t:t + w] * fh[:, None, None, t] for t in range(8))
    mid = _rnd_shift(mid, 6 - ib)
    return sum(mid[:, t:t + h, :] * fv[:, None, None, t] for t in range(8))


def put_8tap_resident_plain(planes, coded, jobs: torch.Tensor,
                            tiles: torch.Tensor, n_pix: int, n_out: int,
                            bitdepth: int) -> torch.Tensor:
    """Every job of ``jobs`` (:func:`job_table` rows, int32; ``n_pix``
    pixels in all) filtered from ``planes[entry]`` (2-D int32), each
    read clamped to ``coded[entry]`` = (vh, vw), a compound job's two
    predictions blended (module docstring); returns the (n_out,) narrow
    output buffer with every job's block in place.  ``tiles`` is the
    kernel's schedule and does not change the result: the plain version
    works per (blend, planes, w, h) group of jobs."""
    ib = intermediate_bits(bitdepth)
    maxp = (1 << bitdepth) - 1
    dev = jobs.device
    out = torch.zeros(n_out, dtype=out_dtype(bitdepth), device=dev)
    comp = jobs[:, J_COMP]
    key = torch.stack([comp, jobs[:, J_ENTRY],
                       torch.where(comp != CT_NONE, jobs[:, J_ENTRY1], 0),
                       jobs[:, J_W], jobs[:, J_H]], 1)
    for k in torch.unique(key, dim=0).tolist():
        ct, e, e1, w, h = k
        g = jobs[(key == torch.tensor(k, dtype=key.dtype,
                                      device=dev)).all(1)]
        o = _vsums(planes, coded, g, e, w, h, (J_DY, J_DX, J_FH, J_FV), ib)
        if ct == CT_NONE:
            o = torch.clamp(_rnd_shift(o, 6 + ib), 0, maxp)
        else:
            # prep_8tap_c's intermediates (PREP_BIAS cancels in both
            # blends: the rounding constants below add it back)
            bias = 0 if bitdepth == 8 else 8192
            p0 = _rnd_shift(o, 6) - bias
            p1 = _rnd_shift(_vsums(planes, coded, g, e1, w, h,
                                   (J_DY1, J_DX1, J_FH1, J_FV1), ib),
                            6) - bias
            if ct == CT_AVG:
                o = (p0 + p1 + (1 << ib) + 2 * bias) >> (ib + 1)
            else:
                jw = g[:, J_JW, None, None]
                o = (p0 * jw + p1 * (16 - jw) + (8 << ib) + 16 * bias) \
                    >> (ib + 4)
            o = torch.clamp(o, 0, maxp)
        dst = (g[:, J_OUT, None, None].long()
               + g[:, J_OSTRIDE, None, None].long()
               * torch.arange(h, device=dev)[:, None]
               + torch.arange(w, device=dev))
        out[dst.reshape(-1)] = o.reshape(-1).to(out.dtype)
    return out


def put_8tap_resident(planes, coded, jobs: torch.Tensor, tiles: torch.Tensor,
                      n_pix: int, n_out: int, bitdepth: int) -> torch.Tensor:
    """The frame's batched put_8tap (see :func:`put_8tap_resident_plain`).
    CPU tensors run the plain version; CUDA tensors launch
    ``csrc/mc.cu``: one launch for every tile of every job, whatever its
    plane, block size or reference.  ``jobs`` and ``tiles`` must come
    from :func:`job_table`, which checks that every block lies inside the
    output."""
    if bitdepth not in (8, 10, 12):
        raise ValueError(f"bitdepth {bitdepth}")
    build.check(jobs, "jobs")
    if jobs.dim() != 2 or jobs.shape[1] != JOB_COLS:
        raise ValueError(f"jobs: shape {tuple(jobs.shape)}, expected "
                         f"(N, {JOB_COLS})")
    build.check(tiles, "tiles")
    if tiles.dim() != 2 or tiles.shape[1] != TILE_COLS:
        raise ValueError(f"tiles: shape {tuple(tiles.shape)}, expected "
                         f"(N, {TILE_COLS})")
    if len(planes) != len(coded):
        raise ValueError("one coded size per plane")
    for i, (p, (vh, vw)) in enumerate(zip(planes, coded)):
        build.check(p, f"planes[{i}]")
        if p.dim() != 2 or not (0 < vh <= p.shape[0]
                                and 0 < vw <= p.shape[1]):
            raise ValueError(f"planes[{i}]: shape {tuple(p.shape)}, coded "
                             f"size {(vh, vw)}")
    if not build.on_cuda(jobs, tiles, *planes):
        return put_8tap_resident_plain(planes, coded, jobs, tiles, n_pix,
                                       n_out, bitdepth)
    out = torch.zeros(n_out, dtype=out_dtype(bitdepth), device=jobs.device)
    if tiles.shape[0] == 0:
        return out
    # the device table: (base pointer, row stride, vh, vw) per plane
    table = devrt.upload(np.array(
        [(p.data_ptr(), p.stride(0), vh, vw)
         for p, (vh, vw) in zip(planes, coded)], dtype=np.int64),
        jobs.device)
    with torch.cuda.device(jobs.device):
        devrt.launch("mc", build.lib().dtpu_mc_put_8tap, table.data_ptr(),
                     jobs.data_ptr(), tiles.data_ptr(), int(tiles.shape[0]),
                     out.data_ptr(), int(bitdepth), build.stream(jobs),
                     keep=table)
    return out
