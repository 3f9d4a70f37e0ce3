"""Every inverse transform of a frame on device tensors (counterpart of
dav1d_tpu/ops/itx.py and ops/pallas_itx.py).

The reference's batched transform ``_itx_core`` (dav1d_tpu/ops/itx.py:
106-165; reference src/itx_1d.c + src/itx_tmpl.c:44-121) per block:
column-major coefficients ``[x][y]`` (sw = min(w, 32), sh = min(h, 32):
64-point transforms are zero-extended from 32), the rect2 pre-scale
``(c*181+128)>>8`` at a 2:1 aspect, the row 1-D transform with the row
clip, ``cclip((x+rnd)>>TX_SHIFT[tx])``, the column 1-D transform with the
column clip, ``(x+8)>>4``; WHT_WHT is ``cf>>2``, four ``wht4`` rows and
four ``wht4`` columns, with no clip and no final shift.

A frame's work is a flat job list over the frame's coefficient arena:
one job is one transform block, a row of :func:`job_table`.  Its
residuals are written row-major, h x w, at the job's offset into one flat
output buffer: int16 at bit depths 8/10 (|residual| <= 8192) and int32 at
12-bit (12-bit IDTX reaches 32768; dav1d_tpu/ops/itx.py:270-275).

* :func:`itx_frame_plain` is the plain PyTorch version: ``_itx_core`` on
  torch lanes per (tx, txtp) group, with the port's 1-D kernels
  (recon/itx.py ``_1D_FNS``, polymorphic over the lane container), in
  int32 at 8/10-bit and int64 at 12-bit, where the canonical rotations
  overflow int32 (the reference's device tier uses int32 split forms
  there, which are exact rewrites of the same values).
* :func:`itx_frame` is the wrapper: the plain version for CPU tensors,
  the CUDA kernel ``csrc/itx.cu`` (arithmetic and phases in
  ``csrc/itx_core.cuh``) for CUDA tensors: one launch for every job of
  the frame, counted under the tag ``itx``, over the :func:`group_list`
  that :func:`job_table` returns beside the jobs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import devrt, tables
from ..kernels import build
from ..levels import TxfmType
from ..recon.itx import _1D_FNS, TX1D_TYPES, TX_SHIFT, wht4

# columns of a job row (int32): coefficient offset into the arena, tx
# size, tx type, offset of the residuals in the flat output
J_CF, J_TX, J_TXTP, J_OUT = range(4)
JOB_COLS = 4
N_TX = 19
N_TXTP = 17  # 16 types + WHT_WHT
# columns of a group row (int32; csrc/itx_core.cuh G_*): first job,
# number of jobs, their tx size; and the threads of the kernel's CTA,
# one group each
G_FIRST, G_COUNT, G_TX = range(3)
GROUP_COLS = 3
LANES = 64


@functools.lru_cache(maxsize=None)
def _txinfo(tx):
    t_dim = tables.txfm_info()[tx]
    return (4 * int(t_dim[0]), 4 * int(t_dim[1]), int(t_dim[2]),
            int(t_dim[3]))


def valid_pair(tx: int, txtp: int) -> bool:
    """Whether (tx, txtp) is a transform the codec has: ADST and FLIPADST
    reach 16, IDENTITY 32 and only DCT 64; WHT_WHT is 4x4 only."""
    if txtp == TxfmType.WHT_WHT:
        return tx == 0
    w, h, lw, lh = _txinfo(tx)
    row_t, col_t = TX1D_TYPES[TxfmType(txtp)]
    return (lw, row_t) in _1D_FNS and (lh, col_t) in _1D_FNS


@functools.lru_cache(maxsize=None)
def _luts():
    """(valid (N_TX, N_TXTP) bool, h*w per tx, sw*sh per tx, w per
    tx)."""
    valid = np.array([[valid_pair(tx, tp) for tp in range(N_TXTP)]
                      for tx in range(N_TX)])
    hw = np.array([_txinfo(tx)[0] * _txinfo(tx)[1] for tx in range(N_TX)],
                  dtype=np.int64)
    nc = np.array([min(_txinfo(tx)[0], 32) * min(_txinfo(tx)[1], 32)
                   for tx in range(N_TX)], dtype=np.int64)
    w = np.array([_txinfo(tx)[0] for tx in range(N_TX)], dtype=np.int64)
    return valid, hw, nc, w


def group_list(tx) -> np.ndarray:
    """The kernel's schedule for jobs of tx sizes ``tx``, in job order
    (jobs of one size contiguous, as :func:`job_table` sorts them):
    (N, GROUP_COLS) int32 rows (first job, number of jobs, tx size)
    cutting each run of one tx size into groups of LANES / w consecutive
    jobs of width w, one CTA each: its column pass has a lane per
    column."""
    tx = np.asarray(tx, dtype=np.int64)
    n = len(tx)
    idx = np.arange(n)
    start = np.ones(n, dtype=bool)
    start[1:] = tx[1:] != tx[:-1]
    run0 = np.maximum.accumulate(np.where(start, idx, 0))
    per = LANES // _luts()[3][tx]
    first = np.flatnonzero((idx - run0) % per == 0)
    groups = np.empty((len(first), GROUP_COLS), dtype=np.int32)
    groups[:, G_FIRST] = first
    groups[:, G_COUNT] = np.diff(np.append(first, n))
    groups[:, G_TX] = tx[first]
    return groups


def check_groups(tx, groups) -> None:
    """Raise unless ``groups`` is a schedule the kernel takes for jobs of
    tx sizes ``tx``: groups of 1 .. LANES / w jobs of the group's own tx
    size, covering every job once, in order, as :func:`group_list`
    makes them (the kernel stops on a group row that breaks this)."""
    tx = np.asarray(tx, dtype=np.int64)
    g = np.asarray(groups, dtype=np.int64).reshape(-1, GROUP_COLS)
    first, cnt, gtx = g[:, G_FIRST], g[:, G_COUNT], g[:, G_TX]
    if len(g) and (gtx.min() < 0 or gtx.max() >= N_TX):
        raise ValueError("groups: a tx size out of range")
    if len(g) and (cnt.min() < 1
                   or (cnt > LANES // _luts()[3][gtx]).any()):
        raise ValueError(f"groups: a group of no jobs or of more than "
                         f"{LANES} / w jobs")
    if (cnt.sum() != len(tx)
            or not np.array_equal(first, np.cumsum(cnt) - cnt)
            or not np.array_equal(np.repeat(gtx, cnt), tx)):
        raise ValueError("groups: not every job once, in order, in a "
                         "group of its tx size")


def out_dtype(bitdepth: int) -> torch.dtype:
    return torch.int16 if bitdepth <= 10 else torch.int32


def job_table(cf_off, tx, txtp, eob, n_cf):
    """The job rows for :func:`itx_frame`, one per transform block given
    by its coefficient offset into an ``n_cf``-word arena, tx size, tx type
    and eob.  Jobs are sorted by (tx, txtp) and then eob, as the reference
    groups them (dav1d_tpu/pipeline.py:105-113), so neighbouring jobs
    take the same branches; each job's residuals follow the previous
    job's in the output (a prefix sum of h*w).  Returns (order, jobs,
    groups, n_out): ``order`` maps job rows to the input rows, ``jobs``
    is (N, JOB_COLS) int32, ``groups`` their :func:`group_list` (the
    kernel's schedule), ``n_out`` the number of residuals.  Raises on a
    pair the codec does not have and on coefficients outside the
    arena."""
    cf_off = np.asarray(cf_off, dtype=np.int64)
    tx = np.asarray(tx, dtype=np.int64)
    txtp = np.asarray(txtp, dtype=np.int64)
    eob = np.asarray(eob, dtype=np.int64)
    valid, hw, nc, _ = _luts()
    if len(tx) and (tx.min() < 0 or tx.max() >= N_TX or txtp.min() < 0
                    or txtp.max() >= N_TXTP
                    or not valid[tx, txtp].all()):
        bad = [(int(a), int(b)) for a, b in zip(tx, txtp)
               if not (0 <= a < N_TX and 0 <= b < N_TXTP and valid[a, b])]
        raise ValueError(f"invalid (tx, txtp) pairs: {sorted(set(bad))}")
    if len(tx) and (cf_off.min() < 0 or (cf_off + nc[tx]).max() > n_cf):
        raise ValueError("job coefficients outside the arena")
    key = (tx << 5 | txtp) << 11 | np.clip(eob, 0, 0x7FF)
    order = np.argsort(key, kind="stable")
    size = hw[tx[order]]
    n_out = int(size.sum())
    if n_out >= 1 << 31:
        raise ValueError(f"{n_out} residuals exceed int32 offsets")
    jobs = np.stack([cf_off[order], tx[order], txtp[order],
                     np.cumsum(size) - size], axis=1).astype(np.int32)
    return order, jobs, group_list(tx[order]), n_out


def _itx_core(cf: torch.Tensor, tx: int, txtp: int,
              bitdepth: int) -> torch.Tensor:
    """(B, sw*sh) coefficients (int32, or int64 at 12-bit) -> (B, h*w)
    residuals, row-major (dav1d_tpu/ops/itx.py _itx_core on torch
    lanes).  ``cf`` is never written: the identity kernels update lanes
    in place, so every lane is a view of a fresh tensor."""
    w, h, lw, lh = _txinfo(tx)
    sw, sh = min(w, 32), min(h, 32)
    B = cf.shape[0]

    if txtp == TxfmType.WHT_WHT:
        grid = (cf >> 2).reshape(B, 4, 4)  # [x][y]
        lanes = [grid[:, x, y] for y in range(4) for x in range(4)]
        for y in range(4):
            wht4(lanes, y * 4, 1)
        for x in range(4):
            wht4(lanes, x, 4)
        return torch.stack(lanes, dim=1)

    is_rect2 = (w * 2 == h) or (h * 2 == w)
    shift = TX_SHIFT[tx]
    rnd = (1 << shift) >> 1
    if bitdepth == 8:
        row_min = col_min = -(1 << 15)
    else:
        row_min = -(1 << (bitdepth + 7))
        col_min = -(1 << (bitdepth + 5))
    row_max, col_max = ~row_min, ~col_min

    def rclip(v):
        return torch.clamp(v, row_min, row_max)

    def cclip(v):
        return torch.clamp(v, col_min, col_max)

    row_t, col_t = TX1D_TYPES[TxfmType(txtp)]
    grid = cf.reshape(B, sw, sh)  # [x][y]
    if is_rect2:
        grid = (grid * 181 + 128) >> 8

    # row pass: lanes indexed by x, each (B, sh); columns sw.. are zero
    rows = cf.new_zeros((B, w, sh))
    rows[:, :sw] = grid
    lanes = list(rows.unbind(1))
    _1D_FNS[(lw, row_t)](lanes, 0, 1, rclip)
    lanes = [cclip((ln + rnd) >> shift) for ln in lanes]

    # column pass: lanes indexed by y, each (B, w); rows sh.. are zero
    cols = cf.new_zeros((B, h, w))
    cols[:, :sh] = torch.stack(lanes, dim=2)
    lanes = list(cols.unbind(1))
    _1D_FNS[(lh, col_t)](lanes, 0, 1, cclip)
    return (torch.stack(lanes, dim=1).reshape(B, h * w) + 8) >> 4


def itx_frame_plain(cf: torch.Tensor, jobs: torch.Tensor, n_out: int,
                    bitdepth: int) -> torch.Tensor:
    """Every job of ``jobs`` (:func:`job_table` rows, int32) transformed
    from the 1-D int32 coefficient arena ``cf``; returns the (n_out,)
    residual buffer (:func:`out_dtype`) with every job's h x w block at
    its offset."""
    dt = torch.int64 if bitdepth == 12 else torch.int32
    dev = cf.device
    out = torch.zeros(n_out, dtype=out_dtype(bitdepth), device=dev)
    key = jobs[:, J_TX].long() * 32 + jobs[:, J_TXTP].long()
    for k in torch.unique(key).tolist():
        g = jobs[key == k]
        tx, txtp = k >> 5, k & 31
        w, h, _, _ = _txinfo(tx)
        nc = min(w, 32) * min(h, 32)
        # the gather copies: the arena is never written
        coef = cf[g[:, J_CF, None].long()
                  + torch.arange(nc, device=dev)].to(dt)
        res = _itx_core(coef, tx, txtp, bitdepth)
        dst = g[:, J_OUT, None].long() + torch.arange(h * w, device=dev)
        out[dst.reshape(-1)] = res.reshape(-1).to(out.dtype)
    return out


def itx_frame(cf: torch.Tensor, jobs: torch.Tensor, groups: torch.Tensor,
              n_out: int, bitdepth: int) -> torch.Tensor:
    """The frame's inverse transforms (see :func:`itx_frame_plain`).
    ``groups`` is the kernel's schedule and does not change the result.
    CPU tensors run the plain version, after :func:`check_groups`; CUDA
    tensors launch ``csrc/itx.cu``: one launch for every group of jobs,
    whatever their size or type.  ``jobs`` and ``groups`` must come from
    :func:`job_table`, which checks every pair and every coefficient
    window and keeps each group within one tx size."""
    if bitdepth not in (8, 10, 12):
        raise ValueError(f"bitdepth {bitdepth}")
    build.check(cf, "cf")
    if cf.dim() != 1:
        raise ValueError(f"cf: shape {tuple(cf.shape)}, expected 1-D")
    build.check(jobs, "jobs")
    if jobs.dim() != 2 or jobs.shape[1] != JOB_COLS:
        raise ValueError(f"jobs: shape {tuple(jobs.shape)}, expected "
                         f"(N, {JOB_COLS})")
    build.check(groups, "groups")
    if groups.dim() != 2 or groups.shape[1] != GROUP_COLS:
        raise ValueError(f"groups: shape {tuple(groups.shape)}, expected "
                         f"(N, {GROUP_COLS})")
    if not build.on_cuda(cf, jobs, groups):
        check_groups(jobs[:, J_TX].numpy(), groups.numpy())
        return itx_frame_plain(cf, jobs, n_out, bitdepth)
    # zeroed like the plain version's (a job list from job_table writes
    # every element)
    out = torch.zeros(n_out, dtype=out_dtype(bitdepth), device=cf.device)
    if groups.shape[0] == 0:
        return out
    with torch.cuda.device(cf.device):
        devrt.launch("itx", build.lib().dtpu_itx_frame, cf.data_ptr(),
                     jobs.data_ptr(), groups.data_ptr(),
                     int(groups.shape[0]), out.data_ptr(), int(bitdepth),
                     build.stream(cf))
    return out
