"""Loop restoration on device tensors (counterpart of dav1d_tpu/ops/lr.py
_jit_wiener / _jit_sgr, as dav1d_tpu/recon/device_chain.py
_jit_lr_group gathers, filters and scatters them).

A frame's stripe units come from recon/lr_apply.lr_frame(f, geom_sink=)
and travel as job rows (:func:`job_tables`): origin, width, stripe
height, edge flags, plane height and six filter parameters.  Two
operations, each a plain PyTorch version plus a wrapper that launches
``csrc/lr.cu`` on CUDA tensors (CPU tensors run the plain version):

* :func:`wiener`: every Wiener unit of a plane (7-tap separable filter,
  reference wiener_filter_h/v, src/looprestoration_tmpl.c:44-190), one
  kernel CTA per row of its chunk table (:func:`chunk_table`: a band of
  output rows of a 64-column chunk of a unit, 64, 32 or 16 rows as the
  launch's size asks; :func:`check_chunks`);
* :func:`sgr`: every self-guided unit of a plane (variants 0 = 5x5
  only, 1 = 3x3 only, 2 = both; reference sgr_5x5_c / sgr_3x3_c /
  sgr_mix_c, src/looprestoration_tmpl.c:679-1090), one kernel CTA per
  row of its own chunk table (``chunk_table(jobs, sgr=True)``: a band of
  16 output rows of a 32-column chunk, every band starting on an even
  unit row).

Each unit reads a padded window (rows and columns of
lr_apply._pad_unit_indices) from the post-CDEF plane and the pre-CDEF
snapshot and writes its rectangle into the output plane, which is a new
tensor (a clone of the post-CDEF plane unless the caller passes one):
never the input, whose pixels the neighbouring units' windows read.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import devrt, tables
from ..kernels import build
from ..recon.lr_apply import _pad_unit_indices

# columns of a job row (csrc/lr_core.cuh)
JOB_COLS = 12
J_X, J_Y, J_UW, J_SH, J_EDGES, J_H, J_P = range(7)
# the largest unit the kernels take: 1.5 units of 256 columns, a 64-row
# stripe
MAX_UW, MAX_SH = 384, 64
# columns of a chunk row (csrc/lr_core.cuh): job, first column (in the
# unit), first output row (in the unit), rows, then the job's row
CHUNK_COLS = 4 + JOB_COLS
C_JOB, C_X, C_R0, C_NR, C_ROW = range(5)
# output columns of a Wiener chunk; the CTAs a launch should have at
# least: two an SM of an H100 (132 SMs), so a small launch takes bands of
# fewer rows
WIENER_CW = 64
WIENER_MIN_CTAS = 264
# output columns and rows of a self-guided band, which starts on an even
# unit row (the 5x5 (A, B) exist on odd unit rows); a CTA takes one band
SGR_CW, SGR_SB = 32, 16


def job_tables(geom: dict, pl: int):
    """(Wiener jobs, SGR jobs) of plane ``pl``, int32 numpy (n, JOB_COLS),
    from the stripe geometry that lr_apply.lr_frame(f, geom_sink=)
    collects: x, y, uw, sh, edges, h, then fh[3], fv[3] (Wiener) or s0,
    s1, w0, w1, variant, 0 (SGR)."""
    rows = {"w": [], "s": []}
    for key, items in geom.items():
        kind, uw, sh = key[:3]
        if not (0 < uw <= MAX_UW and 0 < sh <= MAX_SH):
            raise ValueError(f"stripe unit {uw}x{sh} beyond "
                             f"{MAX_UW}x{MAX_SH}")
        for it in items:
            if it[0] != pl:
                continue
            _, x, y, e, h = it[:5]
            params = [*it[5], *it[6]] if kind == "w" else \
                [*it[5:9], key[3], 0]
            rows[kind].append([x, y, uw, sh, e, h, *params])
    return tuple(np.asarray(rows[k], np.int32).reshape(-1, JOB_COLS)
                 for k in "ws")


def chunk_table(jobs, band: int = 0, sgr: bool = False) -> np.ndarray:
    """(n, CHUNK_COLS) int32: the Wiener kernel's CTAs (``sgr``: the
    self-guided kernel's) for the job rows ``jobs``, one per (job,
    WIENER_CW- (SGR_CW-) column chunk, band of ``band`` output rows), each
    unit's chunks column by column, the bands of a chunk top to bottom,
    each row followed by its job's row; the last chunk and band of a unit
    hold what is left.  ``band`` 0: for the Wiener kernel the longest band
    that gives at least WIENER_MIN_CTAS rows, of 64 or 32 rows, else 16;
    for the self-guided kernel SGR_SB.  A self-guided band has an even
    number of rows, so that every band starts on an even unit row, and
    at most SGR_SB."""
    J = np.asarray(jobs).reshape(-1, JOB_COLS)
    uw, sh = J[:, J_UW].astype(np.int64), J[:, J_SH].astype(np.int64)
    cw = SGR_CW if sgr else WIENER_CW
    nx = -(-uw // cw)
    if sgr:
        band = band or SGR_SB
        if band % 2 or band > SGR_SB:
            raise ValueError(f"self-guided band of {band} rows: bands of "
                             f"at most {SGR_SB} rows start on even unit "
                             "rows")
    elif not band:
        band = next((b for b in (64, 32)
                     if (nx * -(-sh // b)).sum() >= WIENER_MIN_CTAS), 16)
    nb = -(-sh // band)
    per = nx * nb
    job = np.repeat(np.arange(len(J)), per)
    k = np.arange(len(job)) - np.repeat(np.cumsum(per) - per, per)
    r0 = (k % nb[job]) * band
    head = np.stack([job, (k // nb[job]) * cw, r0,
                     np.minimum(band, sh[job] - r0)], 1)
    return np.concatenate([head, J[job]], 1).astype(np.int32)


def check_chunks(jobs, chunks, sgr: bool = False) -> None:
    """Raise unless ``chunks`` is a chunk table the Wiener kernel
    (``sgr``: the self-guided kernel) takes for the job rows ``jobs``:
    every row names a job, a chunk's first column (a multiple of
    WIENER_CW, SGR_CW, inside the unit) and a band of at least one output
    row inside the stripe (for the self-guided kernel at most SGR_SB rows
    starting on an even unit row), carries its job's row, and the rows
    cover every output pixel of every unit once (the kernels trap on a row
    outside its unit, an odd self-guided start or a longer band)."""
    J = np.asarray(jobs, dtype=np.int64).reshape(-1, JOB_COLS)
    C = np.asarray(chunks, dtype=np.int64)
    cw = SGR_CW if sgr else WIENER_CW
    if C.ndim != 2 or C.shape[1] != CHUNK_COLS:
        raise ValueError(f"chunks: shape {C.shape}, expected "
                         f"(n, {CHUNK_COLS})")
    job, cx, r0, nr = C[:, :C_ROW].T
    if len(C) and (job.min() < 0 or job.max() >= len(J)):
        raise ValueError("chunks: a job out of range")
    if (C[:, C_ROW:] != J[job]).any():
        raise ValueError("chunks: a job row that differs from the jobs")
    uw, sh = J[job, J_UW], J[job, J_SH]
    if ((cx < 0) | (cx >= uw) | (cx % cw != 0) | (r0 < 0) | (nr < 1)
            | (r0 + nr > sh)).any():
        raise ValueError("chunks: a chunk outside its unit")
    if sgr and (r0 % 2).any():
        raise ValueError("chunks: a self-guided band that starts on an odd "
                         "unit row")
    if sgr and (nr > SGR_SB).any():
        raise ValueError(f"chunks: a self-guided band of more than {SGR_SB} "
                         "rows")
    o = np.lexsort((r0, cx, job))
    same = (job[o][1:] == job[o][:-1]) & (cx[o][1:] == cx[o][:-1])
    if (same & (r0[o][1:] < (r0 + nr)[o][:-1])).any():
        raise ValueError("chunks: two bands overlap")
    need = (-(-J[:, J_UW] // cw) * J[:, J_SH]).sum()
    if nr.sum() != need:
        raise ValueError(f"chunks: {nr.sum()} chunk rows for {need}")


# ---- plain versions over batched padded units ----------------------------

def wiener_units_plain(P: torch.Tensor, fh: torch.Tensor, fv: torch.Tensor,
                       bitdepth: int) -> torch.Tensor:
    """(B, sh+6, uw+6) int32 padded units with per-unit (B, 3) half
    filters -> (B, sh, uw) int32 (ops/lr._jit_wiener)."""
    sh, uw = P.shape[1] - 6, P.shape[2] - 6
    rb_h = 5 if bitdepth == 12 else 3
    rb_v = 9 if bitdepth == 12 else 11

    def taps(f):
        mid = 128 - 2 * f.sum(1, dtype=torch.int32)
        return torch.stack([f[:, 0], f[:, 1], f[:, 2], mid, f[:, 2],
                            f[:, 1], f[:, 0]], 1)[:, :, None, None]

    wh, wv = taps(fh), taps(fv)
    mid = sum(wh[:, i] * P[:, :, i:i + uw] for i in range(7))
    mid = mid + (1 << (bitdepth + 6)) + (1 << (rb_h - 1))
    mid = torch.clamp(mid >> rb_h, 0, (1 << (bitdepth + 8 - rb_h)) - 1)
    out = sum(wv[:, k] * mid[:, k:k + sh] for k in range(7))
    out = (out - (1 << (bitdepth + rb_v - 1)) + (1 << (rb_v - 1))) >> rb_v
    return torch.clamp(out, 0, (1 << bitdepth) - 1)


def split_mul_shift(q, s, k, m):
    """(q * s + 2^(k-1)) >> k for q, s >= 0 without leaving int32: q is
    split at bit m (ops/lr._split_mul_shift, exact by
    floor((a 2^m + r) / 2^k) == floor((a + floor(r / 2^m)) / 2^(k-m)))."""
    q_hi = q >> m
    q_lo = q & ((1 << m) - 1)
    return (q_hi * s + ((q_lo * s + (1 << (k - 1))) >> m)) >> (k - m)


@functools.lru_cache(maxsize=None)
def _x_by_x(device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(tables.sgr_x_by_x),
                           dtype=torch.int32, device=device)


def _calc_ab(su, sq, s, n, one_by_x, bitdepth):
    """(A, B) of boxes of n pixels with sums su and square sums sq
    (reference sgr_calc_row_ab, src/looprestoration_tmpl.c:505-523), in
    int32 with the split multiply."""
    bdm8 = bitdepth - 8
    a = (sq + ((1 << (2 * bdm8)) >> 1)) >> (2 * bdm8)
    b = (su + ((1 << bdm8) >> 1)) >> bdm8
    p = torch.clamp(a * n - b * b, min=0)
    z = split_mul_shift(p, s[:, None, None], 20, 10)
    xv = _x_by_x(su.device)[torch.clamp(z, max=255).long()]
    return split_mul_shift(xv * su, one_by_x, 12, 12), xv


def sgr_units_plain(P, src, s0, s1, w0, w1, bitdepth, variant):
    """(B, sh+6, uw+6) int32 padded units, their (B, sh, uw) pixels and
    per-unit (B,) strengths and weights -> (B, sh, uw) int32
    (ops/lr._jit_sgr; variant 0 = 5x5, 1 = 3x3, 2 = both)."""
    sh, uw = P.shape[1] - 6, P.shape[2] - 6

    def box_h(r):  # (B, sh+6, uw+2): columns x = -1..uw
        cols = [P[:, :, 2 - r + i:2 - r + i + uw + 2]
                for i in range(2 * r + 1)]
        return sum(cols), sum(c * c for c in cols)

    def vsum(M, n):  # rows y = -1..sh of the n-row vertical sums
        return sum(M[:, i:i + sh + 2] for i in range(n))

    v = 0
    if variant != 1:  # 5x5 (A, B) at odd rows: 6/5 weights
        su, sq = box_h(2)
        A, B = _calc_ab(vsum(su, 5), vsum(sq, 5), s0, 25, 164, bitdepth)

        def six2(M):  # even rows j: rows j - 1 and j + 1
            u, d = M[:, 0:sh:2], M[:, 2:sh + 2:2]
            return (u[..., 1:-1] + d[..., 1:-1]) * 6 + \
                (u[..., :-2] + d[..., :-2] + u[..., 2:] + d[..., 2:]) * 5

        def six1(M):  # odd rows j: row j
            m = M[:, 2:sh + 1:2]
            return m[..., 1:-1] * 6 + (m[..., :-2] + m[..., 2:]) * 5

        t5 = torch.empty_like(src)
        t5[:, 0::2] = (six2(A) - six2(B) * src[:, 0::2] + (1 << 8)) >> 9
        t5[:, 1::2] = (six1(A) - six1(B) * src[:, 1::2] + (1 << 7)) >> 8
        v = v + w0[:, None, None] * t5
    if variant != 0:  # 3x3 (A, B) at every row: 4/3 weights
        su, sq = box_h(1)
        A, B = _calc_ab(vsum(su[:, 1:], 3), vsum(sq[:, 1:], 3), s1, 9,
                        455, bitdepth)

        def eight(M):
            u, c, d = M[:, 0:sh], M[:, 1:sh + 1], M[:, 2:sh + 2]
            return (c[..., 1:-1] + c[..., :-2] + c[..., 2:] + u[..., 1:-1]
                    + d[..., 1:-1]) * 4 + \
                (u[..., :-2] + d[..., :-2] + u[..., 2:] + d[..., 2:]) * 3

        t3 = (eight(A) - eight(B) * src + (1 << 8)) >> 9
        v = v + w1[:, None, None] * t3
    out = src + ((v + (1 << 10)) >> 11)
    return torch.clamp(out, 0, (1 << bitdepth) - 1)


# ---- plain group functions ------------------------------------------------

def _restore_plain(post, pre, jobs, bitdepth, out, sgr):
    """Every unit of ``jobs`` (grouped by geometry): padded windows
    gathered from concat(post, pre) at lr_apply._pad_unit_indices, the
    unit filters, the rectangles written into ``out``."""
    H, W = post.shape
    dev = post.device
    out = post.clone() if out is None else out
    J = jobs.cpu().numpy().astype(np.int64)
    S = torch.cat([post, pre])
    cols = [J_UW, J_SH] + ([J_P + 4] if sgr else [])
    for key in {tuple(r) for r in J[:, cols].tolist()}:
        g = J[(J[:, cols] == key).all(1)]
        uw, sh = key[:2]
        idx = [_pad_unit_indices(x, y, uw, sh, h, e, W, H)
               for x, y, e, h in g[:, [J_X, J_Y, J_EDGES, J_H]]]
        rows = torch.from_numpy(np.stack([r for r, _ in idx])).long().to(dev)
        cidx = torch.from_numpy(np.stack([c for _, c in idx])).long().to(dev)
        P = S[rows[:, :, None], cidx[:, None, :]]
        prm = torch.from_numpy(g[:, J_P:J_P + 6].astype(np.int32)).to(dev)
        if sgr:
            blk = sgr_units_plain(P, P[:, 3:3 + sh, 3:3 + uw], *prm[:, :4].T,
                                  bitdepth, key[2])
        else:
            blk = wiener_units_plain(P, prm[:, :3], prm[:, 3:], bitdepth)
        ys = torch.from_numpy(g[:, J_Y]).to(dev)
        xs = torch.from_numpy(g[:, J_X]).to(dev)
        yg = ys[:, None, None] + torch.arange(sh, device=dev)[None, :, None]
        xg = xs[:, None, None] + torch.arange(uw, device=dev)[None, None, :]
        out[yg, xg] = blk
    return out


def wiener_plain(post, pre, jobs, bitdepth, out=None):
    """The plain version of :func:`wiener`."""
    return _restore_plain(post, pre, jobs, bitdepth, out, False)


def sgr_plain(post, pre, jobs, bitdepth, out=None):
    """The plain version of :func:`sgr`."""
    return _restore_plain(post, pre, jobs, bitdepth, out, True)


# ---- wrappers -------------------------------------------------------------

def _restore(post, pre, jobs, bitdepth, out, sgr, chunks):
    H, W = post.shape
    build.check(post, "post")
    build.check(pre, "pre", (H, W))
    build.check(jobs, "jobs")
    if jobs.dim() != 2 or jobs.shape[1] != JOB_COLS:
        raise ValueError(f"jobs: shape {tuple(jobs.shape)}, expected "
                         f"(n, {JOB_COLS})")
    if bitdepth not in (8, 10, 12):
        raise ValueError(f"bitdepth {bitdepth}")
    if out is not None:
        build.check(out, "out", (H, W))
        if out.data_ptr() in (post.data_ptr(), pre.data_ptr()):
            raise ValueError("out aliases an input plane")
    ts = (post, pre, jobs) + ((out,) if out is not None else ()) + \
        ((chunks,) if chunks is not None else ())
    if chunks is not None:
        build.check(chunks, "chunks")
        if chunks.data_ptr() % 16:
            raise ValueError("chunks: not 16-byte aligned")
    if not build.on_cuda(*ts):
        if chunks is not None:
            check_chunks(jobs.numpy(), chunks.numpy(), sgr)
        return _restore_plain(post, pre, jobs, bitdepth, out, sgr)
    if chunks is None:
        raise ValueError(f"{'sgr' if sgr else 'wiener'} on CUDA tensors "
                         "needs the chunk table (chunks=)")
    out = post.clone() if out is None else out
    if not jobs.shape[0]:
        return out
    tag, cfn = (("lr_sgr", build.lib().dtpu_lr_sgr) if sgr else
                ("lr_wiener", build.lib().dtpu_lr_wiener))
    with torch.cuda.device(post.device):
        devrt.launch(tag, cfn, post.data_ptr(), pre.data_ptr(),
                     out.data_ptr(), H, W, chunks.data_ptr(),
                     chunks.shape[0], int(bitdepth), build.stream(post),
                     keep=(chunks,))
    return out


def wiener(post: torch.Tensor, pre: torch.Tensor, jobs: torch.Tensor,
           bitdepth: int, out: torch.Tensor | None = None,
           chunks: torch.Tensor | None = None) -> torch.Tensor:
    """The Wiener units ``jobs`` ((n, JOB_COLS) int32, :func:`job_tables`)
    of the (H, W) int32 post-CDEF plane ``post`` with the pre-CDEF
    snapshot ``pre``, written into ``out`` (default: a clone of
    ``post``), which is returned.  ``chunks``: the kernel's schedule,
    :func:`chunk_table` of the same job rows, as an int32 tensor; the
    caller holds it against the jobs with :func:`check_chunks` before
    the upload (recon/device_chain._lr does), since the kernel cannot:
    a table that misses a band leaves ``post``'s pixels there.  CPU
    tensors run the plain version (after :func:`check_chunks` when
    ``chunks`` is given, which it need not be); CUDA tensors launch
    ``csrc/lr.cu`` and need ``chunks``."""
    return _restore(post, pre, jobs, bitdepth, out, False, chunks)


def sgr(post: torch.Tensor, pre: torch.Tensor, jobs: torch.Tensor,
        bitdepth: int, out: torch.Tensor | None = None,
        chunks: torch.Tensor | None = None) -> torch.Tensor:
    """The self-guided units ``jobs``, as :func:`wiener` takes them;
    ``chunks``: ``chunk_table(jobs, sgr=True)`` (checked with
    ``check_chunks(..., sgr=True)``)."""
    return _restore(post, pre, jobs, bitdepth, out, True, chunks)
