"""Loop restoration: the stripe/unit geometry of a frame.

Behavioral parity with reference src/lr_apply_tmpl.c (lr_sbrow :108,
lr_stripe :36): which stripe units of which planes are filtered, with
which filter, and the padded window each unit reads, here as gather
indices (:func:`_pad_unit_indices`):

  * interior = post-CDEF pixels of the unit (out-of-place reads make the
    reference's 4-px "left" backup unnecessary)
  * 3 rows above/below a stripe come from the *deblocked pre-CDEF* frame
    (the reference's lpf line buffer, dav1d_copy_lpf src/lf_apply_tmpl.c:104)
    as [A1, A1, A2] / [B1, B2, B2], clamped at most 2 rows outside the
    stripe (AV1 spec 7.17)
  * absent edges replicate the outermost row/column.

The filters themselves (reference src/looprestoration_tmpl.c wiener_c
:250, sgr_3x3_c :679, sgr_5x5_c :825, sgr_mix_c :1040) run in ops/lr.py
on the resident planes (recon/device_chain.py).
"""

from __future__ import annotations

import numpy as np

from .. import tables
from ..headers import RestorationType as RT

LR_HAVE_LEFT = 1
LR_HAVE_RIGHT = 2
LR_HAVE_TOP = 4
LR_HAVE_BOTTOM = 8


def lr_frame(f, geom_sink: dict) -> None:
    """Collect the frame's loop-restoration stripe units (reference
    dav1d_lr_sbrow per sbrow, after CDEF and super-res) into
    ``geom_sink``, per (kind, unit_w, stripe_h[, variant]) group: for
    Wiener ("w") the items (plane, x, y, edges, h, filter_h, filter_v),
    for self-guided ("s") (plane, x, y, edges, h, s0, s1, w0, w1).  No
    pixels are touched: the device chain (recon/device_chain) gathers
    the padded units from the resident planes."""
    if not f.restore_planes:
        return
    hdr = f.frame_hdr
    for pl in range(3):
        if not ((f.restore_planes >> pl) & 1):
            continue
        ss_ver = int(bool(pl)) and f.ss_ver
        ss_hor = int(bool(pl)) and f.ss_hor
        h = (hdr.height + ss_ver) >> ss_ver
        w = ((hdr.width[1]) + ss_hor) >> ss_hor
        shift = (6 - ss_ver) + f.seq_hdr.sb128
        for sby in range(f.sbh):
            not_last = sby + 1 < f.sbh
            next_row_y = (sby + 1) << shift
            row_h = min(next_row_y - (8 >> ss_ver) * not_last, h)
            offset = (8 >> ss_ver) * (sby != 0)
            y_stripe = (sby << shift) - offset
            _lr_plane_sbrow(f, geom_sink, pl, y_stripe, w, h, row_h,
                            ss_ver, ss_hor)


def _lr_plane_sbrow(f, geom, pl, y, w, h, row_h, ss_ver, ss_hor) -> None:
    """reference lr_sbrow (src/lr_apply_tmpl.c:108-166)."""
    hdr = f.frame_hdr
    unit_size_log2 = hdr.restoration.unit_size[int(bool(pl))]
    unit_size = 1 << unit_size_log2
    half_unit = unit_size >> 1
    max_unit_size = unit_size + half_unit
    row_y = y + (8 >> ss_ver) * (y != 0)
    shift_hor = 7 - ss_hor

    edges = (LR_HAVE_TOP if y > 0 else 0) | LR_HAVE_RIGHT

    aligned_unit_pos = row_y & ~(unit_size - 1)
    if aligned_unit_pos and aligned_unit_pos + half_unit > h:
        aligned_unit_pos -= unit_size
    aligned_unit_pos <<= ss_ver
    sb_idx_base = (aligned_unit_pos >> 7) * f.sr_sb128w
    unit_idx0 = ((aligned_unit_pos >> 6) & 1) << 1

    # full units while >= 1.5 units remain; the final unit extends to the
    # frame edge (reference lr_sbrow :145-164)
    xs = []
    x = 0
    while x + max_unit_size <= w:
        xs.append((x, unit_size))
        x += unit_size
    xs.append((x, w - x))
    for x, unit_w in xs:
        e = edges | (LR_HAVE_LEFT if x > 0 else 0)
        if x + unit_w >= w:
            e &= ~LR_HAVE_RIGHT
        u_idx = unit_idx0 + ((x >> (shift_hor - 1)) & 1)
        lr = f.lr_units.get((sb_idx_base + (x >> shift_hor), pl, u_idx))
        if lr is not None and lr["type"] != RT.NONE:
            _lr_stripes(f, geom, pl, x, y, unit_w, row_h, lr, e, ss_ver, h)


def _lr_stripes(f, geom, pl, x, y, unit_w, row_h, lr, edges, ss_ver,
                h) -> None:
    """reference lr_stripe (src/lr_apply_tmpl.c:36-100): one item per
    stripe of the unit column."""
    sb128 = f.seq_hdr.sb128
    stripe_h = min((64 - 8 * (y == 0)) >> ss_ver, row_h - y)
    ty = lr["type"]
    # the sbrow this stripe run belongs to -- loop-invariant (reference
    # lr_stripe computes it once from the starting y)
    sby = (y + ((8 << ss_ver) if y else 0)) >> ((6 - ss_ver) + sb128)
    if ty == RT.WIENER:
        params = (lr["filter_h"], lr["filter_v"])
    else:
        sgr_idx = lr["type"] - int(RT.SGRPROJ)
        s0 = int(tables.sgr_params[sgr_idx][0])
        s1 = int(tables.sgr_params[sgr_idx][1])
        w0 = lr["sgr_weights"][0]
        w1 = 128 - (lr["sgr_weights"][0] + lr["sgr_weights"][1])
        variant = 2 if (s0 and s1) else (0 if s0 else 1)
        params = (s0, s1, w0, w1)

    while y + stripe_h <= row_h:
        have_bottom = sby + 1 != f.sbh or y + stripe_h != row_h
        e = (edges & ~LR_HAVE_BOTTOM) | (LR_HAVE_BOTTOM if have_bottom
                                         else 0)
        key = ("w", unit_w, stripe_h) if ty == RT.WIENER else \
            ("s", unit_w, stripe_h, variant)
        geom.setdefault(key, []).append((pl, x, y, e, h, *params))
        y += stripe_h
        edges |= LR_HAVE_TOP
        stripe_h = min(64 >> ss_ver, row_h - y)
        if stripe_h == 0:
            break


def _pad_unit_indices(x0, y0, unit_w, stripe_h, h, edges, W, H):
    """The padded (stripe_h+6, unit_w+6) window of a stripe unit as gather
    indices: the source is S = concat(post-CDEF plane, pre-CDEF plane)
    (2H rows); returns (rows (stripe_h+6,), cols (unit_w+6,)) with
    P = S[rows][:, cols]."""
    cols = np.arange(x0 - 3, x0 + unit_w + 3)
    if not (edges & LR_HAVE_LEFT):
        cols = np.maximum(cols, x0)
    if not (edges & LR_HAVE_RIGHT):
        cols = np.minimum(cols, x0 + unit_w - 1)
    cols = np.clip(cols, 0, W - 1)
    rows = np.empty(stripe_h + 6, dtype=np.int64)
    rows[3 : 3 + stripe_h] = np.arange(y0, y0 + stripe_h)
    if edges & LR_HAVE_TOP:
        rows[0] = rows[1] = H + y0 - 2
        rows[2] = H + y0 - 1
    else:
        rows[0:3] = y0
    if edges & LR_HAVE_BOTTOM:
        rows[3 + stripe_h] = H + y0 + stripe_h
        rows[4 + stripe_h] = rows[5 + stripe_h] = \
            H + min(y0 + stripe_h + 1, h - 1)
    else:
        rows[3 + stripe_h :] = y0 + stripe_h - 1
    return rows.astype(np.int32), cols.astype(np.int32)
