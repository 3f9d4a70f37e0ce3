"""Loop restoration, host tier (counterpart of
dav1d_tpu/recon/lr_apply.lr_frame without its device and mesh
branches).

The reference's ``lr_frame`` consults its dispatch, which imports jax
and runs the Wiener/self-guided batches as jax programs on an
accelerator.  The port's LR is not ported to the device yet, so it
always filters on the host, stripe by stripe, through the reference's
``_lr_plane_sbrow`` (reference dav1d_lr_sbrow, src/lr_apply_tmpl.c).
"""

from __future__ import annotations

from dav1d_tpu.recon.lr_apply import _lr_plane_sbrow


def lr_frame(f) -> None:
    """Apply loop restoration to the whole frame, after CDEF and
    super-res: reads ``f.sr_planes`` (post-CDEF + super-res) and
    ``f.pre_cdef`` (the deblocked stripe-boundary rows), writes
    ``f.sr_planes``."""
    if not f.restore_planes:
        return
    hdr = f.frame_hdr
    # with no sink the stripe filters run on the host, in place
    f._lr_geom_sink = f._lr_wiener_sink = f._lr_sgr_sink = None
    src_planes = [p.copy() for p in f.sr_planes]
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
            _lr_plane_sbrow(f, pl, src_planes[pl], y_stripe, w, h, row_h,
                            ss_ver, ss_hor)
