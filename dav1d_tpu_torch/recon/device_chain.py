"""Device-resident in-loop filter chain on torch tensors (counterpart of
dav1d_tpu/recon/device_chain.filter_chain_device).

The reconstructed planes are uploaded once per frame in their narrow
storage dtype and widened to int32 on the device; deblock (all vertical
edges, then all horizontal edges, per plane) and CDEF (direction search
on the resident luma, then the filter per plane) run on the resident
tensors; the result is downloaded once, narrow, into ``f.planes``.
Reference flow: dav1d_loopfilter_sbrow_* -> dav1d_cdef_brow
(src/lf_apply_tmpl.c:313, src/cdef_apply_tmpl.c:40); the equivalence of
the full-frame formulation is argued in dav1d_tpu/recon/lf.py and
recon/cdef.py.

Super-res and loop restoration are not ported to the device yet: for a
frame that uses them the post-deblock planes come down as ``f.pre_cdef``
and the host forms (decode/frame._superres_frame, recon/lr_apply.lr_frame)
finish the chain, in the order of the reference's host chain
(dav1d_tpu/decode/frame.decode_frame_finish).

The frame's final planes stay on the device as ``f._dev_planes`` (int32,
allocation-sized), which the decoder binds into the reference slots the
frame refreshes: the MC of later frames reads them there
(pipeline._launch_mc_device; reference recon/device_chain.py:319-323).
They equal the host's final planes pixel for pixel: where a host stage
changed the planes after the download (super-res, loop restoration), or
where the chain did not run (neither deblock nor CDEF), the final host
planes go up instead.
Nothing here catches a device failure: an error in a kernel raises out
of the decode.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import devrt, state
from ..decode.frame import _superres_frame
from ..headers import PixelLayout
from ..ops import cdef as ocdef
from ..ops import lf as olf
from .cdef import cdef_collect
from .lf import _collect_edges, _fix_tile_boundaries
from .lr_apply import lr_frame


def _deblock(f, dev):
    hdr = f.frame_hdr
    lf = hdr.loopfilter
    if hdr.tiling.cols > 1 or hdr.tiling.rows > 1:
        _fix_tile_boundaries(f)
    e_lut, i_lut = f.lf_lim_lut
    level = f.lf_level
    ch4 = (f.h4 + f.ss_ver) >> f.ss_ver
    cw4 = (f.w4 + f.ss_hor) >> f.ss_hor
    do_uv = f.layout != PixelLayout.I400 and (lf.level_u or lf.level_v)

    def edges(pl, dir_):
        wd_plane = f.lf_wd_y[dir_] if pl == 0 else f.lf_wd_uv[dir_]
        pd_idx = dir_ if pl == 0 else 1 + pl
        n_rows, n_cols = (f.h4, f.w4) if pl == 0 else (ch4, cw4)
        ys, xs, cls, L = _collect_edges(level, wd_plane, pd_idx, dir_,
                                        n_rows, n_cols)
        if ys.size == 0:
            return None
        return ys, xs, e_lut[L].astype(np.int64), \
            i_lut[L].astype(np.int64), L >> 4, cls

    for pl in [0] + ([1, 2] if do_uv else []):
        dev[pl] = olf.deblock_plane(dev[pl], edges(pl, 0), edges(pl, 1),
                                    f.bitdepth, pl == 0)


def _cdef(f, dev):
    units = cdef_collect(f)
    if units is None:
        return
    hdr = f.frame_hdr
    bys, bxs, y_pri, y_sec, uv_pri, uv_sec, uvlvl = units
    damping = hdr.cdef.damping + f.bitdepth - 8
    ss_ver = int(f.layout == PixelLayout.I420)
    ss_hor = int(f.layout != PixelLayout.I444)
    has_chroma = f.layout != PixelLayout.I400
    if ((y_pri | uv_pri) > 0).any():
        dmap, vmap = devrt.call("cdef_dir", ocdef.find_dir_maps, dev[0],
                                f.bitdepth)
    else:
        dmap = torch.zeros((dev[0].shape[0] // 8, dev[0].shape[1] // 8),
                           dtype=torch.int32, device=dev[0].device)
        vmap = dmap
    for pl in range(3 if has_chroma else 1):
        if pl == 0:
            # superset of the host selection: units whose derived
            # strengths are both zero pass through in the filter
            m = (y_pri | y_sec) != 0
            pri, sec = y_pri[m], y_sec[m]
            uys, uxs = bys[m] * 4, bxs[m] * 4
            sv = sh = 0
        else:
            m = uvlvl != 0
            pri, sec = uv_pri[m], uv_sec[m]
            uys = (bys[m] * 4) >> ss_ver
            uxs = (bxs[m] * 4) >> ss_hor
            sv, sh = ss_ver, ss_hor
        if not m.any():
            continue
        w, h = 8 >> sh, 8 >> sv
        pw, ph = (f.bw * 4) >> sh, (f.bh * 4) >> sv
        # CDEF reads unfiltered neighbours: the filter writes a new plane
        dev[pl] = ocdef.cdef_filter_plane_resident(
            dev[pl], dmap, vmap, ph, pw, uys, uxs, w, h, pri, sec,
            damping - (1 if pl else 0), f.bitdepth, pl == 0,
            f.layout == PixelLayout.I422)


def filter_chain_device(f, device) -> None:
    """The frame's in-loop filter chain: deblock -> CDEF on
    ``device``-resident planes (the planes go up only when one of them
    is on), then super-res and loop restoration on the host.  Leaves the
    final planes resident as ``f._dev_planes`` when the frame refreshes
    a reference slot."""
    hdr = f.frame_hdr
    seq = f.seq_hdr
    lf = hdr.loopfilter
    do_deblock = (lf.level_y[0] or lf.level_y[1]) \
        and (f.inloop_filters & 1)
    do_cdef = seq.cdef and not hdr.allow_intrabc and not hdr.all_lossless \
        and (any(hdr.cdef.y_strength) or any(hdr.cdef.uv_strength)) \
        and (f.inloop_filters & 2)
    do_lr = f.restore_planes and (f.inloop_filters & 4)

    f.pre_cdef = None
    dev = None
    if do_deblock or do_cdef:
        with devrt.span("chain.upload"):
            dev = state.upload_planes(f.planes, f.bitdepth, device)
        if do_deblock:
            with devrt.span("chain.deblock"):
                _deblock(f, dev)
        cast = devrt.narrow_cast(f.bitdepth)
        if do_lr:
            # post-deblock / pre-CDEF snapshot for the LR stripe reads
            # (reference dav1d_copy_lpf, src/lf_apply_tmpl.c:104): the
            # whole buffer, padding included
            f.pre_cdef = [devrt.fetch(cast(p)).astype(np.int32)
                          for p in dev]
        if do_cdef:
            with devrt.span("chain.cdef"):
                _cdef(f, dev)
        # download in the narrow storage dtype: every stage clips into
        # [0, 2^bd), so the cast is exact (the first download waits for
        # the chain's kernels)
        with devrt.span("chain.download"):
            for pl in range(len(f.planes)):
                f.planes[pl][:, :] = devrt.fetch(cast(dev[pl]))
    elif do_lr:
        f.pre_cdef = [p.copy() for p in f.planes]

    f.sr_planes = f.planes
    if hdr.width[0] != hdr.width[1]:
        f.sr_planes = _superres_frame(f, f.planes)
        if f.pre_cdef is not None:
            f.pre_cdef = _superres_frame(f, f.pre_cdef)
    if do_lr:
        lr_frame(f)

    f._dev_planes = None
    if hdr.refresh_frame_flags:
        if dev is None or f.sr_planes is not f.planes or do_lr:
            # the device planes are not the final ones (or there are
            # none): the final host planes go up
            with devrt.span("chain.upload_final"):
                dev = state.upload_planes(f.sr_planes, f.bitdepth, device)
        f._dev_planes = dev
