"""Film grain synthesis and application.

Behavioral parity with reference src/filmgrain_tmpl.c (generate_grain_y :50,
generate_grain_uv :89, fgy/fguv_32x32xn :170-404) and src/fg_apply_tmpl.c
(generate_scaling :41, prep/apply :100-241); AV1 spec 7.18.3.
Grain is an output-stage operation: reference pictures stay grain-free.

The grain LUTs (the autoregressive synthesis, a short serial recurrence)
and the scaling LUTs are made on the host by the native C (native/fg.c).
The decoder's path is :func:`apply_grain`: each plane with grain in one
launch of the film-grain kernel (ops/fg.py, csrc/fg.cu) on the decoder's
device, or its plain PyTorch version on the CPU.  :func:`_apply_grain_native`
is the host tier (the whole pass in C, in place), which the tests hold
the device path against.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import devrt, state, tables
from ..headers import PixelLayout
from ..ops import fg as ofg


def _fg_cdata(data):
    """Build the ctypes mirror of FilmGrainData for the native tier."""
    from ..native import CFgData

    c = CFgData()
    c.seed = data.seed
    c.num_y_points = data.num_y_points
    c.chroma_scaling_from_luma = data.chroma_scaling_from_luma
    c.scaling_shift = data.scaling_shift
    c.ar_coeff_lag = data.ar_coeff_lag
    c.ar_coeff_shift = data.ar_coeff_shift
    c.grain_scale_shift = data.grain_scale_shift
    c.overlap_flag = data.overlap_flag
    c.clip_to_restricted_range = data.clip_to_restricted_range
    for i in range(2):
        c.num_uv_points[i] = data.num_uv_points[i]
        c.uv_mult[i] = data.uv_mult[i]
        c.uv_luma_mult[i] = data.uv_luma_mult[i]
        c.uv_offset[i] = data.uv_offset[i]
    for i, (px, py) in enumerate(data.y_points):
        c.y_points[i][0], c.y_points[i][1] = px, py
    for uv in range(2):
        for i, (px, py) in enumerate(data.uv_points[uv]):
            c.uv_points[uv][i][0], c.uv_points[uv][i][1] = px, py
        for i, v in enumerate(data.ar_coeffs_uv[uv]):
            c.ar_coeffs_uv[uv][i] = v
    for i, v in enumerate(data.ar_coeffs_y):
        c.ar_coeffs_y[i] = v
    return c


def _geometry(pic):
    ss_y = int(pic.layout == PixelLayout.I420)
    ss_x = int(pic.layout != PixelLayout.I444)
    return ss_x, ss_y, pic.layout != PixelLayout.I400


def _scaling(lib, bitdepth, points, num):
    sc = np.zeros(1 << bitdepth, dtype=np.int32)
    pts = np.asarray(points, dtype=np.uint8).reshape(-1)
    lib.dtpu_fg_scaling(bitdepth, pts.ctypes.data if pts.size else None,
                        num, sc.ctypes.data)
    return sc


def grain_tables(pic):
    """The native C's (c_data, {plane: (grain LUT (74, 82) int32, scaling
    LUT (1 << bd,) int32)}) of every plane of ``pic`` that gets grain;
    chroma_scaling_from_luma planes share the luma scaling LUT."""
    from ..native import lib

    data = pic.frame_hdr.film_grain.data
    bd = pic.bitdepth
    ss_x, ss_y, has_chroma = _geometry(pic)
    c = _fg_cdata(data)
    gauss = np.ascontiguousarray(tables.gaussian_sequence, dtype=np.int16)
    lut_y = np.zeros((ofg.LUT_ROWS, ofg.GRAIN_W), dtype=np.int32)
    lib.dtpu_fg_gen_y(ctypes.byref(c), gauss.ctypes.data, bd,
                      lut_y.ctypes.data)
    sc_y = _scaling(lib, bd, data.y_points, data.num_y_points)
    out = {}
    if data.num_y_points:
        out[0] = (lut_y, sc_y)
    for uv in range(2 if has_chroma else 0):
        csfl = data.chroma_scaling_from_luma
        if not (data.num_uv_points[uv] or csfl):
            continue
        lut = np.zeros_like(lut_y)
        lib.dtpu_fg_gen_uv(ctypes.byref(c), gauss.ctypes.data,
                           lut_y.ctypes.data, uv, ss_x, ss_y, bd,
                           lut.ctypes.data)
        sc = sc_y if csfl else _scaling(lib, bd, data.uv_points[uv],
                                        data.num_uv_points[uv])
        out[1 + uv] = (lut, sc)
    return c, out


def plane_params(pic):
    """{plane: ops/fg.PlaneParams} of the planes of ``pic`` that get grain
    (the clip range: restricted, with the identity matrix's 235 for
    chroma, or full)."""
    data = pic.frame_hdr.film_grain.data
    bd = pic.bitdepth
    ss_x, ss_y, _ = _geometry(pic)
    is_id = pic.seq_hdr.mtrx == 0  # MC_IDENTITY
    if data.clip_to_restricted_range:
        minv = 16 << (bd - 8)
        maxv = [235 << (bd - 8), (235 if is_id else 240) << (bd - 8)]
    else:
        minv, maxv = 0, [(1 << bd) - 1] * 2
    out = {}
    for pl in (0, 1, 2):
        uv = pl - 1
        out[pl] = ofg.PlaneParams(
            pl=pl, ss_x=ss_x if pl else 0, ss_y=ss_y if pl else 0,
            bitdepth=bd, scaling_shift=data.scaling_shift, minv=minv,
            maxv=maxv[bool(pl)], overlap=int(bool(data.overlap_flag)),
            csfl=int(bool(pl and data.chroma_scaling_from_luma)),
            uv_mult=data.uv_mult[uv] if pl else 0,
            uv_luma_mult=data.uv_luma_mult[uv] if pl else 0,
            uv_offset=data.uv_offset[uv] if pl else 0)
    return out


def _apply_grain_native(pic) -> None:
    """The host tier: the native whole-frame grain pass (fg.c), in place
    on ``pic.planes``: chroma first so it scales off pristine luma, then
    luma."""
    from ..native import lib

    c, planes = grain_tables(pic)
    ss_x, ss_y, _ = _geometry(pic)
    w, h = pic.width, pic.height
    is_id = int(pic.seq_hdr.mtrx == 0)
    luma = pic.planes[0]
    for pl in sorted(planes, reverse=True):
        lut, sc = planes[pl]
        plane = pic.planes[pl]
        sx, sy = (ss_x, ss_y) if pl else (0, 0)
        if not lib.dtpu_fg_apply_plane(
                plane.ctypes.data, plane.shape[1],
                luma.ctypes.data if pl else None, luma.shape[1] if pl else 0,
                w, pl, (w + sx) >> sx, (h + sy) >> sy, sx, sy,
                lut.ctypes.data, sc.ctypes.data, ctypes.byref(c),
                pic.bitdepth, is_id):
            raise MemoryError("film grain scratch allocation")


def apply_grain(pic, device, dev_planes=None) -> None:
    """Film grain of an output Picture on ``device`` (reference
    dav1d_apply_grain, src/fg_apply_tmpl.c:225-241): one launch of the
    film-grain kernel per plane that gets grain (ops/fg.apply_plane; its
    plain version on the CPU), reading the picture's pixels from
    ``dev_planes`` (the frame's final planes resident on ``device``,
    int32, allocation-sized) when given, else from ``pic.planes``,
    uploaded.  The grained planes are new tensors: they come down into
    ``pic.planes`` (which must be the picture's own writable copies), and
    the resident planes, the frame's reference pixels, stay grain-free.
    The tables go up in one copy; every transfer is counted in
    devrt.XFER, and the grain stage's work in devrt.COUNTS:
    ``grain.pictures``, ``grain.planes``, ``grain.resident`` (pictures
    read from ``dev_planes``, with no plane upload), ``grain.up_bytes``
    (the tables and any planes) and ``grain.down_bytes``."""
    with devrt.span("grain.tables"):
        _, planes = grain_tables(pic)
        if not planes:
            return
        prm = plane_params(pic)
        ss_x, ss_y, _ = _geometry(pic)
        w, h = pic.width, pic.height
        n_rows = -(-h // ofg.FG_BLOCK)
        n_blocks = -(-w // ofg.FG_BLOCK)
        data = pic.frame_hdr.film_grain.data
        offs = ofg.row_offsets(data.seed, data.overlap_flag, n_rows,
                               n_blocks)
        order = sorted(planes)
        host = np.concatenate([offs.ravel()] + [
            np.concatenate([planes[pl][0].ravel(), planes[pl][1]])
            for pl in order])
    counts = devrt.COUNTS
    counts["grain.pictures"] += 1
    counts["grain.planes"] += len(order)
    up = host.nbytes
    with devrt.span("grain.upload"):
        t = devrt.upload(host, device)
        if dev_planes is None:
            # luma always: chroma planes read it for their index
            need = sorted(set(order) | {0})
            dev_planes = dict(zip(need, state.upload_planes(
                [pic.planes[pl] for pl in need], pic.bitdepth, device)))
            up += sum(pic.planes[pl].size for pl in need) * (
                1 if pic.bitdepth == 8 else 2)
        else:
            counts["grain.resident"] += 1
    counts["grain.up_bytes"] += up
    dtab = t[offs.size:]
    offs_t = t[:offs.size].view(offs.shape)
    nlut, nsc = ofg.LUT_ROWS * ofg.GRAIN_W, 1 << pic.bitdepth
    cast = devrt.narrow_cast(pic.bitdepth)
    outs = {}
    with devrt.span("grain.apply"):
        for i, pl in enumerate(order):
            base = i * (nlut + nsc)
            lut = dtab[base:base + nlut].view(ofg.LUT_ROWS, ofg.GRAIN_W)
            sc = dtab[base + nlut:base + nlut + nsc]
            sx, sy = (ss_x, ss_y) if pl else (0, 0)
            outs[pl] = devrt.call(
                "fg", ofg.apply_plane, dev_planes[pl], dev_planes[0], lut,
                sc, offs_t, (w + sx) >> sx, (h + sy) >> sy, w, prm[pl])
    with devrt.span("grain.download"):
        for pl, o in outs.items():
            down = devrt.fetch(cast(o))
            pic.planes[pl][...] = down
            counts["grain.down_bytes"] += down.nbytes
