"""Device-resident in-loop filter chain on torch tensors (counterpart of
dav1d_tpu/recon/device_chain.filter_chain_device).

The reconstructed planes are uploaded once per frame in their narrow
storage dtype and widened to int32 on the device; every stage runs on
the resident tensors, in the reference order:

1. deblock (all vertical edges, then all horizontal edges, per plane);
2. with loop restoration on, the post-deblock planes are kept as the
   pre-CDEF snapshot (the reference's lpf line buffer, dav1d_copy_lpf,
   src/lf_apply_tmpl.c:104): a reference, not a copy, since deblock and
   CDEF return new tensors;
3. CDEF (direction search on the resident luma, then the filter per
   plane);
4. super-res (ops/resize.py) of the planes and of the snapshot, in one
   launch, into allocation-sized planes of the upscaled width;
5. loop restoration (ops/lr.py): the stripe geometry from
   recon/lr_apply.lr_frame(f, geom_sink=), one Wiener and one
   self-guided launch per plane (each over its chunk table), into new
   planes.

The result is downloaded once, narrow: into ``f.planes``, or with
super-res into new ``f.sr_planes`` (int32, allocation-sized, zero beyond
the upscaled width), leaving ``f.planes`` at the coded width.  Reference
flow: dav1d_loopfilter_sbrow_* -> dav1d_cdef_brow -> resize ->
dav1d_lr_sbrow (src/lf_apply_tmpl.c:313, src/cdef_apply_tmpl.c:40,
src/recon_tmpl.c:2053, src/lr_apply_tmpl.c:108); the equivalence of
the full-frame formulation is argued in dav1d_tpu/recon/lf.py and
recon/cdef.py.

The frame's final planes stay on the device as ``f._dev_planes`` (int32,
allocation-sized), which the decoder binds into the reference slots the
frame refreshes: the MC of later frames reads them there
(pipeline._launch_mc_device; reference recon/device_chain.py:319-323).
Where no stage runs, the host planes are the final ones and go up as
they are.
With a mesh (``f.mesh``, mesh.Mesh: Settings.mesh), deblock and CDEF run
as row bands of the resident planes (recon/mesh_lf.py,
recon/mesh_cdef.py) and the restoration units are dealt in shares, one
a band (:func:`_lr_mesh`); super-res stays on the mesh's first device,
which holds the planes between stages.
Nothing here catches a device failure: an error in a kernel raises out
of the decode.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import devrt, state
from ..decode.frame import superres_geometry
from ..headers import PixelLayout
from ..ops import cdef as ocdef
from ..ops import lf as olf
from ..ops import lr as olr
from ..ops import resize as oresize
from .cdef import cdef_collect
from .lf import _collect_edges, _fix_tile_boundaries
from .lr_apply import lr_frame
from .mesh_cdef import dir_maps_mesh, filter_plane_mesh
from .mesh_lf import deblock_plane_mesh


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

    mesh = getattr(f, "mesh", None)
    for pl in [0] + ([1, 2] if do_uv else []):
        if mesh is not None:
            dev[pl] = deblock_plane_mesh(
                mesh, dev[pl], edges(pl, 0), edges(pl, 1),
                (f.bh * 4) >> (f.ss_ver if pl else 0), f.bitdepth, pl == 0)
            continue
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
    mesh = getattr(f, "mesh", None)
    if mesh is not None:
        # the direction search per luma band (recon/mesh_cdef.py)
        maps = dir_maps_mesh(mesh, dev[0], f.bh * 4, f.bitdepth,
                             bool(((y_pri | uv_pri) > 0).any()))
    elif ((y_pri | uv_pri) > 0).any():
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
        if mesh is not None:
            dev[pl] = filter_plane_mesh(
                mesh, dev[pl], maps, ph, pw, uys, uxs, w, h, pri, sec,
                damping - (1 if pl else 0), f.bitdepth, pl == 0,
                f.layout == PixelLayout.I422)
            continue
        # CDEF reads unfiltered neighbours: the filter writes a new plane
        dev[pl] = ocdef.cdef_filter_plane_resident(
            dev[pl], dmap, vmap, ph, pw, uys, uxs, w, h, pri, sec,
            damping - (1 if pl else 0), f.bitdepth, pl == 0,
            f.layout == PixelLayout.I422)


def _resize(f, planes):
    """Super-res of the resident planes (the frame's, then the snapshot's
    when loop restoration keeps one) in one launch, in the allocation
    geometry of decode/frame.superres_geometry (reference
    recon/device_chain.py _resize_resident)."""
    n = len(f.planes)
    return devrt.call("resize", oresize.resize_planes, planes,
                      [superres_geometry(f, k % n) for k in
                       range(len(planes))], f.bitdepth)


def _lr(f, dev, pre):
    """Loop restoration of the resident planes from the post-CDEF planes
    ``dev`` and the snapshot ``pre`` (reference recon/device_chain.py
    _lr_resident): per plane, the Wiener units and then the self-guided
    units, written into one new plane.  The job rows and the two
    kernels' chunk tables go up in one copy."""
    geom = {}
    lr_frame(f, geom_sink=geom)
    dev = list(dev)
    mesh = getattr(f, "mesh", None)
    for pl in range(len(dev)):
        wj, sj = olr.job_tables(geom, pl)
        if not (len(wj) or len(sj)):
            continue
        devrt.COUNTS["lr_wiener_units"] += len(wj)
        devrt.COUNTS["lr_sgr_units"] += len(sj)
        if mesh is not None:
            dev[pl] = _lr_mesh(f, mesh, dev[pl], pre[pl], wj, sj)
            continue
        wc, sc = olr.chunk_table(wj), olr.chunk_table(sj, sgr=True)
        olr.check_chunks(wj, wc)
        olr.check_chunks(sj, sc, sgr=True)
        n = wj.size + sj.size
        table = devrt.upload(np.concatenate([wj.ravel(), sj.ravel(),
                                             wc.ravel(), sc.ravel()]),
                             dev[pl].device)
        jobs = table[:n].view(-1, olr.JOB_COLS)
        chunks = table[n:].view(-1, olr.CHUNK_COLS)
        out = None
        if len(wj):
            out = devrt.call("lr_wiener", olr.wiener, dev[pl], pre[pl],
                             jobs[:len(wj)], f.bitdepth,
                             chunks=chunks[:len(wc)])
        if len(sj):
            out = devrt.call("lr_sgr", olr.sgr, dev[pl], pre[pl],
                             jobs[len(wj):], f.bitdepth, out=out,
                             chunks=chunks[len(wc):])
        dev[pl] = out
    return dev


def _rect_index(jobs: torch.Tensor, n_px: int, W: int) -> torch.Tensor:
    """Flat indices into an (H, W) plane of the ``n_px`` pixels of the
    restoration units ``jobs`` ((n, JOB_COLS) int32 rows on a device),
    unit by unit, row-major within a unit."""
    J = jobs.long()
    x, y, uw = J[:, olr.J_X], J[:, olr.J_Y], J[:, olr.J_UW]
    size = uw * J[:, olr.J_SH]
    job = torch.repeat_interleave(torch.arange(len(J), device=J.device),
                                  size, output_size=n_px)
    k = torch.arange(n_px, device=J.device) - (torch.cumsum(size, 0)
                                               - size)[job]
    return (y[job] + k // uw[job]) * W + x[job] + k % uw[job]


def _lr_mesh(f, mesh, post, pre, wj, sj):
    """One plane's restoration with a mesh: the Wiener and the self-guided
    job rows dealt in contiguous shares, one a band (each table's chunk
    table made from its share's rows, so its rules hold: self-guided
    bands of 16 rows on even unit rows), each share restored on its
    band's device from its copies of ``post`` and ``pre`` into a plane
    of its own; the mesh's first device takes each unit's rectangle from
    the share that restored it (Mesh.fetch; all-gathered across ranks in
    the process-group form), at indices made from the job rows
    (reference unit-batch sharding, dav1d_tpu/ops/lr.py:49-80)."""
    W = post.shape[1]
    dealt = list(zip(np.array_split(wj, mesh.n), np.array_split(sj, mesh.n)))
    shares, rows = [], []
    for a, b in dealt:
        wc, sc = olr.chunk_table(a), olr.chunk_table(b, sgr=True)
        olr.check_chunks(a, wc)
        olr.check_chunks(b, sc, sgr=True)
        shares.append((len(a), len(b), len(wc), len(sc),
                       int((a[:, olr.J_UW] * a[:, olr.J_SH]).sum()
                           + (b[:, olr.J_UW] * b[:, olr.J_SH]).sum())))
        rows.append(np.concatenate([a.ravel(), b.ravel(), wc.ravel(),
                                    sc.ravel()]))
    # rows of whole 16-byte groups: every share's chunk table aligned
    batch = np.zeros((mesh.n, -(-max(len(r) for r in rows) // 4) * 4),
                     np.int32)
    for k, r in enumerate(rows):
        batch[k, :len(r)] = r
    parts = []
    for k, row in zip(mesh.local, mesh.put(batch)):
        nw, ns, nwc, nsc, px = shares[k]
        if not px:
            parts.append(row.new_zeros(0))
            continue
        dv = mesh.device_of(k)
        post_k, pre_k = post.to(dv), pre.to(dv)
        nj = (nw + ns) * olr.JOB_COLS
        jobs = row[:nj].view(-1, olr.JOB_COLS)
        chunks = row[nj:nj + (nwc + nsc) * olr.CHUNK_COLS].view(
            -1, olr.CHUNK_COLS)
        out = None
        if nw:
            devrt.COUNTS["mesh_lr_wiener_shares"] += 1
            out = devrt.call("lr_wiener", olr.wiener, post_k, pre_k,
                             jobs[:nw], f.bitdepth, chunks=chunks[:nwc])
        if ns:
            devrt.COUNTS["mesh_lr_sgr_shares"] += 1
            out = devrt.call("lr_sgr", olr.sgr, post_k, pre_k, jobs[nw:],
                             f.bitdepth, out=out, chunks=chunks[nwc:])
        parts.append(out.view(-1)[_rect_index(jobs, px, W)])
    vals = mesh.fetch(parts, sizes=[s[4] for s in shares])
    every = devrt.upload(np.concatenate([t for a, b in dealt
                                         for t in (a, b)]), post.device)
    res = post.clone()
    res.view(-1)[_rect_index(every, sum(s[4] for s in shares), W)] = vals
    return res


def filter_chain_device(f, device) -> None:
    """The frame's in-loop filter chain on ``device``-resident planes:
    deblock -> CDEF -> super-res -> loop restoration (the planes go up
    only when one of them is on).  Leaves the final planes resident as
    ``f._dev_planes`` when the frame refreshes a reference slot."""
    hdr = f.frame_hdr
    seq = f.seq_hdr
    lf = hdr.loopfilter
    do_deblock = (lf.level_y[0] or lf.level_y[1]) \
        and (f.inloop_filters & 1)
    do_cdef = seq.cdef and not hdr.allow_intrabc and not hdr.all_lossless \
        and (any(hdr.cdef.y_strength) or any(hdr.cdef.uv_strength)) \
        and (f.inloop_filters & 2)
    do_lr = f.restore_planes and (f.inloop_filters & 4)
    do_resize = hdr.width[0] != hdr.width[1]

    f.sr_planes = f.planes
    f._dev_planes = None
    if not (do_deblock or do_cdef or do_resize or do_lr):
        if hdr.refresh_frame_flags:
            # the host planes are final
            with devrt.span("chain.upload_final"):
                f._dev_planes = state.upload_planes(f.planes, f.bitdepth,
                                                    device)
        return
    with devrt.span("chain.upload"):
        dev = state.upload_planes(f.planes, f.bitdepth, device)
    if do_deblock:
        with devrt.span("chain.deblock"):
            _deblock(f, dev)
    # the snapshot holds references: deblock and CDEF write new tensors
    pre = list(dev) if do_lr else None
    if do_cdef:
        with devrt.span("chain.cdef"):
            _cdef(f, dev)
    if do_resize:
        with devrt.span("chain.resize"):
            out = _resize(f, dev + (pre or []))
            dev, pre = out[:len(dev)], (None if pre is None
                                        else out[len(dev):])
    if do_lr:
        with devrt.span("chain.lr"):
            dev = _lr(f, dev, pre)
    # download in the narrow storage dtype: every stage clips into
    # [0, 2^bd), so the cast is exact (the first download waits for the
    # chain's kernels)
    cast = devrt.narrow_cast(f.bitdepth)
    with devrt.span("chain.download"):
        if do_resize:
            f.sr_planes = [devrt.fetch(cast(p)).astype(np.int32)
                           for p in dev]
        else:
            for pl in range(len(f.planes)):
                f.planes[pl][:, :] = devrt.fetch(cast(dev[pl]))
    if hdr.refresh_frame_flags:
        f._dev_planes = dev
