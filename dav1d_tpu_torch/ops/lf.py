"""Deblocking on device tensors (counterpart of dav1d_tpu/ops/pallas_lf.py).

A plane is deblocked in two passes, all vertical edges first, then all
horizontal edges — the reference's cols->rows order
(src/lf_apply_tmpl.c:313-466).  Within a pass no edge reads another
edge's writes (recon/lf.py module docstring), so every edge of a pass
reads the pass's input plane and the pass writes a copy.

* :func:`cellmap` packs a pass's edges on the host, in numpy, into a
  ((H+3)//4, (W+3)//4) int32 map of E | I<<8 | H<<16 | cls<<24 per 4x4
  cell (the edge on the cell's left side for a vertical pass, on its top
  side for a horizontal pass; 0 = no edge).
* :func:`deblock_plain` is the plain PyTorch pass: it gathers the 14
  taps of every edge line, evaluates the class-masked decision lattice
  of pallas_lf._core and scatters the changed pixels.
* :func:`deblock` is the wrapper: the plain version for CPU tensors, the
  CUDA kernel ``csrc/deblock.cu`` for CUDA tensors.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import devrt
from ..kernels import build

LUMA_CLASSES = ((1, 4), (2, 8), (3, 16))
CHROMA_CLASSES = ((1, 4), (2, 6))


def cellmap(edges, H: int, W: int) -> np.ndarray:
    """Pack one pass's edges into the per-cell parameter map.

    edges: (ys, xs, E, I, H, cls) numpy arrays in 4x4-cell coordinates
    (recon/lf._collect_edges plus the E/I/H lookups in f.lf_lim_lut), or
    None.  Counterpart of pallas_lf.deblock_plane_pallas's cellmap."""
    m = np.zeros(((H + 3) >> 2, (W + 3) >> 2), np.int32)
    if edges is None or len(edges[0]) == 0:
        return m
    ys, xs, E, I, Hl, cls = edges
    m[ys, xs] = (E.astype(np.int64) | (I.astype(np.int64) << 8)
                 | (Hl.astype(np.int64) << 16)
                 | (cls.astype(np.int64) << 24)).astype(np.int32)
    return m


def _core(tap, P, classes, bitdepth):
    """The multi-width filter decision at every edge line, as in
    pallas_lf._core: tap(o) is the pixel at signed offset o from the edge
    (o < 0: p side).  Returns {offset: (cond, value)}; the conds at one
    offset are mutually exclusive."""
    bd_m8 = bitdepth - 8
    Fl = 1 << bd_m8
    maxp = (1 << bitdepth) - 1
    cd_lim = 128 << bd_m8
    wds = {wd for _, wd in classes}
    E = (P & 255) << bd_m8
    I = ((P >> 8) & 255) << bd_m8
    H = ((P >> 16) & 255) << bd_m8
    cls = P >> 24
    oh = {wd: cls == idx for idx, wd in classes}
    a = torch.abs

    p1, p0, q0, q1 = tap(-2), tap(-1), tap(0), tap(1)
    fm = ((a(p1 - p0) <= I) & (a(q1 - q0) <= I)
          & (2 * a(p0 - q0) + (a(p1 - q1) >> 1) <= E))

    out = {}

    def emit(o, cond, val):
        if o in out:
            pc, pv = out[o]
            out[o] = (pc | cond, torch.where(cond, val, pv))
        else:
            out[o] = (cond, val)

    narrow = oh[4] & fm
    if wds & {6, 8, 16}:
        p2, q2 = tap(-3), tap(2)
        fm2 = fm & (a(p2 - p1) <= I) & (a(q2 - q1) <= I)
        f8_6 = ((a(p2 - p0) <= Fl) & (a(p1 - p0) <= Fl)
                & (a(q1 - q0) <= Fl) & (a(q2 - q0) <= Fl))
    if wds & {8, 16}:
        p3, q3 = tap(-4), tap(3)
        fm3 = fm2 & (a(p3 - p2) <= I) & (a(q3 - q2) <= I)
        f8_8 = f8_6 & (a(p3 - p0) <= Fl) & (a(q3 - q0) <= Fl)

    if 6 in wds:
        m6 = oh[6] & fm2
        mid6 = m6 & f8_6
        narrow = narrow | (m6 & ~f8_6)
        emit(-2, mid6, (3 * p2 + 2 * p1 + 2 * p0 + q0 + 4) >> 3)
        emit(-1, mid6, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3)
        emit(0, mid6, (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3)
        emit(1, mid6, (p0 + 2 * q0 + 2 * q1 + 3 * q2 + 4) >> 3)

    mid8 = None
    if 8 in wds:
        m8 = oh[8] & fm3
        mid8 = m8 & f8_8
        narrow = narrow | (m8 & ~f8_8)
    if 16 in wds:
        m16 = oh[16] & fm3
        p6, p5, p4 = tap(-7), tap(-6), tap(-5)
        q4, q5, q6 = tap(4), tap(5), tap(6)
        f8out = ((a(p6 - p0) <= Fl) & (a(p5 - p0) <= Fl)
                 & (a(p4 - p0) <= Fl) & (a(q4 - q0) <= Fl)
                 & (a(q5 - q0) <= Fl) & (a(q6 - q0) <= Fl))
        big = m16 & f8_8 & f8out
        mid16 = m16 & f8_8 & ~f8out
        narrow = narrow | (m16 & ~f8_8)
        mid8 = mid16 if mid8 is None else (mid8 | mid16)
        emit(-6, big, (7 * p6 + 2 * p5 + 2 * p4 + p3 + p2 + p1 + p0 + q0
                       + 8) >> 4)
        emit(-5, big, (5 * p6 + 2 * p5 + 2 * p4 + 2 * p3 + p2 + p1 + p0
                       + q0 + q1 + 8) >> 4)
        emit(-4, big, (4 * p6 + p5 + 2 * p4 + 2 * p3 + 2 * p2 + p1 + p0
                       + q0 + q1 + q2 + 8) >> 4)
        emit(-3, big, (3 * p6 + p5 + p4 + 2 * p3 + 2 * p2 + 2 * p1 + p0
                       + q0 + q1 + q2 + q3 + 8) >> 4)
        emit(-2, big, (2 * p6 + p5 + p4 + p3 + 2 * p2 + 2 * p1 + 2 * p0
                       + q0 + q1 + q2 + q3 + q4 + 8) >> 4)
        emit(-1, big, (p6 + p5 + p4 + p3 + p2 + 2 * p1 + 2 * p0 + 2 * q0
                       + q1 + q2 + q3 + q4 + q5 + 8) >> 4)
        emit(0, big, (p5 + p4 + p3 + p2 + p1 + 2 * p0 + 2 * q0 + 2 * q1
                      + q2 + q3 + q4 + q5 + q6 + 8) >> 4)
        emit(1, big, (p4 + p3 + p2 + p1 + p0 + 2 * q0 + 2 * q1 + 2 * q2
                      + q3 + q4 + q5 + 2 * q6 + 8) >> 4)
        emit(2, big, (p3 + p2 + p1 + p0 + q0 + 2 * q1 + 2 * q2 + 2 * q3
                      + q4 + q5 + 3 * q6 + 8) >> 4)
        emit(3, big, (p2 + p1 + p0 + q0 + q1 + 2 * q2 + 2 * q3 + 2 * q4
                      + q5 + 4 * q6 + 8) >> 4)
        emit(4, big, (p1 + p0 + q0 + q1 + q2 + 2 * q3 + 2 * q4 + 2 * q5
                      + 5 * q6 + 8) >> 4)
        emit(5, big, (p0 + q0 + q1 + q2 + q3 + 2 * q4 + 2 * q5 + 7 * q6
                      + 8) >> 4)
    if mid8 is not None:
        emit(-3, mid8, (3 * p3 + 2 * p2 + p1 + p0 + q0 + 4) >> 3)
        emit(-2, mid8, (2 * p3 + p2 + 2 * p1 + p0 + q0 + q1 + 4) >> 3)
        emit(-1, mid8, (p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2 + 4) >> 3)
        emit(0, mid8, (p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3 + 4) >> 3)
        emit(1, mid8, (p1 + p0 + q0 + 2 * q1 + q2 + 2 * q3 + 4) >> 3)
        emit(2, mid8, (p0 + q0 + q1 + 2 * q2 + 3 * q3 + 4) >> 3)

    # narrow 4-tap core: every class falls back here when flatness fails
    def iclip_diff(v):
        return torch.clamp(v, -cd_lim, cd_lim - 1)

    hev = (a(p1 - p0) > H) | (a(q1 - q0) > H)
    d30 = 3 * (q0 - p0)
    fv = torch.where(hev, iclip_diff(d30 + iclip_diff(p1 - q1)),
                     iclip_diff(d30))
    f1 = torch.clamp(fv + 4, max=cd_lim - 1) >> 3
    f2 = torch.clamp(fv + 3, max=cd_lim - 1) >> 3
    emit(-1, narrow, torch.clamp(p0 + f2, 0, maxp))
    emit(0, narrow, torch.clamp(q0 - f1, 0, maxp))
    nh = narrow & ~hev
    fo = (f1 + 1) >> 1
    emit(-2, nh, torch.clamp(p1 + fo, 0, maxp))
    emit(1, nh, torch.clamp(q1 - fo, 0, maxp))
    return out


def deblock_plain(src: torch.Tensor, cells: torch.Tensor, vertical: bool,
                  bitdepth: int, luma: bool) -> torch.Tensor:
    """One deblock pass in plain PyTorch: returns a copy of ``src``
    (H, W) int32 with every edge of ``cells`` filtered; taps outside the
    plane read 0."""
    H, W = src.shape
    cy, cx = torch.nonzero(cells, as_tuple=True)
    P = cells[cy, cx].repeat_interleave(4)
    line = torch.arange(4, device=src.device).repeat(cy.numel())
    if vertical:  # edge at column 4*cx, rows 4*cy + line
        ys = cy.repeat_interleave(4) * 4 + line
        xs = cx.repeat_interleave(4) * 4
    else:         # edge at row 4*cy, columns 4*cx + line
        ys = cy.repeat_interleave(4) * 4
        xs = cx.repeat_interleave(4) * 4 + line
    keep = (ys < H) & (xs < W)
    ys, xs, P = ys[keep], xs[keep], P[keep]
    canvas = F.pad(src, (8, 8, 8, 8))  # zero taps outside the plane

    def pos(o):
        return (ys, xs + o) if vertical else (ys + o, xs)

    def tap(o):
        y, x = pos(o)
        return canvas[y + 8, x + 8]

    classes = LUMA_CLASSES if luma else CHROMA_CLASSES
    dst = src.clone()
    for o, (cond, val) in sorted(_core(tap, P, classes, bitdepth).items()):
        y, x = pos(o)
        m = cond & (y >= 0) & (y < H) & (x >= 0) & (x < W)
        dst[y[m], x[m]] = val[m]
    return dst


def deblock(src: torch.Tensor, cells: torch.Tensor, vertical: bool,
            bitdepth: int, luma: bool) -> torch.Tensor:
    """One deblock pass (see :func:`deblock_plain`).  CPU tensors run the
    plain version; CUDA tensors launch ``csrc/deblock.cu``."""
    H, W = src.shape
    build.check(src, "plane")
    build.check(cells, "cells", ((H + 3) >> 2, (W + 3) >> 2))
    if bitdepth not in (8, 10, 12):
        raise ValueError(f"bitdepth {bitdepth}")
    if not build.on_cuda(src, cells):
        return deblock_plain(src, cells, vertical, bitdepth, luma)
    dst = torch.empty_like(src)
    # one kernel, two TPU counterparts (pallas_lf _build_v / _build_h):
    # the launches count per direction
    tag = "deblock_v" if vertical else "deblock_h"
    with torch.cuda.device(src.device):
        devrt.launch(tag, build.lib().dtpu_deblock, src.data_ptr(),
                     dst.data_ptr(), cells.data_ptr(), H, W, int(vertical),
                     int(bitdepth), int(luma), build.stream(src))
    return dst


def deblock_plane(plane: torch.Tensor, v_edges, h_edges, bitdepth: int,
                  luma: bool) -> torch.Tensor:
    """Both deblock passes of one resident plane (counterpart of
    pallas_lf.deblock_plane_pallas): v_edges / h_edges as for
    :func:`cellmap`, or None.  Returns the deblocked plane."""
    H, W = plane.shape
    for vertical, edges in ((True, v_edges), (False, h_edges)):
        if edges is None or len(edges[0]) == 0:
            continue
        cells = devrt.upload(cellmap(edges, H, W), plane.device)
        plane = devrt.call("deblock", deblock, plane, cells, vertical,
                           bitdepth, luma)
    return plane
