"""Intra prediction units on device tensors (counterpart of
dav1d_tpu/ops/ipred.py and of the unit programs of
dav1d_tpu/recon/device_intra.py: _unit_program :230, _multi_run_program
:260, _cfl_program :320, _pal_program :406).

Every wavefront level of a chain (luma, or the two chroma planes
stacked vertically, ``ph_unit`` rows each) runs in one launch of
``csrc/ipred.cu``, in place on the chain's resident int32 canvas:
:func:`walk` (kernel ``ipred_walk``) takes the chain's job rows sorted by
level and kind, a tag per unit (``level << 2 | kind``, the levels
numbered from 0) and the units of each level (:func:`check_walk`), and
its CTAs hand each level to the next through L2.  One level of one kind
also runs alone (the per-level kernels, the walk's arithmetic):

* :func:`pred_level` (kernel ``ipred``): per unit, the 257-entry edge
  vector gathered from the canvas (:func:`edges_plain`: the clamped-index
  rules of dav1d_tpu/recon/device_intra._edge_gather), the resolved mode's
  prediction (DC / DC_128 / TOP_DC / LEFT_DC / V / H / PAETH / SMOOTH /
  SMOOTH_V / SMOOTH_H; Z1 / Z2 / Z3 and FILTER with the unit's angle,
  edge filter and upsampling), the residual window added, clipped to
  [0, 2^bd), written back;
* :func:`cfl_level` (``ipred_cfl``): chroma-from-luma units, the AC from
  the finished luma canvas, the DC from the edges, alpha scaling;
* :func:`pal_level` (``ipred_pal``): palette units, ``pal[idx]``.

In place is legal because no unit reads a cell that a unit of its own
level writes (recon/device_intra._LevelMap).  A unit travels as one job
row of JOB_COLS int32 (columns below).  Edge layout as the reference's:
top-left at [OFS], the top row above it, the left column mirrored below
(left[i] = edge[OFS - 1 - i]).

The plain versions (the wrappers run them on CPU tensors) are batched
over the units of one (w, h) with per-unit mode, angle and flags, as
recon/device_intra._allmode_pred selects them, and follow the JAX
package's formulation (ops/ipred._build, _build_rt, _cfl_program,
_pal_program): static gather plans, per-unit filter strengths and
upsampling from tables over the angle delta.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import devrt, tables
from ..kernels import build
from ..levels import IntraPredMode as M
from ..recon.ipred import _EDGE_KERNELS, get_filter_strength, get_upsample

EDGE_LEN = 257
OFS = 128
# job row columns (csrc/ipred_core.cuh)
JOB_COLS = 16
J_DY, J_DX, J_W, J_H = 0, 1, 2, 3
# pred and cfl units: the edge availability (recon/device_intra._edge_meta)
J_HL, J_HT, J_PXL, J_PXBL, J_PXT, J_PXTR = 4, 5, 6, 7, 8, 9
# pred units: angle key (bit 9 smooth, bit 10 edge filter, low 9 bits the
# angle; FILTER: the filter index), Z2's clamped max_w / max_h, Z2's
# top-left filter flag, the resolved mode
J_AKEY, J_KMW, J_KMH, J_Z2F, J_MODE = 10, 11, 12, 13, 14
# cfl units: the luma origin, alpha, the right / bottom padding (4 px
# units) and the resolved DC mode (J_MODE)
J_Y0, J_X0, J_ALPHA, J_WPAD, J_HPAD = 10, 11, 12, 13, 15
# palette units: offset of the (h, w) index map in the index buffer, and
# the 8 palette colours
J_IDX, J_PAL = 4, 8
# walk tags: level << 2 | kind (csrc/ipred_core.cuh PRED, CFL, PAL)
KIND_PRED, KIND_CFL, KIND_PAL = 0, 1, 2


# ---- static plans (dav1d_tpu/ops/ipred.py:46-83) -------------------------

def _clamped(base, idx, frm, to):
    return base + np.clip(idx, frm, to - 1)


def _upsample_plan(hsz, inp0, base, frm, to):
    i = np.arange(hsz)
    even = inp0 + _clamped(base, i, frm, to)
    j = np.arange(hsz - 1)[:, None] + np.array([-1, 0, 1, 2])[None]
    conv = inp0 + _clamped(base, j, frm, to)
    return even, conv


def _filter_edge_plan(sz, lim_from, lim_to, inp0, base, frm, to):
    i = np.arange(sz)
    passthru = (i < min(sz, lim_from)) | (i >= min(lim_to, sz))
    j = i[:, None] - 2 + np.arange(5)[None]
    conv = inp0 + _clamped(base, j, frm, to)
    center = inp0 + _clamped(base, i, frm, to)
    return conv, center, passthru


@functools.lru_cache(maxsize=None)
def _str_ups_tables(n):
    """(2, 90) edge-filter strength and upsample flag over the angle
    delta, per smooth flag, for blocks with w + h = n."""
    st = np.zeros((2, 90), np.int64)
    ut = np.zeros((2, 90), np.int64)
    for sm in (0, 1):
        for da in range(90):
            st[sm, da] = get_filter_strength(n, da, sm)
            ut[sm, da] = get_upsample(n, da, sm)
    return st, ut


def _t(a, dev):
    return torch.as_tensor(np.ascontiguousarray(a), device=dev)


def _upsample(e, plan, maxp):
    even_idx, conv_idx = plan
    hsz = len(even_idx)
    N = e.shape[0]
    g = e[:, _t(conv_idx.reshape(-1), e.device)].reshape(N, hsz - 1, 4)
    k = torch.tensor([-1, 9, 9, -1], device=e.device)
    odd = (((g * k).sum(2) + 8) >> 4).clamp(0, maxp)
    out = torch.zeros((N, 2 * hsz - 1), dtype=e.dtype, device=e.device)
    out[:, 0::2] = e[:, _t(even_idx, e.device)]
    out[:, 1::2] = odd
    return out


def _filter_edge(e, plan, strength, lo=None, hi=None):
    """filter_edge with per-unit strength (N,) and pass-through limits:
    position i passes through where i < lo or i >= hi."""
    conv_idx, center_idx, passthru = plan
    sz = len(center_idx)
    N = e.shape[0]
    g = e[:, _t(conv_idx.reshape(-1), e.device)].reshape(N, sz, 5)
    k = _t(_EDGE_KERNELS, e.device)[(strength - 1).clamp(0, 2)]
    f = ((g * k[:, None, :]).sum(2) + 8) >> 4
    c = e[:, _t(center_idx, e.device)]
    i = torch.arange(sz, device=e.device)[None]
    pt = _t(passthru, e.device)[None].expand(N, sz)
    if lo is not None:
        pt = pt | (i < lo[:, None])
    if hi is not None:
        pt = pt | (i >= hi[:, None])
    return torch.where(pt, c, f)


def _dc_mul(dc, w, h, bitdepth):
    if w == h:
        return dc
    if w > h * 2 or h > w * 2:
        m8, m16 = 0x3334, 0x6667
    else:
        m8, m16 = 0x5556, 0xAAAB
    return (dc * m8) >> 16 if bitdepth == 8 else (dc * m16) >> 17


def _dc(e, mode, w, h, bitdepth):
    """(N,) DC value of each unit's resolved DC variant."""
    top = e[:, OFS + 1:OFS + 1 + w].sum(1)
    left = e[:, OFS - h:OFS].sum(1)
    if mode == M.DC_PRED:
        sh = ((w + h) & -(w + h)).bit_length() - 1
        return _dc_mul((((w + h) >> 1) + top + left) >> sh, w, h, bitdepth)
    if mode == M.TOP_DC_PRED:
        return (top + (w >> 1)) >> (w.bit_length() - 1)
    if mode == M.LEFT_DC_PRED:
        return (left + (h >> 1)) >> (h.bit_length() - 1)
    return torch.full_like(top, (1 << bitdepth) >> 1)


# ---- per-mode plain predictors over units of one (w, h) -------------------

def _static_mode(mode, e, w, h, bitdepth):
    N = e.shape[0]
    top = e[:, OFS + 1:OFS + 1 + w][:, None, :]
    left = e[:, OFS - h:OFS].flip(1)[:, :, None]
    if mode in (M.DC_PRED, M.TOP_DC_PRED, M.LEFT_DC_PRED, M.DC_128_PRED):
        return _dc(e, mode, w, h, bitdepth)[:, None, None].expand(N, h, w)
    if mode == M.VERT_PRED:
        return top.expand(N, h, w)
    if mode == M.HOR_PRED:
        return left.expand(N, h, w)
    if mode == M.PAETH_PRED:
        tl = e[:, OFS][:, None, None]
        base = left + top - tl
        ld, td, tld = (left - base).abs(), (top - base).abs(), \
            (tl - base).abs()
        return torch.where((ld <= td) & (ld <= tld), left,
                           torch.where(td <= tld, top, tl)).expand(N, h, w)
    sm = tables.sm_weights.astype(np.int64)
    wv = _t(sm[h:2 * h], e.device)[None, :, None]
    wh = _t(sm[w:2 * w], e.device)[None, None, :]
    right = e[:, OFS + w][:, None, None]
    bottom = e[:, OFS - h][:, None, None]
    if mode == M.SMOOTH_PRED:
        p = wv * top + (256 - wv) * bottom + wh * left + (256 - wh) * right
        return (p + 256) >> 9
    if mode == M.SMOOTH_V_PRED:
        return ((wv * top + (256 - wv) * bottom + 128) >> 8).expand(N, h, w)
    if mode == M.SMOOTH_H_PRED:
        return ((wh * left + (256 - wh) * right + 128) >> 8).expand(N, h, w)
    raise NotImplementedError(f"ipred mode {mode}")


def _drt(idx, dev):
    drt = _t(tables.dr_intra_derivative.astype(np.int64), dev)
    return drt[idx.clamp(0, drt.shape[0] - 1)]


def _z13(mode, e, akey, w, h, bitdepth):
    """Z1 / Z3 with per-unit angle key (ops/ipred._build_rt)."""
    N, dev = e.shape[0], e.device
    n = w + h
    st, ut = (_t(a, dev) for a in _str_ups_tables(n))
    if mode == M.Z1_PRED:
        inp0, base, frm, to = OFS, 1, -1, w + min(w, h)
    else:
        inp0, base, frm, to = OFS - n, 0, max(w - h, 0), n + 1
    fplan = _filter_edge_plan(n, 0, n, inp0, base, frm, to)
    can_ups = n <= 16
    ys, xs = np.mgrid[0:h, 0:w]
    step = _t((ys + 1) if mode == M.Z1_PRED else (xs + 1), dev)
    lane = _t(xs if mode == M.Z1_PRED else ys, dev)
    raw_max_base = (w if mode == M.Z1_PRED else h) + min(w, h) - 1
    is_sm, en_f, a = (akey >> 9) & 1, akey >> 10, akey & 511
    if mode == M.Z1_PRED:
        da, didx = 90 - a, a >> 1
    else:
        da, didx = a - 180, (270 - a) >> 1
    d = _drt(didx, dev)
    dac = da.clamp(0, 89)
    strg = torch.where(en_f > 0, st[is_sm, dac], 0)
    ups = torch.where(en_f > 0, ut[is_sm, dac], 0) if can_ups else \
        torch.zeros_like(a)
    strg = torch.where(ups > 0, 0, strg)
    raw = e[:, OFS + 1:OFS + 1 + n] if mode == M.Z1_PRED else \
        e[:, OFS - n:OFS]
    vec_n = torch.where(strg[:, None] > 0, _filter_edge(e, fplan, strg), raw)

    def zpath(vec, dd, binc, max_base, vec_top):
        pos = dd[:, None, None] * step[None]
        bidx = (pos >> 6) + binc * lane[None]
        frac = pos & 0x3E
        sat = bidx >= max_base
        b0 = torch.minimum(bidx, max_base)
        b1 = torch.minimum(bidx + 1, max_base)
        if mode == M.Z3_PRED:
            b0, b1 = vec_top - b0, vec_top - b1
            sv = vec_top - max_base
        else:
            sv = max_base
        g0 = vec.gather(1, b0.reshape(N, -1)).reshape(N, h, w)
        g1 = vec.gather(1, b1.reshape(N, -1)).reshape(N, h, w)
        v = (g0 * (64 - frac) + g1 * frac + 32) >> 6
        sva = torch.as_tensor(sv, device=dev).expand(N, 1, 1).reshape(N, 1)
        satv = vec.gather(1, sva)
        return torch.where(sat, satv[:, :, None], v)

    mb = torch.where(strg > 0, n - 1, raw_max_base)[:, None, None]
    vA = zpath(vec_n, d, 1, mb, n - 1)
    if can_ups:
        plan = _upsample_plan(n, inp0, base, frm, to)
        vB = zpath(_upsample(e, plan, (1 << bitdepth) - 1), d << 1, 2,
                   torch.tensor(2 * n - 2, device=dev), 2 * n - 2)
        return torch.where(ups[:, None, None] > 0, vB, vA)
    return vA


def _z2(e, akey, kmw, kmh, w, h, bitdepth):
    """Z2 with per-unit angle key and clamps (ops/ipred._build_rt)."""
    N, dev = e.shape[0], e.device
    TL = 64
    st, ut = (_t(a, dev) for a in _str_ups_tables(w + h))
    can_ups = w + h <= 16
    maxp = (1 << bitdepth) - 1
    is_sm, en_f, a = (akey >> 9) & 1, akey >> 10, akey & 511
    da_t, da_l = (a - 90).clamp(0, 89), (180 - a).clamp(0, 89)
    dy, dx = _drt((a - 90) >> 1, dev), _drt((180 - a) >> 1, dev)
    zero = torch.zeros_like(a)
    ups_a = torch.where(en_f > 0, ut[is_sm, da_t], 0) if can_ups else zero
    ups_l = torch.where(en_f > 0, ut[is_sm, da_l], 0) if can_ups else zero
    str_a = torch.where((en_f > 0) & (ups_a == 0), st[is_sm, da_t], 0)
    str_l = torch.where((en_f > 0) & (ups_l == 0), st[is_sm, da_l], 0)
    raw_t = e[:, OFS + 1:OFS + 1 + w]
    raw_l = e[:, OFS - h:OFS]
    filt_t = _filter_edge(e, _filter_edge_plan(w, 0, w, OFS, 1, -1, w),
                          str_a, hi=kmw.clamp(max=w))
    filt_l = _filter_edge(e, _filter_edge_plan(h, 0, h, OFS - h, 0, 0,
                                               h + 1), str_l, lo=h - kmh)
    nu_t = torch.where(str_a[:, None] > 0, filt_t, raw_t)
    nu_l = torch.where(str_l[:, None] > 0, filt_l, raw_l)
    buf = torch.zeros((N, 129), dtype=e.dtype, device=dev)
    if can_ups:
        up_t = _upsample(e, _upsample_plan(w + 1, OFS, 0, 0, w + 1), maxp)
        up_l = _upsample(e, _upsample_plan(h + 1, OFS - h, 0, 0, h + 1),
                         maxp)
        pad_t = torch.nn.functional.pad(nu_t, (0, w))
        pad_l = torch.nn.functional.pad(nu_l, (h, 0))
        buf[:, TL + 1:TL + 1 + 2 * w] = torch.where(ups_a[:, None] > 0,
                                                    up_t[:, 1:], pad_t)
        buf[:, TL - 2 * h:TL] = torch.where(ups_l[:, None] > 0,
                                            up_l[:, :2 * h], pad_l)
    else:
        buf[:, TL + 1:TL + 1 + w] = nu_t
        buf[:, TL - h:TL] = nu_l
    buf[:, TL] = e[:, OFS]
    ys, xs = (_t(m, dev)[None] for m in np.mgrid[0:h, 0:w])
    binc_x = (1 + ups_a)[:, None, None]
    left_base = (TL - 1 - ups_l)[:, None, None]
    dxe = (dx << ups_a)[:, None, None]
    dye = (dy << ups_l)[:, None, None]
    bx0 = (binc_x << 6) - dxe * (ys + 1)
    base_x = (bx0 >> 6) + binc_x * xs
    frac_x = bx0 & 0x3E
    ypos = (ys << 6) * (1 + ups_l)[:, None, None] - dye * (xs + 1)
    base_y = ypos >> 6
    frac_y = ypos & 0x3E

    def gat(idx):
        return buf.gather(1, idx.reshape(N, -1)).reshape(N, h, w)

    vt = (gat(TL + base_x.clamp(0, 64)) * (64 - frac_x)
          + gat(TL + (base_x + 1).clamp(0, 64)) * frac_x + 32) >> 6
    vl = (gat((left_base - base_y).clamp(0, 128)) * (64 - frac_y)
          + gat((left_base - base_y - 1).clamp(0, 128)) * frac_y + 32) >> 6
    return torch.where(base_x >= 0, vt, vl)


def _filter_intra(e, akey, w, h, bitdepth):
    """FILTER_PRED: 4x2 blocks, each from the 7 pixels above and to the
    left of it, row pair by row pair (ops/ipred._build_rt)."""
    N, dev = e.shape[0], e.device
    taps = _t(tables.filter_intra_taps.astype(np.int64).reshape(-1, 8, 8)
              [:, :7, :], dev)
    tm = taps[(akey & 511).clamp(0, taps.shape[0] - 1)]  # (N, 7, 8)
    maxp = (1 << bitdepth) - 1
    left = e[:, OFS - h:OFS].flip(1)
    prev = torch.cat([e[:, OFS:OFS + 1], e[:, OFS + 1:OFS + 1 + w]], 1)
    rows = []
    for y in range(0, h, 2):
        p5, p6 = left[:, y], left[:, y + 1]
        r1, r2 = [], []
        for x in range(0, w, 4):
            p = torch.cat([prev[:, x:x + 5], p5[:, None], p6[:, None]], 1)
            v = (((p[:, :, None] * tm).sum(1) + 8) >> 4).clamp(0, maxp)
            r1.append(v[:, :4])
            r2.append(v[:, 4:])
            p5, p6 = v[:, 3], v[:, 7]
        rows += [torch.cat(r1, 1), torch.cat(r2, 1)]
        prev = torch.cat([left[:, y + 1:y + 2], rows[-1]], 1)
    return torch.stack(rows, 1)


def predict_units(edges: torch.Tensor, jobs: torch.Tensor, w: int, h: int,
                  bitdepth: int) -> torch.Tensor:
    """(N, h, w) predictions of N units of one (w, h) from their (N, 257)
    edge vectors and their job rows' resolved mode, angle key and Z2
    clamps (recon/device_intra._allmode_pred)."""
    e = edges.long()
    J = jobs.long()
    out = torch.zeros((e.shape[0], h, w), dtype=torch.int64,
                      device=e.device)
    for mode in torch.unique(J[:, J_MODE]).tolist():
        sel = J[:, J_MODE] == mode
        es, akey = e[sel], J[sel, J_AKEY]
        if mode in (M.Z1_PRED, M.Z3_PRED):
            p = _z13(mode, es, akey, w, h, bitdepth)
        elif mode == M.Z2_PRED:
            p = _z2(es, akey, J[sel, J_KMW], J[sel, J_KMH], w, h, bitdepth)
        elif mode == M.FILTER_PRED:
            p = _filter_intra(es, akey, w, h, bitdepth)
        else:
            p = _static_mode(mode, es, w, h, bitdepth)
        out[sel] = p
    return out.to(torch.int32)


# ---- edges and levels -----------------------------------------------------

def edges_plain(canvas: torch.Tensor, jobs: torch.Tensor, ph_unit: int,
                bitdepth: int, z2f: bool = True) -> torch.Tensor:
    """(N, 257) int32 edge vectors of the units ``jobs`` gathered from the
    (H, W) canvas (recon/device_intra._edge_gather with every segment:
    replication is an index clamp, cross-side fills and constants are
    selects, rows clamp into the unit's own ``ph_unit``-row half of a
    stacked chroma canvas; segments a unit's mode does not read carry
    harmless values).  ``z2f``: apply the per-unit Z2 top-left filter
    flag (pred units)."""
    H, W = canvas.shape
    dev = canvas.device
    J = jobs.long()
    half = (1 << bitdepth) >> 1
    dy, dx, w, h = (J[:, c][:, None] for c in (J_DY, J_DX, J_W, J_H))
    have_l = J[:, J_HL][:, None] > 0
    have_t = J[:, J_HT][:, None] > 0
    row_lo = torch.where(dy >= ph_unit, ph_unit, 0)
    flat = canvas.reshape(-1).long()

    def rd(r, c):
        r = torch.minimum(torch.maximum(r, row_lo), row_lo + ph_unit - 1)
        return flat[(r * W + c.clamp(0, W - 1)).clamp(0, H * W - 1)]

    from_top, from_left = rd(dy - 1, dx), rd(dy, dx - 1)
    i = torch.arange(128, device=dev)[None]
    pxl, pxbl = J[:, J_PXL][:, None], J[:, J_PXBL][:, None]
    row = torch.where(i < h, dy + torch.minimum(i, pxl - 1),
                      torch.where(pxbl > 0,
                                  dy + h + torch.minimum(i - h, pxbl - 1),
                                  dy + pxl - 1))
    lv = torch.where(have_l, rd(row, dx - 1),
                     torch.where(have_t, from_top, half + 1))
    pxt, pxtr = J[:, J_PXT][:, None], J[:, J_PXTR][:, None]
    col = torch.where(i < w, dx + torch.minimum(i, pxt - 1),
                      torch.where(pxtr > 0,
                                  dx + w + torch.minimum(i - w, pxtr - 1),
                                  dx + pxt - 1))
    tv = torch.where(have_t, rd(dy - 1, col),
                     torch.where(have_l, from_left, half - 1))
    edges = torch.zeros((J.shape[0], EDGE_LEN), dtype=torch.int64,
                        device=dev)
    edges[:, :OFS] = torch.where(i < 2 * h, lv, 0).flip(1)
    edges[:, OFS + 1:] = torch.where(i < 2 * w, tv, 0)
    tl = torch.where(have_l, torch.where(have_t, rd(dy - 1, dx - 1),
                                         from_left),
                     torch.where(have_t, from_top, half))[:, 0]
    if z2f:
        tlf = ((edges[:, OFS - 1] + edges[:, OFS + 1]) * 5 + tl * 6 + 8) >> 4
        tl = torch.where(J[:, J_Z2F] > 0, tlf, tl)
    edges[:, OFS] = tl
    return edges.to(torch.int32)


def _window(J, W, w, h, dev):
    """(N, h, w) flat canvas indices of each unit's output window."""
    yy = torch.arange(h, device=dev)[None, :, None]
    xx = torch.arange(w, device=dev)[None, None, :]
    return (J[:, J_DY, None, None] + yy) * W + J[:, J_DX, None, None] + xx


def _groups(J, cols):
    """Row selections of ``J`` by the distinct values of ``cols``."""
    keys = J[:, cols]
    for key in torch.unique(keys, dim=0).tolist():
        yield key, (keys == torch.tensor(key, device=J.device)).all(1)


def _finish(canvas, resid, J, preds, bitdepth):
    """Add each unit's residual window to its prediction, clip, write
    (after every unit of the level read its edges)."""
    W = canvas.shape[1]
    flat, rflat = canvas.view(-1), resid.reshape(-1)
    for sel, w, h, pred in preds:
        idx = _window(J[sel], W, w, h, canvas.device)
        flat[idx] = (pred.long() + rflat[idx]).clamp(
            0, (1 << bitdepth) - 1).to(canvas.dtype)
    return canvas


def pred_level_plain(canvas, resid, jobs, ph_unit, bitdepth):
    """The plain version of :func:`pred_level`."""
    J = jobs.long()
    edges = edges_plain(canvas, jobs, ph_unit, bitdepth)
    preds = [(sel, w, h, predict_units(edges[sel], J[sel], w, h, bitdepth))
             for (w, h), sel in _groups(J, [J_W, J_H])]
    return _finish(canvas, resid, J, preds, bitdepth)


def cfl_ac_units(luma, jobs, w, h, w_pad, h_pad, ss_hor, ss_ver):
    """(N, h, w) AC of CFL units of one key from the finished int32 luma
    canvas (recon/device_intra._cfl_program; reference cfl_ac_c): the
    subsampled sums at each unit's luma origin, the right / bottom
    padding (4-pixel units) replicated, the rounded mean removed."""
    YH, YW = luma.shape
    J = jobs.long()
    yf = luma.reshape(-1).long()
    core_h, core_w = h - 4 * h_pad, w - 4 * w_pad
    sy = J[:, J_Y0, None, None] + (torch.arange(core_h, device=yf.device)
                                   [None, :, None] << ss_ver)
    sx = J[:, J_X0, None, None] + (torch.arange(core_w, device=yf.device)
                                   [None, None, :] << ss_hor)

    def yrd(r, c):
        return yf[r.clamp(0, YH - 1) * YW + c.clamp(0, YW - 1)]

    s = yrd(sy, sx)
    if ss_hor:
        s = s + yrd(sy, sx + 1)
    if ss_ver:
        s = s + yrd(sy + 1, sx)
        if ss_hor:
            s = s + yrd(sy + 1, sx + 1)
    ac = s << (1 + (not ss_ver) + (not ss_hor))
    if w_pad:
        ac = torch.cat([ac, ac[:, :, -1:].expand(-1, -1, 4 * w_pad)], 2)
    if h_pad:
        ac = torch.cat([ac, ac[:, -1:, :].expand(-1, 4 * h_pad, -1)], 1)
    log2sz = (w.bit_length() - 1) + (h.bit_length() - 1)
    mean = (ac.sum((1, 2)) + ((1 << log2sz) >> 1)) >> log2sz
    return (ac - mean[:, None, None]).to(torch.int32)


def cfl_pred_units(edges, ac, alpha, mode, w, h, bitdepth):
    """(N, h, w) CFL predictions (ops/ipred.cfl_pred_batch): the DC of
    the resolved mode from the (N, 257) edges, plus sign(alpha ac)
    round(|alpha ac| / 64), clipped."""
    dc = _dc(edges.long(), mode, w, h, bitdepth)[:, None, None]
    diff = alpha.long()[:, None, None] * ac.long()
    out = dc + torch.sign(diff) * ((diff.abs() + 32) >> 6)
    return out.clamp(0, (1 << bitdepth) - 1).to(torch.int32)


def cfl_level_plain(canvas, luma, resid, jobs, ph_unit, ss_hor, ss_ver,
                    bitdepth):
    """The plain version of :func:`cfl_level`."""
    J = jobs.long()
    edges = edges_plain(canvas, jobs, ph_unit, bitdepth, z2f=False)
    preds = []
    for (mode, w, h, wp, hp), sel in _groups(J, [J_MODE, J_W, J_H, J_WPAD,
                                                 J_HPAD]):
        ac = cfl_ac_units(luma, J[sel], w, h, wp, hp, ss_hor, ss_ver)
        preds.append((sel, w, h, cfl_pred_units(
            edges[sel], ac, J[sel, J_ALPHA], mode, w, h, bitdepth)))
    return _finish(canvas, resid, J, preds, bitdepth)


def pal_units(pal, idx):
    """(N, h, w) palette predictions: ``pal`` (N, 8) colours, ``idx``
    (N, h, w) indices (recon/device_intra._pal_program)."""
    N = idx.shape[0]
    return pal.long().gather(1, idx.long().reshape(N, -1)).reshape(
        idx.shape).to(torch.int32)


def pal_level_plain(canvas, resid, jobs, pidx, bitdepth):
    """The plain version of :func:`pal_level`."""
    J = jobs.long()
    preds = []
    for (w, h), sel in _groups(J, [J_W, J_H]):
        g = J[sel]
        off = g[:, J_IDX, None, None] + _window(
            torch.zeros_like(g), w, w, h, canvas.device)
        preds.append((sel, w, h, pal_units(g[:, J_PAL:J_PAL + 8],
                                           pidx.long()[off])))
    return _finish(canvas, resid, J, preds, bitdepth)


def walk_plain(canvas, luma, resid, jobs, tags, counts, pidx, ph_unit,
               ss_hor, ss_ver, bitdepth):
    """The plain version of :func:`walk`: level after level, each kind's
    units through its level step."""
    T = tags.cpu().numpy().astype(np.int64)
    ends = np.cumsum(counts.cpu().numpy().astype(np.int64))
    for e0, e1 in zip(np.concatenate([[0], ends[:-1]]), ends):
        kinds = T[e0:e1] & 3
        for kind in (KIND_PRED, KIND_CFL, KIND_PAL):
            sel = np.flatnonzero(kinds == kind)
            if not len(sel):
                continue
            J = jobs[e0 + int(sel[0]):e0 + int(sel[-1]) + 1]
            if kind == KIND_PRED:
                pred_level_plain(canvas, resid, J, ph_unit, bitdepth)
            elif kind == KIND_CFL:
                cfl_level_plain(canvas, luma, resid, J, ph_unit, ss_hor,
                                ss_ver, bitdepth)
            else:
                pal_level_plain(canvas, resid, J, pidx, bitdepth)
    return canvas


def check_walk(tags, counts, n) -> None:
    """Raise unless ``tags`` and ``counts`` are a walk table for ``n`` job
    rows: one tag each, kinds in 0..2, sorted by level and then kind,
    levels 0 .. len(counts) - 1 each holding its count (at least one)
    of the rows.  The kernel would wait forever on a level that never
    fills (and traps)."""
    t = np.asarray(tags, dtype=np.int64).reshape(-1)
    c = np.asarray(counts, dtype=np.int64).reshape(-1)
    if len(t) != n:
        raise ValueError(f"tags: {len(t)} tags for {n} jobs")
    if len(t) and (t.min() < 0 or (t & 3).max() > KIND_PAL):
        raise ValueError("tags: a kind outside 0..2")
    if (np.diff(t) < 0).any():
        raise ValueError("tags: not sorted by level, then kind")
    if c.sum() != n or (c < 1).any():
        raise ValueError(f"counts: {c.tolist()[:8]}... do not give each "
                         f"level a unit and sum to {n}")
    if not np.array_equal(np.repeat(np.arange(len(c)), c), t >> 2):
        raise ValueError("counts: the levels of the tags differ")


def walk_ctas(counts) -> int:
    """The most units that two consecutive levels of ``counts`` hold: the
    walk's CTAs beyond them would only wait."""
    c = np.asarray(counts, dtype=np.int64).reshape(-1)
    if len(c) < 2:
        return int(c.sum())
    return int((c[1:] + c[:-1]).max())


# ---- wrappers -------------------------------------------------------------

def _check(canvas, resid, jobs, bitdepth):
    build.check(canvas, "canvas")
    build.check(resid, "resid", tuple(canvas.shape))
    build.check(jobs, "jobs")
    if jobs.dim() != 2 or jobs.shape[1] != JOB_COLS:
        raise ValueError(f"jobs: shape {tuple(jobs.shape)}, expected "
                         f"(n, {JOB_COLS})")
    if bitdepth not in (8, 10, 12):
        raise ValueError(f"bitdepth {bitdepth}")


def pred_level(canvas: torch.Tensor, resid: torch.Tensor,
               jobs: torch.Tensor, ph_unit: int,
               bitdepth: int) -> torch.Tensor:
    """The prediction units ``jobs`` ((n, JOB_COLS) int32) of one
    wavefront level, in place on the (H, W) int32 ``canvas`` with the
    residual canvas ``resid`` (same shape); returns ``canvas``.  CPU
    tensors run :func:`pred_level_plain`; CUDA tensors launch
    ``csrc/ipred.cu``."""
    _check(canvas, resid, jobs, bitdepth)
    if not build.on_cuda(canvas, resid, jobs):
        return pred_level_plain(canvas, resid, jobs, ph_unit, bitdepth)
    if jobs.shape[0]:
        with torch.cuda.device(canvas.device):
            devrt.launch("ipred", build.lib().dtpu_ipred, canvas.data_ptr(),
                         resid.data_ptr(), canvas.shape[0], canvas.shape[1],
                         ph_unit, jobs.data_ptr(), jobs.shape[0],
                         int(bitdepth), build.stream(canvas),
                         keep=(canvas, resid, jobs))
    return canvas


def cfl_level(canvas: torch.Tensor, luma: torch.Tensor, resid: torch.Tensor,
              jobs: torch.Tensor, ph_unit: int, ss_hor: int, ss_ver: int,
              bitdepth: int) -> torch.Tensor:
    """The CFL units ``jobs`` of one level, in place on the chroma
    ``canvas``, their AC from the finished int32 ``luma`` canvas.  CPU
    tensors run :func:`cfl_level_plain`; CUDA tensors launch
    ``csrc/ipred.cu``."""
    _check(canvas, resid, jobs, bitdepth)
    build.check(luma, "luma")
    if not build.on_cuda(canvas, luma, resid, jobs):
        return cfl_level_plain(canvas, luma, resid, jobs, ph_unit, ss_hor,
                               ss_ver, bitdepth)
    if jobs.shape[0]:
        with torch.cuda.device(canvas.device):
            devrt.launch("ipred_cfl", build.lib().dtpu_ipred_cfl,
                         canvas.data_ptr(), luma.data_ptr(),
                         resid.data_ptr(), canvas.shape[0], canvas.shape[1],
                         ph_unit, luma.shape[0], luma.shape[1],
                         jobs.data_ptr(), jobs.shape[0], int(ss_hor),
                         int(ss_ver), int(bitdepth), build.stream(canvas),
                         keep=(canvas, luma, resid, jobs))
    return canvas


def pal_level(canvas: torch.Tensor, resid: torch.Tensor, jobs: torch.Tensor,
              pidx: torch.Tensor, bitdepth: int) -> torch.Tensor:
    """The palette units ``jobs`` of one level, in place on ``canvas``;
    ``pidx``: the frame's uint8 palette index buffer (each unit's (h, w)
    map at its J_IDX offset).  CPU tensors run :func:`pal_level_plain`;
    CUDA tensors launch ``csrc/ipred.cu``."""
    _check(canvas, resid, jobs, bitdepth)
    build.check(pidx, "pidx", dtype=torch.uint8)
    if not build.on_cuda(canvas, resid, jobs, pidx):
        return pal_level_plain(canvas, resid, jobs, pidx, bitdepth)
    if jobs.shape[0]:
        with torch.cuda.device(canvas.device):
            devrt.launch("ipred_pal", build.lib().dtpu_ipred_pal,
                         canvas.data_ptr(), resid.data_ptr(),
                         canvas.shape[0], canvas.shape[1], jobs.data_ptr(),
                         jobs.shape[0], pidx.data_ptr(), int(bitdepth),
                         build.stream(canvas),
                         keep=(canvas, resid, jobs, pidx))
    return canvas


def walk(canvas: torch.Tensor, luma, resid: torch.Tensor,
         jobs: torch.Tensor, tags: torch.Tensor, counts: torch.Tensor,
         pidx, ph_unit: int, ss_hor: int, ss_ver: int, bitdepth: int,
         max_ctas: int = 0) -> torch.Tensor:
    """Every unit of one chain, ``jobs`` ((n, JOB_COLS) int32) with their
    int32 ``tags`` (level << 2 | kind, sorted) and the int32 ``counts`` of
    units a level, in place on the (H, W) int32 ``canvas``, level after
    level; ``luma``: the finished int32 luma canvas (CFL units; None on
    the luma chain), ``pidx``: the uint8 index maps (palette units, else
    None); returns ``canvas``.  CPU tensors run :func:`walk_plain` after
    :func:`check_walk`; CUDA tensors launch ``csrc/ipred.cu`` once, with
    at most ``max_ctas`` CTAs (0: the resident ones; see
    :func:`walk_ctas`) and the table checked by the caller."""
    _check(canvas, resid, jobs, bitdepth)
    luma = canvas if luma is None else luma
    build.check(luma, "luma")
    build.check(tags, "tags", (jobs.shape[0],))
    build.check(counts, "counts")
    if counts.dim() != 1:
        raise ValueError(f"counts: shape {tuple(counts.shape)}, expected "
                         "1-D")
    extra = ()
    if pidx is not None:
        build.check(pidx, "pidx", dtype=torch.uint8)
        extra = (pidx,)
    if not build.on_cuda(canvas, luma, resid, jobs, tags, counts, *extra):
        check_walk(tags.numpy(), counts.numpy(), jobs.shape[0])
        return walk_plain(canvas, luma, resid, jobs, tags, counts, pidx,
                          ph_unit, ss_hor, ss_ver, bitdepth)
    if jobs.shape[0]:
        sync = torch.empty(counts.shape[0] + 1, dtype=torch.int32,
                           device=canvas.device)
        with torch.cuda.device(canvas.device):
            devrt.launch("ipred_walk", build.lib().dtpu_ipred_walk,
                         canvas.data_ptr(), luma.data_ptr(),
                         resid.data_ptr(), canvas.shape[0], canvas.shape[1],
                         ph_unit, luma.shape[0], luma.shape[1],
                         jobs.data_ptr(), tags.data_ptr(),
                         counts.data_ptr(), sync.data_ptr(), jobs.shape[0],
                         counts.shape[0], int(max_ctas),
                         pidx.data_ptr() if pidx is not None else None,
                         int(ss_hor), int(ss_ver), int(bitdepth),
                         build.stream(canvas),
                         keep=(canvas, luma, resid, jobs, tags, counts,
                               pidx, sync))
    return canvas
