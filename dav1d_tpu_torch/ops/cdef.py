"""CDEF on device tensors (counterpart of dav1d_tpu/ops/cdef.py and
dav1d_tpu/ops/pallas_cdef.py).

Two operations, each a plain PyTorch version plus a CUDA kernel wrapper
(CPU tensors run the plain version, CUDA tensors the kernel):

* the direction search over every 8-aligned 8x8 block of the resident
  luma plane (:func:`find_dir_maps`; kernel ``csrc/cdef_dir.cu``,
  replacing ops/cdef._jit_find_dir_maps);
* the CDEF filter of one plane with the unit parameters derived from the
  unit strength grids and the direction/variance maps
  (:func:`filter_plane`; kernel ``csrc/cdef_filter.cu`` with its
  arithmetic in ``csrc/cdef_core.cuh``, replacing pallas_cdef._build with
  _jit_plane_resident's derivation), or of a row band of a plane with 2
  halo rows of each neighbour (its band form, which the mesh's CDEF
  runs, recon/mesh_cdef.py; replacing mesh_cdef._band_program).

Reference: src/cdef_tmpl.c:56-321, src/cdef_apply_tmpl.c.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import devrt, state
from ..kernels import build

# padding sentinel of the filter (pallas_cdef._SENT16): the min ignores
# it, the max does not, and |sentinel - px| never wraps int16
SENT = -28672
_MIN_IGNORE = 0x7FFF0000


def _check_bitdepth(bitdepth):
    if bitdepth not in (8, 10, 12):
        raise ValueError(f"bitdepth {bitdepth}")


# ---- direction search ---------------------------------------------------

def find_dir_maps_plain(plane: torch.Tensor, bitdepth: int):
    """(dir, var) int32 maps (H//8, W//8) of the 8x8 blocks of ``plane``,
    in plain PyTorch: partial sums by index_add over the bin table,
    costs as integer weighted sums of squares, strict first argmax."""
    tb = state.tables(plane.device)
    H, W = plane.shape
    R8, W8 = H // 8, W // 8
    blocks = plane[:R8 * 8, :W8 * 8].reshape(R8, 8, W8, 8) \
        .permute(0, 2, 1, 3).reshape(-1, 64).to(torch.int64)
    px = (blocks >> (bitdepth - 8)) - 128
    n = px.shape[0]
    cost = []
    for d in range(8):
        ps = torch.zeros((n, 15), dtype=torch.int64, device=plane.device)
        ps.index_add_(1, tb.bin_index[d], px)
        cost.append((ps * ps * tb.bin_weights[d].to(torch.int64)).sum(1))
    best = torch.zeros(n, dtype=torch.int64, device=plane.device)
    best_cost = cost[0]
    for d in range(1, 8):
        m = cost[d] > best_cost
        best = torch.where(m, d, best)
        best_cost = torch.where(m, cost[d], best_cost)
    alt_cost = torch.stack(cost, 1).gather(1, (best ^ 4)[:, None])[:, 0]
    var = (best_cost - alt_cost) >> 10
    return (best.to(torch.int32).reshape(R8, W8),
            var.to(torch.int32).reshape(R8, W8))


def find_dir_maps(plane: torch.Tensor, bitdepth: int):
    """Direction search of every 8-aligned 8x8 block of the resident
    luma plane (counterpart of ops/cdef.cdef_find_dir_maps_dev): returns
    (dir, var) int32 tensors of shape (H//8, W//8) on the plane's
    device."""
    build.check(plane, "plane")
    _check_bitdepth(bitdepth)
    if not build.on_cuda(plane):
        return find_dir_maps_plain(plane, bitdepth)
    H, W = plane.shape
    tb = state.tables(plane.device)
    d = torch.empty((H // 8, W // 8), dtype=torch.int32, device=plane.device)
    v = torch.empty_like(d)
    with torch.cuda.device(plane.device):
        devrt.launch("cdef_dir", build.lib().dtpu_cdef_dir,
                     plane.data_ptr(), H, W, int(bitdepth),
                     tb.bin_weights.data_ptr(), d.data_ptr(), v.data_ptr(),
                     build.stream(plane))
    return d, v


# ---- filter -------------------------------------------------------------

def host_maps(ph, pw, w, h, uys, uxs, *vals):
    """(nbands, ncols) int32 unit-grid maps from the host unit lists, in
    numpy (pallas_cdef._host_maps; units are h/w-aligned)."""
    nbands = -(-int(ph) // int(h))
    ncols = -(-int(pw) // int(w))
    ub = np.asarray(uys) // int(h)
    uc = np.asarray(uxs) // int(w)
    out = []
    for v in vals:
        m = np.zeros((nbands, ncols), np.int32)
        m[ub, uc] = v
        out.append(m)
    return out


def _ulog2(v: torch.Tensor, bits: int) -> torch.Tensor:
    """floor(log2(v)) for 1 <= v < 2^bits, 0 for v <= 0, by compares."""
    s = torch.zeros_like(v)
    for k in range(1, bits):
        s += (v >= (1 << k)).to(v.dtype)
    return s


def _unit_params(pm, dmap, vmap, luma, layout_422):
    """Per-unit (pri, dir) from the strength grid and the dir/var maps
    (pallas_cdef._jit_plane_resident): luma pri is the variance-adjusted
    strength (reference adjust_strength), chroma directions remap through
    the layout's UV table.  Units beyond the maps read dir = var = 0."""
    nb, nc = pm.shape
    r, c = min(nb, dmap.shape[0]), min(nc, dmap.shape[1])
    d = torch.zeros_like(pm)
    d[:r, :c] = dmap[:r, :c]
    mp = pm > 0
    if luma:
        v = torch.zeros_like(pm)
        v[:r, :c] = vmap[:r, :c]
        lg = torch.clamp(_ulog2(v >> 6, 31), max=12)
        pri = torch.where(mp & (v != 0), (pm * (4 + lg) + 8) >> 4, 0)
        return pri, torch.where(mp, d, 0)
    uv = state.tables(pm.device).uv_dirs[int(layout_422)]
    return pm, torch.where(mp, uv[d.long()], 0)


def filter_plane_plain(plane, pm, sm, dmap, vmap, ph, pw, w, h, damping,
                       bitdepth, luma, layout_422, top=0, bottom=0):
    """CDEF of one plane, or of a band with halo rows, in plain PyTorch
    (see :func:`filter_plane`)."""
    tb = state.tables(plane.device)
    pri_u, dir_u = _unit_params(pm, dmap, vmap, luma, layout_422)

    def rep(m):  # unit grid -> per-pixel (ph, pw) map
        return m.repeat_interleave(h, 0).repeat_interleave(w, 1)[:ph, :pw]

    pri, sec, dirs = rep(pri_u), rep(sm), rep(dir_u).long()
    # canvas rows -2 .. ph + 1 of the band: the halo rows are pixels,
    # every other row outside (ph, pw) the sentinel
    canvas = torch.full((ph + 4, pw + 4), SENT, dtype=torch.int32,
                        device=plane.device)
    canvas[2 - top:2 + ph + bottom, 2:2 + pw] = \
        plane[:top + ph + bottom, :pw]
    rows = plane.shape[0] - top - bottom
    plane = plane[top:top + rows]
    px = plane[:ph, :pw]
    yy = torch.arange(2, ph + 2, device=plane.device)[:, None]
    xx = torch.arange(2, pw + 2, device=plane.device)[None, :]
    dy_t, dx_t = tb.dir_dy.long(), tb.dir_dx.long()

    def tap(k, idx, sgn):
        return canvas[yy + sgn * dy_t[k][idx], xx + sgn * dx_t[k][idx]]

    def constrain(diff, thr, shift):
        adiff = torch.abs(diff)
        v = torch.minimum(adiff, torch.clamp(thr - (adiff >> shift), min=0))
        return torch.where(diff < 0, -v, v)

    pri_nz, sec_nz = pri > 0, sec > 0
    pri_shift = torch.clamp(damping - _ulog2(torch.clamp(pri, min=1), 16),
                            min=0)
    sec_shift = damping - _ulog2(torch.clamp(sec, min=1), 16)
    par = ((pri >> (bitdepth - 8)) & 1) > 0
    sum_ = torch.zeros_like(px)
    mn, mx = px.clone(), px.clone()

    def acc_minmax(v):
        nonlocal mn, mx
        mn = torch.minimum(mn, torch.where(v == SENT, _MIN_IGNORE, v))
        mx = torch.maximum(mx, v)

    for k in range(2):
        p0, p1 = tap(k, 2 + dirs, 1), tap(k, 2 + dirs, -1)
        x = constrain(p0 - px, pri, pri_shift) + \
            constrain(p1 - px, pri, pri_shift)
        # primary weight by strength parity: 3, else 4 (k=0) / 2 (k=1)
        pc = torch.where(par, 3 * x, (4 if k == 0 else 2) * x)
        sum_ += torch.where(pri_nz, pc, 0)
        acc_minmax(p0)
        acc_minmax(p1)
        for off in (4, 0):
            for sgn in (1, -1):
                s = tap(k, off + dirs, sgn)
                sc = (2 - k) * constrain(s - px, sec, sec_shift)
                sum_ += torch.where(sec_nz, sc, 0)
                acc_minmax(s)
    out = px + ((sum_ - (sum_ < 0).to(sum_.dtype) + 8) >> 4)
    both = pri_nz & sec_nz
    out = torch.where(both, torch.minimum(torch.maximum(out, mn), mx), out)
    res = plane.clone()
    res[:ph, :pw] = torch.where(pri_nz | sec_nz, out, px)
    return res


def filter_plane(plane, pm, sm, dmap, vmap, ph, pw, w, h, damping,
                 bitdepth, luma, layout_422, top=0, bottom=0):
    """CDEF of one resident plane: returns a new (H, W) int32 plane.

    pm / sm: (ceil(ph/h), ceil(pw/w)) int32 unit primary / secondary
    strength grids (:func:`host_maps`); dmap / vmap: the luma
    direction / variance maps (:func:`find_dir_maps`).  Pixels outside
    (ph, pw) pass through.  Units are 4 or 8 pixels on a side, and the
    plane's pixels lie in [0, 2^bitdepth), as the codec's do (the kernel
    takes the min of a pixel and its taps unsigned, to skip the padding
    sentinel).  CPU tensors run the plain version, CUDA tensors launch
    ``csrc/cdef_filter.cu``.

    Band form (recon/mesh_cdef.py): ``plane`` is a row band's canvas of
    ``top`` halo rows, the band's rows and ``bottom`` halo rows (0 or 2
    each; ``bottom`` only where the band's rows are all filtered,
    ``ph`` = its rows); the result is the band's rows alone, and ``ph``,
    the unit grids and the maps are in the band's coordinates (the maps
    from the band's first unit row).  A tap in a halo row reads its
    pixel, every other tap outside (ph, pw) the sentinel.  The whole
    plane is the band with no halo; a launch with halo rows counts under
    ``devrt.LAUNCHES["cdef_filter_band"]``, one without under
    ``cdef_filter``."""
    Hc, W = plane.shape
    H = Hc - top - bottom
    nb, nc = -(-int(ph) // int(h)), -(-int(pw) // int(w))
    build.check(plane, "plane")
    build.check(pm, "pri map", (nb, nc))
    build.check(sm, "sec map", (nb, nc))
    build.check(dmap, "dir map")
    build.check(vmap, "var map", dmap.shape)
    _check_bitdepth(bitdepth)
    if top not in (0, 2) or bottom not in (0, 2):
        raise ValueError(f"halo rows {top} above, {bottom} below: 0 or 2")
    if not (0 < ph <= H and 0 < pw <= W):
        raise ValueError(f"filtered region {ph}x{pw} outside {H}x{W}")
    if bottom and ph != H:
        raise ValueError(f"halo rows below a band filtered to row {ph} "
                         f"of {H}")
    if w not in (4, 8) or h not in (4, 8):
        raise ValueError(f"unit {w}x{h}: sides must be 4 or 8")
    args = (ph, pw, w, h, damping, bitdepth, luma, layout_422, top, bottom)
    if not build.on_cuda(plane, pm, sm, dmap, vmap):
        return filter_plane_plain(plane, pm, sm, dmap, vmap, *args)
    out = torch.empty((H, W), dtype=plane.dtype, device=plane.device)
    R8, W8 = dmap.shape
    # a launch with halo rows counts as the band form's
    tag = "cdef_filter_band" if top or bottom else "cdef_filter"
    with torch.cuda.device(plane.device):
        devrt.launch(tag, build.lib().dtpu_cdef_filter,
                     plane.data_ptr(), out.data_ptr(), H, W, int(ph),
                     int(pw), int(top), int(bottom), pm.data_ptr(),
                     sm.data_ptr(), nc, dmap.data_ptr(), vmap.data_ptr(), R8,
                     W8, int(w), int(h), int(damping), int(bitdepth),
                     int(luma), int(layout_422), build.stream(plane))
    return out


def cdef_filter_plane_resident(plane, dmap, vmap, ph, pw, uys, uxs, w, h,
                               pri, sec, damping, bitdepth, luma,
                               layout_422, top=0, bottom=0):
    """Counterpart of pallas_cdef.cdef_filter_plane_resident: unit lists
    (host numpy) -> strength grids (host numpy, uploaded) -> one filter
    launch with the direction/variance maps already on the device.
    ``top`` / ``bottom``: the band form of :func:`filter_plane` (units
    in the band's coordinates)."""
    pm, sm = host_maps(ph, pw, w, h, uys, uxs, pri, sec)
    pm = devrt.upload(pm, plane.device)
    sm = devrt.upload(sm, plane.device)
    return devrt.call("cdef_filter", filter_plane, plane, pm, sm, dmap,
                      vmap, ph, pw, w, h, damping, bitdepth, luma,
                      layout_422, top, bottom)
