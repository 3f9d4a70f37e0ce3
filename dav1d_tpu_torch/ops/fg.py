"""Film grain on device tensors (counterpart of dav1d_tpu/ops/fg.py, and of
the grain-row assembly that dav1d_tpu/recon/filmgrain.py runs on the
host before it: _block_offsets :147, _lut_block :166, _grain_blocks
:179).

One plane of a picture in one launch of ``csrc/fg.cu`` (:func:`apply_plane`):
each pixel assembles its grain value from the plane's grain LUT (a
73x82 slab, luma or the plane's chroma LUT, made on the host by the
native C, native/fg.c), at the random offsets of its 32x32 block
(:func:`row_offsets`, one small array per frame) with the overlap blends
against the left and upper blocks, computes its scaling index (the pixel
for luma; for chroma the luma average, or the uv_mult-combined value),
scales, rounds, clips, and writes a new plane: the input planes (the
frame's reference pixels) stay grain-free.

The plain versions, which the wrapper runs on CPU tensors:

* :func:`plain_grain_rows`: the blended grain plane (reference sample_lut
  + the overlap blending of fgy/fguv_32x32xn, src/filmgrain_tmpl.c);
* :func:`plain_index`: the scaling index plane of a chroma plane;
* :func:`plain_apply`: ``clip(src + round2(scale * grain, shift))`` with
  the scale ``lut[idx]`` or evaluated from the scaling points' 13
  closed-form segments (:func:`scaling_segments`; the JAX package's
  device tier always uses the segments, its host tier the LUT);
* :func:`apply_plane_plain`: the three composed, as the kernel computes
  them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import devrt
from ..kernels import build

GRAIN_W, GRAIN_H = 82, 73
LUT_ROWS = GRAIN_H + 1  # the native generators' (74, 82) buffers
FG_BLOCK = 32
NSEG = 13  # AV1 caps scaling points at 14 -> 13 segments
# overlap blend weights (old, new) by position: [sub][k]
W_SUB = ((27, 17), (17, 27)), ((23, 22), (0, 0))


@dataclasses.dataclass(frozen=True)
class PlaneParams:
    """What one plane's grain pass needs besides its tensors (the
    kernel's ``fg::Params``, csrc/fg_core.cuh)."""

    pl: int                 # 0 luma, 1/2 chroma
    ss_x: int
    ss_y: int
    bitdepth: int
    scaling_shift: int
    minv: int
    maxv: int
    overlap: int = 0
    csfl: int = 0           # chroma_scaling_from_luma
    uv_mult: int = 0
    uv_luma_mult: int = 0
    uv_offset: int = 0

    def ints(self):
        return [self.pl, self.ss_x, self.ss_y, self.bitdepth,
                self.scaling_shift, self.minv, self.maxv, self.overlap,
                self.csfl, self.uv_mult, self.uv_luma_mult, self.uv_offset]


N_PARAMS = 12


def scaling_segments(points, num):
    """Closed-form parameters of the scaling LUT's piecewise-linear
    segments (dav1d_tpu/ops/fg.py:32): 8-bit point coordinates bx/by
    padded by repeating the last point, per-segment deltas dl."""
    bx = np.zeros(NSEG + 1, dtype=np.int32)
    by = np.zeros(NSEG + 1, dtype=np.int32)
    dl = np.zeros(NSEG, dtype=np.int32)
    if num:
        for i in range(NSEG + 1):
            x, y = points[min(i, num - 1)][:2]
            bx[i], by[i] = x, y
        for i in range(num - 1):
            dx = int(bx[i + 1] - bx[i])
            dy = int(by[i + 1] - by[i])
            dl[i] = dy * ((0x10000 + (dx >> 1)) // dx)
    return bx, by, dl


def row_offsets(seed: int, overlap: int, n_rows: int,
                n_blocks: int) -> np.ndarray:
    """(n_rows, n_blocks, 2) int32: the random offset byte of each 32x32
    block of each block row, [..., 0] from the row's own generator and
    [..., 1] from the previous row's (read only with overlap, in rows
    > 0; zero elsewhere) — native/fg.c fg_row_offsets, reference
    filmgrain_tmpl.c seed/offsets shifting.  The same for every plane
    (a chroma block is a luma block subsampled).  The 16-bit LFSR runs
    vectorized across rows."""
    out = np.zeros((n_rows, n_blocks, 2), dtype=np.int32)
    rows = np.arange(n_rows, dtype=np.int64)
    for i in range(1 + bool(overlap)):
        r = rows - i
        s = (np.int64(seed) ^ ((((r * 37 + 178) & 0xFF) << 8)
                               | ((r * 173 + 105) & 0xFF))) & 0xFFFF
        for b in range(n_blocks):
            bit = (s ^ (s >> 1) ^ (s >> 3) ^ (s >> 12)) & 1
            s = (s >> 1) | (bit << 15)
            out[:, b, i] = (s >> 8) & 0xFF
    if overlap:
        out[0, :, 1] = 0
    return out


# ---- plain versions ------------------------------------------------------

def plain_grain_rows(lut: torch.Tensor, offs: torch.Tensor, pw: int,
                     ph: int, ss_x: int, ss_y: int, overlap: int,
                     bitdepth: int) -> torch.Tensor:
    """The (ph, pw) int32 blended grain plane of a plane of ``pw`` x
    ``ph`` pixels from its (74, 82) grain LUT and the frame's
    (n_rows, n_blocks, 2) :func:`row_offsets` (dav1d_tpu/recon/
    filmgrain._grain_blocks over every block row)."""
    dev = lut.device
    bsz, bszy = FG_BLOCK >> ss_x, FG_BLOCK >> ss_y
    gctr = 128 << (bitdepth - 8)
    y = torch.arange(ph, device=dev)[:, None]
    x = torch.arange(pw, device=dev)[None, :]
    row, yy = y // bszy, y % bszy
    bi, xx = x // bsz, x % bsz
    o = offs.long()
    bl = (bi - 1).clamp(min=0)

    def at(off, bxs, bys):
        ox = 3 + (2 >> ss_x) * (3 + (off >> 4)) + bsz * bxs + xx
        oy = 3 + (2 >> ss_y) * (3 + (off & 15)) + bszy * bys + yy
        return lut[oy.clamp(max=LUT_ROWS - 1), ox.clamp(max=GRAIN_W - 1)]

    def blend(old, new, w0, w1):
        return ((old * w0 + new * w1 + 16) >> 5).clamp(-gctr, gctr - 1)

    g = at(o[row, bi, 0], 0, 0)
    if not overlap:
        return g.to(torch.int32)
    wx = torch.tensor(W_SUB[ss_x], device=dev)[xx.clamp(max=1)]
    wy = torch.tensor(W_SUB[ss_y], device=dev)[yy.clamp(max=1)]
    mx = (bi > 0) & (xx < (2 >> ss_x))
    my = (row > 0) & (yy < (2 >> ss_y))
    g = torch.where(mx, blend(at(o[row, bl, 0], 1, 0), g, wx[..., 0],
                              wx[..., 1]), g)
    t = at(o[row, bi, 1], 0, 1)
    t = torch.where(mx, blend(at(o[row, bl, 1], 1, 1), t, wx[..., 0],
                              wx[..., 1]), t)
    g = torch.where(my, blend(t, g, wy[..., 0], wy[..., 1]), g)
    return g.to(torch.int32)


def plain_index(src: torch.Tensor, luma: torch.Tensor, lw: int,
                p: PlaneParams) -> torch.Tensor:
    """The scaling index of each pixel of the (h, w) plane ``src``: the
    pixel itself for luma; for chroma the average of the luma pixels
    under it (horizontally, with the last column repeated at an odd luma
    width ``lw``; the top row of a vertical pair), as it is with
    chroma_scaling_from_luma, else combined with the pixel by uv_mult /
    uv_luma_mult and offset (dav1d_tpu/recon/filmgrain.py:408-428)."""
    if p.pl == 0:
        return src
    h, w = src.shape
    ly = luma[0:(h << p.ss_y):1 << p.ss_y].long()
    if p.ss_x:
        c = torch.arange(w, device=src.device) * 2
        avg = (ly[:, c] + ly[:, (c + 1).clamp(max=lw - 1)] + 1) >> 1
    else:
        avg = ly[:, :w]
    if p.csfl:
        return avg.to(torch.int32)
    comb = avg * p.uv_luma_mult + src.long() * p.uv_mult
    val = (comb >> 6) + p.uv_offset * (1 << (p.bitdepth - 8))
    return val.clamp(0, (1 << p.bitdepth) - 1).to(torch.int32)


def plain_apply(src: torch.Tensor, idx: torch.Tensor, grain: torch.Tensor,
                shift: int, minv: int, maxv: int, lut=None, segments=None,
                bitdepth: int = 8) -> torch.Tensor:
    """clip(src + round2(scale * grain, shift), minv, maxv), int32, with
    the scale ``lut[idx]`` (dav1d_tpu/ops/fg.py:21 _jit_apply) or, given
    ``segments`` = (bx, by, dl) tensors of :func:`scaling_segments`,
    evaluated from them with the two-stage sub-interpolation above
    8-bit (:55 _jit_apply_pw)."""
    idx = idx.long()
    if segments is None:
        sc = lut.long()[idx]
    else:
        bx, by, dl = (s.long() for s in segments)
        sx = bitdepth - 8

        def f8(v):
            out = torch.where(v >= bx[NSEG], by[NSEG], by[0])
            for i in range(NSEG):
                m = (v >= bx[i]) & (v < bx[i + 1])
                out = torch.where(
                    m, by[i] + ((0x8000 + dl[i] * (v - bx[i])) >> 16), out)
            return out

        x8 = idx >> sx
        sc = f8(x8)
        if sx:
            k = idx & ((1 << sx) - 1)
            sc = sc + ((((1 << sx) >> 1) + k * (f8(x8 + 1) - sc)) >> sx)
    noise = (sc * grain.long() + ((1 << shift) >> 1)) >> shift
    return (src.long() + noise).clamp(minv, maxv).to(torch.int32)


def apply_plane_plain(src, luma, lut, scaling, offs, w, h, lw,
                      p: PlaneParams) -> torch.Tensor:
    """The plain version of :func:`apply_plane`."""
    s = src[:h, :w]
    grain = plain_grain_rows(lut, offs, w, h, p.ss_x, p.ss_y, p.overlap,
                             p.bitdepth)
    idx = plain_index(s, luma, lw, p)
    return plain_apply(s, idx, grain, p.scaling_shift, p.minv, p.maxv,
                       lut=scaling, bitdepth=p.bitdepth)


# ---- wrapper --------------------------------------------------------------

def apply_plane(src: torch.Tensor, luma: torch.Tensor | None,
                lut: torch.Tensor, scaling: torch.Tensor,
                offs: torch.Tensor, w: int, h: int, lw: int,
                p: PlaneParams) -> torch.Tensor:
    """Film grain of the top-left ``w`` x ``h`` pixels of the int32 plane
    ``src`` (any row stride; unit column stride) into a new (h, w) int32
    tensor.  ``luma``: the grain-free luma plane (chroma planes), ``lw``
    its cropped width; ``lut``: the plane's (74, 82) int32 grain LUT;
    ``scaling``: the (1 << bitdepth,) int32 scaling LUT; ``offs``: the
    frame's (n_rows, n_blocks, 2) int32 :func:`row_offsets`.  CPU
    tensors run :func:`apply_plane_plain`; CUDA tensors launch
    ``csrc/fg.cu``."""
    luma = src if luma is None else luma
    if src.dtype != torch.int32 or luma.dtype != torch.int32:
        raise TypeError("src and luma must be int32")
    if src.stride(1) != 1 or luma.stride(1) != 1:
        raise ValueError("src and luma need a unit column stride")
    if src.shape[0] < h or src.shape[1] < w:
        raise ValueError(f"src {tuple(src.shape)} smaller than {h}x{w}")
    build.check(lut, "lut", (LUT_ROWS, GRAIN_W))
    build.check(scaling, "scaling", (1 << p.bitdepth,))
    build.check(offs, "offs")
    n_rows = -(-(h << p.ss_y) // FG_BLOCK)
    n_blocks = -(-w // (FG_BLOCK >> p.ss_x))
    if offs.dim() != 3 or offs.shape[0] < n_rows or offs.shape[1] < n_blocks \
            or offs.shape[2] != 2:
        raise ValueError(f"offs {tuple(offs.shape)}, need at least "
                         f"({n_rows}, {n_blocks}, 2)")
    if p.bitdepth not in (8, 10, 12):
        raise ValueError(f"bitdepth {p.bitdepth}")
    if p.pl and (luma.shape[0] < ((h - 1) << p.ss_y) + 1 or
                 luma.shape[1] < lw):
        raise ValueError(f"luma {tuple(luma.shape)} too small")
    if not build.on_cuda(src, luma, lut, scaling, offs):
        return apply_plane_plain(src, luma, lut, scaling, offs, w, h, lw, p)
    out = torch.empty((h, w), dtype=torch.int32, device=src.device)
    if w and h:
        import ctypes

        prm = (ctypes.c_int * N_PARAMS)(*p.ints())
        with torch.cuda.device(src.device):
            devrt.launch("fg", build.lib().dtpu_fg, src.data_ptr(),
                         src.stride(0), luma.data_ptr(), luma.stride(0), lw,
                         out.data_ptr(), w, h, lut.data_ptr(),
                         scaling.data_ptr(), offs.data_ptr(), offs.shape[1],
                         prm, build.stream(src),
                         keep=(prm, src, luma, lut, scaling, offs, out))
    return out
