"""AV1 film grain synthesis as the AV1 specification writes it, in plain
PyTorch: a reference to hold a decoder's grained output against.

The input is a grain-free picture (its luma plane and, unless it is
monochrome, its two chroma planes, as integer tensors on any device) and
the frame's film grain syntax elements (:class:`FilmGrainParams`, under
the specification's names and in its coded form); the output is the
grained picture.  The steps follow section 7.18.3 of the AV1 bitstream
specification:

* 7.18.3.2, the random number process (:class:`Random`);
* 7.18.3.3, the generation of the luma and chroma grain templates from
  the Gaussian sequence and their autoregressive filter at lags 0-3,
  chroma with its luma term (:func:`generate_grain`);
* 7.18.3.4, the scaling lookup and its interpolation above 8 bits
  (:func:`scaling_lookup_init`, :func:`scale_lut`);
* 7.18.3.5, the noise stripes of 34 rows with their random offsets and
  horizontal overlap, the noise image with the vertical overlap between
  stripes, and the blending of the noise into the picture: chroma first,
  from luma or through ``cb_mult``/``cb_luma_mult``/``cb_offset`` (and
  Cr's), then luma; restricted or full range, and the identity matrix's
  chroma maximum (:func:`add_noise`).

Integer arithmetic throughout, in int64 tensors; ``>>`` is arithmetic,
as the specification's.  Departures from the text, none of which
changes a result:

* ``Gaussian_Sequence`` (its 2048 entries) is read as data from
  ``dav1d_tpu_torch/data/tables.npz``, found in a parent directory of
  this file, with numpy, not retyped;
* the random number process and the autoregressive filter's recurrence
  along a row are serial: they run in Python integers.  The filter's
  sum over the rows above a row is one tensor expression over the row.
  The templates (at most 73 x 82) are made on the CPU and moved to the
  picture's device;
* the blocks of a noise stripe are written at once: a block's first
  columns, where the previous block's last columns lie, take the blend
  of the previous block's grain there (which no later write changes)
  and its own, as the specification's writes in block order leave them;
  the stripes' rows are joined into the noise image the same way;
* the noise image and the blending are whole-plane tensor expressions
  in place of the loops over ``y`` and ``x``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

GRAIN_H, GRAIN_W = 73, 82  # the luma template (chroma: 38 x 44 subsampled)


@dataclass
class FilmGrainParams:
    """The film_grain_params() syntax elements of a frame (spec 5.9.30),
    as coded: coefficients with their +128, offsets with their +256."""

    grain_seed: int
    num_y_points: int = 0
    point_y_value: list = field(default_factory=list)
    point_y_scaling: list = field(default_factory=list)
    chroma_scaling_from_luma: int = 0
    num_cb_points: int = 0
    point_cb_value: list = field(default_factory=list)
    point_cb_scaling: list = field(default_factory=list)
    num_cr_points: int = 0
    point_cr_value: list = field(default_factory=list)
    point_cr_scaling: list = field(default_factory=list)
    grain_scaling_minus_8: int = 0
    ar_coeff_lag: int = 0
    ar_coeffs_y_plus_128: list = field(default_factory=list)
    ar_coeffs_cb_plus_128: list = field(default_factory=list)
    ar_coeffs_cr_plus_128: list = field(default_factory=list)
    ar_coeff_shift_minus_6: int = 0
    grain_scale_shift: int = 0
    cb_mult: int = 128
    cb_luma_mult: int = 128
    cb_offset: int = 256
    cr_mult: int = 128
    cr_luma_mult: int = 128
    cr_offset: int = 256
    overlap_flag: int = 0
    clip_to_restricted_range: int = 0


def from_parsed(d) -> FilmGrainParams:
    """:class:`FilmGrainParams` from a parsed header in dav1d's form
    (``Dav1dFilmGrainData``'s fields, read by name: ``seed``,
    ``y_points`` and ``uv_points`` as (value, scaling) pairs,
    ``scaling_shift``, signed ``ar_coeffs_y``/``ar_coeffs_uv``,
    ``ar_coeff_shift``, signed ``uv_mult``/``uv_luma_mult``/
    ``uv_offset``)."""
    lag = d.ar_coeff_lag
    n_luma = 2 * lag * (lag + 1)
    ny, nu = d.num_y_points, d.num_uv_points
    pts = [list(d.y_points)[:ny], list(d.uv_points[0])[:nu[0]],
           list(d.uv_points[1])[:nu[1]]]
    return FilmGrainParams(
        grain_seed=d.seed, num_y_points=ny,
        point_y_value=[p[0] for p in pts[0]],
        point_y_scaling=[p[1] for p in pts[0]],
        chroma_scaling_from_luma=d.chroma_scaling_from_luma,
        num_cb_points=nu[0], point_cb_value=[p[0] for p in pts[1]],
        point_cb_scaling=[p[1] for p in pts[1]],
        num_cr_points=nu[1], point_cr_value=[p[0] for p in pts[2]],
        point_cr_scaling=[p[1] for p in pts[2]],
        grain_scaling_minus_8=d.scaling_shift - 8, ar_coeff_lag=lag,
        ar_coeffs_y_plus_128=[c + 128 for c in list(d.ar_coeffs_y)[:n_luma]],
        ar_coeffs_cb_plus_128=[
            c + 128 for c in list(d.ar_coeffs_uv[0])[:n_luma + 1]],
        ar_coeffs_cr_plus_128=[
            c + 128 for c in list(d.ar_coeffs_uv[1])[:n_luma + 1]],
        ar_coeff_shift_minus_6=d.ar_coeff_shift - 6,
        grain_scale_shift=d.grain_scale_shift,
        cb_mult=d.uv_mult[0] + 128, cb_luma_mult=d.uv_luma_mult[0] + 128,
        cb_offset=d.uv_offset[0] + 256, cr_mult=d.uv_mult[1] + 128,
        cr_luma_mult=d.uv_luma_mult[1] + 128,
        cr_offset=d.uv_offset[1] + 256, overlap_flag=d.overlap_flag,
        clip_to_restricted_range=d.clip_to_restricted_range)


@functools.cache
def gaussian_sequence() -> torch.Tensor:
    """``Gaussian_Sequence`` (spec 7.18.3.3), 2048 int64 entries."""
    for parent in Path(__file__).resolve().parents:
        path = parent / "dav1d_tpu_torch" / "data" / "tables.npz"
        if path.is_file():
            seq = np.load(path)["gaussian_sequence"].astype(np.int64)
            if seq.shape != (2048,):
                raise ValueError(f"{path}: Gaussian_Sequence of {seq.shape}")
            return torch.from_numpy(seq)
    raise FileNotFoundError("dav1d_tpu_torch/data/tables.npz")


def round2(x, n: int):
    """Round2(x, n) = (x + 2^(n-1)) >> n, and x where n is 0."""
    return x if n == 0 else (x + (1 << (n - 1))) >> n


def clip3(lo: int, hi: int, x):
    return torch.clamp(x, lo, hi) if torch.is_tensor(x) else \
        min(max(x, lo), hi)


# -- 7.18.3.2 ----------------------------------------------------------------


class Random:
    """RandomRegister and get_random_number()."""

    def __init__(self, seed: int):
        self.register = seed

    def get_random_number(self, bits: int) -> int:
        r = self.register
        bit = ((r >> 0) ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1
        r = (r >> 1) | (bit << 15)
        self.register = r
        return (r >> (16 - bits)) & ((1 << bits) - 1)


# -- 7.18.3.3 ----------------------------------------------------------------


def _gaussian_template(rng: Random, rows: int, cols: int, shift: int,
                       on: bool) -> torch.Tensor:
    """rows x cols of Round2(Gaussian_Sequence[get_random_number(11)],
    shift), drawn row by row; zeros (and no draw) where ``on`` is
    false."""
    if not on:
        return torch.zeros(rows, cols, dtype=torch.int64)
    idx = torch.tensor([rng.get_random_number(11)
                        for _ in range(rows * cols)], dtype=torch.int64)
    return round2(gaussian_sequence()[idx], shift).view(rows, cols)


def _auto_regress(grain: torch.Tensor, coeffs: list, lag: int, shift: int,
                  lo: int, hi: int, luma_term=None) -> None:
    """The autoregressive filter of one template, in place: every
    (y, x) with 3 <= y, 3 <= x < width - 3, in raster order, adds
    Round2 of the sum of ``coeffs`` (signed, in the order of the
    specification's loops) times the grain above and to its left, and
    for chroma ``luma_term(y)``: (the coefficient, the luma average of
    each x of row y) at the centre's position."""
    rows, cols = grain.shape
    xs = slice(3, cols - 3)
    above = [(dr, dc, coeffs[(dr + lag) * (2 * lag + 1) + dc + lag])
             for dr in range(-lag, 0) for dc in range(-lag, lag + 1)]
    left = [(dc, coeffs[lag * (2 * lag + 1) + dc + lag])
            for dc in range(-lag, 0)]
    for y in range(3, rows):
        part = torch.zeros(cols - 6, dtype=torch.int64)
        for dr, dc, c in above:
            part += c * grain[y + dr, 3 + dc:cols - 3 + dc]
        if luma_term is not None:
            c, luma = luma_term(y)
            part += c * luma
        part = part.tolist()
        row = grain[y].tolist()
        for x in range(3, cols - 3):
            s = part[x - 3]
            for dc, c in left:
                s += c * row[x + dc]
            row[x] = clip3(lo, hi, row[x] + round2(s, shift))
        grain[y, xs] = torch.tensor(row[3:cols - 3], dtype=torch.int64)


def generate_grain(p: FilmGrainParams, bitdepth: int, sub_x: int,
                   sub_y: int, mono: bool = False) -> list:
    """[LumaGrain] or [LumaGrain, CbGrain, CrGrain] (spec 7.18.3.3),
    int64 CPU tensors of 73 x 82 (chroma: (38 if sub_y else 73) x (44 if
    sub_x else 82))."""
    center = 128 << (bitdepth - 8)
    lo, hi = -center, (256 << (bitdepth - 8)) - 1 - center
    shift = 12 - bitdepth + p.grain_scale_shift
    rng = Random(p.grain_seed)
    luma = _gaussian_template(rng, GRAIN_H, GRAIN_W, shift,
                              p.num_y_points > 0)
    lag = p.ar_coeff_lag
    ar_shift = p.ar_coeff_shift_minus_6 + 6
    n_luma = 2 * lag * (lag + 1)
    if p.num_y_points > 0:
        _auto_regress(luma, [c - 128 for c in p.ar_coeffs_y_plus_128[:n_luma]],
                      lag, ar_shift, lo, hi)
    if mono:
        return [luma]
    ch = 38 if sub_y else GRAIN_H
    cw = 44 if sub_x else GRAIN_W
    out = [luma]
    for seed_xor, n_points, coeffs in (
            (0xB524, p.num_cb_points, p.ar_coeffs_cb_plus_128),
            (0x49D8, p.num_cr_points, p.ar_coeffs_cr_plus_128)):
        on = n_points > 0 or bool(p.chroma_scaling_from_luma)
        grain = _gaussian_template(Random(p.grain_seed ^ seed_xor), ch, cw,
                                   shift, on)
        if on:
            c = [v - 128 for v in coeffs]
            term = None
            if p.num_y_points > 0:
                xs = torch.arange(3, cw - 3)
                lx = ((xs - 3) << sub_x) + 3

                def term(y, c_luma=c[n_luma]):
                    ly = ((y - 3) << sub_y) + 3
                    acc = torch.zeros(cw - 6, dtype=torch.int64)
                    for i in range(sub_y + 1):
                        for j in range(sub_x + 1):
                            acc += luma[ly + i, lx + j]
                    return c_luma, round2(acc, sub_x + sub_y)

            _auto_regress(grain, c[:n_luma], lag, ar_shift, lo, hi, term)
        out.append(grain)
    return out


# -- 7.18.3.4 ----------------------------------------------------------------


def _points(p: FilmGrainParams, plane: int):
    if plane == 0 or p.chroma_scaling_from_luma:
        return p.point_y_value[:p.num_y_points], \
            p.point_y_scaling[:p.num_y_points]
    if plane == 1:
        return p.point_cb_value[:p.num_cb_points], \
            p.point_cb_scaling[:p.num_cb_points]
    return p.point_cr_value[:p.num_cr_points], \
        p.point_cr_scaling[:p.num_cr_points]


def scaling_lookup_init(p: FilmGrainParams, num_planes: int) -> list:
    """ScalingLut[plane]: 256 entries each, as lists of ints."""
    luts = []
    for plane in range(num_planes):
        xs, ys = _points(p, plane)
        lut = [0] * 256
        if xs:
            for i in range(xs[0]):
                lut[i] = ys[0]
            for i in range(len(xs) - 1):
                delta_y = ys[i + 1] - ys[i]
                delta_x = xs[i + 1] - xs[i]
                delta = delta_y * ((65536 + (delta_x >> 1)) // delta_x)
                for x in range(delta_x):
                    lut[xs[i] + x] = ys[i] + ((x * delta + 32768) >> 16)
            for i in range(xs[-1], 256):
                lut[i] = ys[-1]
        luts.append(lut)
    return luts


def scale_lut(lut: torch.Tensor, index: torch.Tensor,
              bitdepth: int) -> torch.Tensor:
    """scale_lut(plane, index) over a tensor of indices, ``lut`` the
    plane's ScalingLut as a tensor on their device."""
    shift = bitdepth - 8
    x = index >> shift
    if bitdepth == 8:
        return lut[x]
    rem = index - (x << shift)
    start = lut[x]
    end = lut[torch.clamp(x + 1, max=255)]
    return torch.where(x == 255, start,
                       start + round2((end - start) * rem, shift))


# -- 7.18.3.5 ----------------------------------------------------------------


def _blend(old, new, w_old: int, w_new: int, lo: int, hi: int):
    return clip3(lo, hi, round2(old * w_old + new * w_new, 5))


def _stripe_offsets(p: FilmGrainParams, w: int, h: int):
    """(offsetX, offsetY) of every block of every noise stripe: int64
    tensors of (stripes, blocks)."""
    ox, oy = [], []
    for luma_num, _ in enumerate(range(0, (h + 1) // 2, 16)):
        rng = Random(p.grain_seed
                     ^ (((luma_num * 37 + 178) & 255) << 8)
                     ^ ((luma_num * 173 + 105) & 255))
        row_x, row_y = [], []
        for _ in range(0, (w + 1) // 2, 16):
            rand = rng.get_random_number(8)
            row_x.append(rand >> 4)
            row_y.append(rand & 15)
        ox.append(row_x)
        oy.append(row_y)
    return (torch.tensor(ox, dtype=torch.int64),
            torch.tensor(oy, dtype=torch.int64))


def noise_stripes(grain: torch.Tensor, offsets, sub_x: int, sub_y: int,
                  overlap: bool, lo: int, hi: int) -> torch.Tensor:
    """NoiseStripe[lumaNum][plane] of one plane: (stripes, 34 >> sub_y,
    columns) int64, the columns of every block of every stripe."""
    off_x, off_y = offsets
    n_stripes, n_blocks = off_x.shape
    bh, bw = 34 >> sub_y, 34 >> sub_x
    step = 32 >> sub_x  # a block's first column, x * 2 or x
    pox = (6 + off_x) if sub_x else (9 + off_x * 2)
    poy = (6 + off_y) if sub_y else (9 + off_y * 2)
    dev = grain.device
    rows = poy.to(dev)[:, :, None, None] + torch.arange(bh, device=dev)[
        :, None]
    cols = pox.to(dev)[:, :, None, None] + torch.arange(bw, device=dev)
    g = grain[rows, cols]  # (stripes, blocks, bh, bw)
    stripe = torch.empty(n_stripes, bh, n_blocks * step + bw - step,
                         dtype=torch.int64, device=dev)
    stripe[:, :, :n_blocks * step] = g[:, :, :, :step].permute(
        0, 2, 1, 3).reshape(n_stripes, bh, n_blocks * step)
    stripe[:, :, n_blocks * step:] = g[:, -1, :, step:]
    if overlap and n_blocks > 1:
        weights = [(23, 22)] if sub_x else [(27, 17), (17, 27)]
        for j, (w_old, w_new) in enumerate(weights):
            old = g[:, :-1, :, step + j]  # the previous block's column
            new = g[:, 1:, :, j]
            stripe[:, :, step + j::step][:, :, :n_blocks - 1] = _blend(
                old, new, w_old, w_new, lo, hi).permute(0, 2, 1)
    return stripe


def noise_image(stripe: torch.Tensor, width: int, height: int, sub_y: int,
                overlap: bool, lo: int, hi: int) -> torch.Tensor:
    """NoiseImage[plane]: (height, width) of the plane, the stripes'
    rows joined with the vertical overlap."""
    n_stripes, bh, _ = stripe.shape
    step = 32 >> sub_y
    image = stripe[:, :step, :width].reshape(n_stripes * step, width)
    if overlap and n_stripes > 1:
        image = image.clone()
        weights = [(23, 22)] if sub_y else [(27, 17), (17, 27)]
        for i, (w_old, w_new) in enumerate(weights):
            image[step + i::step][:n_stripes - 1] = _blend(
                stripe[:-1, step + i, :width], stripe[1:, i, :width],
                w_old, w_new, lo, hi)
    return image[:height]


def add_noise(planes: list, p: FilmGrainParams, grain: list, bitdepth: int,
              sub_x: int, sub_y: int, mc_identity: bool) -> list:
    """The grained planes (spec 7.18.3.5): int64 tensors on the planes'
    device."""
    y_plane = planes[0]
    h, w = y_plane.shape
    dev = y_plane.device
    num_planes = len(planes)
    center = 128 << (bitdepth - 8)
    lo, hi = -center, (256 << (bitdepth - 8)) - 1 - center
    offsets = _stripe_offsets(p, w, h)
    overlap = bool(p.overlap_flag)
    noise = []
    for plane in range(num_planes):
        sx, sy = (sub_x, sub_y) if plane else (0, 0)
        stripe = noise_stripes(grain[plane].to(dev), offsets, sx, sy,
                               overlap, lo, hi)
        noise.append(noise_image(stripe, (w + sx) >> sx, (h + sy) >> sy,
                                 sy, overlap, lo, hi))
    if p.clip_to_restricted_range:
        min_value = 16 << (bitdepth - 8)
        max_luma = 235 << (bitdepth - 8)
        max_chroma = max_luma if mc_identity else 240 << (bitdepth - 8)
    else:
        min_value = 0
        max_luma = max_chroma = (256 << (bitdepth - 8)) - 1
    scaling_shift = p.grain_scaling_minus_8 + 8
    luts = [torch.tensor(t, dtype=torch.int64, device=dev)
            for t in scaling_lookup_init(p, num_planes)]
    out = list(planes)
    if num_planes > 1:
        ch, cw = (h + sub_y) >> sub_y, (w + sub_x) >> sub_x
        luma_y = (torch.arange(ch, device=dev) << sub_y)[:, None]
        luma_x = torch.arange(cw, device=dev) << sub_x
        luma_next_x = torch.clamp(luma_x + 1, max=w - 1)
        if sub_x:
            average_luma = round2(y_plane[luma_y, luma_x]
                                  + y_plane[luma_y, luma_next_x], 1)
        else:
            average_luma = y_plane[luma_y, luma_x]
        for plane, n_points, mult, luma_mult, offset in (
                (1, p.num_cb_points, p.cb_mult, p.cb_luma_mult, p.cb_offset),
                (2, p.num_cr_points, p.cr_mult, p.cr_luma_mult,
                 p.cr_offset)):
            if not (n_points > 0 or p.chroma_scaling_from_luma):
                continue
            orig = planes[plane]
            if p.chroma_scaling_from_luma:
                merged = average_luma
            else:
                combined = (average_luma * (luma_mult - 128)
                            + orig * (mult - 128))
                merged = clip3(0, (1 << bitdepth) - 1, (combined >> 6)
                               + ((offset - 256) << (bitdepth - 8)))
            n = round2(scale_lut(luts[plane], merged, bitdepth)
                       * noise[plane], scaling_shift)
            out[plane] = clip3(min_value, max_chroma, orig + n)
    if p.num_y_points > 0:
        n = round2(scale_lut(luts[0], y_plane, bitdepth) * noise[0],
                   scaling_shift)
        out[0] = clip3(min_value, max_luma, y_plane + n)
    return out


def film_grain_synthesis(planes: list, params: FilmGrainParams,
                         bitdepth: int, sub_x: int, sub_y: int,
                         mc_identity: bool = False) -> list:
    """The grained picture of grain-free ``planes`` ([Y] or [Y, Cb, Cr],
    2-D integer tensors on one device, luma h x w, chroma
    ((h + sub_y) >> sub_y) x ((w + sub_x) >> sub_x)): new tensors of the
    planes' dtype.  ``mc_identity``: the sequence's matrix_coefficients
    is MC_IDENTITY."""
    h, w = planes[0].shape
    if len(planes) not in (1, 3):
        raise ValueError("a picture has 1 or 3 planes")
    for pl in planes[1:]:
        if tuple(pl.shape) != ((h + sub_y) >> sub_y, (w + sub_x) >> sub_x):
            raise ValueError(f"chroma plane {tuple(pl.shape)} for luma "
                             f"{(h, w)} at subsampling {(sub_x, sub_y)}")
    grain = generate_grain(params, bitdepth, sub_x, sub_y,
                           mono=len(planes) == 1)
    wide = [pl.to(torch.int64) for pl in planes]
    out = add_noise(wide, params, grain, bitdepth, sub_x, sub_y, mc_identity)
    return [o.to(pl.dtype, copy=True) for o, pl in zip(out, planes)]
