"""Warped-motion parameter math: shear validation and least-squares affine
fit from neighbour MVs.

Behavioral parity with reference src/warpmv.c (dav1d_get_shear_params :82,
dav1d_set_affine_mv2d :133, dav1d_find_affine_int :149; AV1 spec 7.11.3.6
setup_shear / resolve_divisor).
"""

from __future__ import annotations

import numpy as np

_DIV_LUT = np.array([
    16384, 16320, 16257, 16194, 16132, 16070, 16009, 15948, 15888, 15828,
    15768, 15709, 15650, 15592, 15534, 15477, 15420, 15364, 15308, 15252,
    15197, 15142, 15087, 15033, 14980, 14926, 14873, 14821, 14769, 14717,
    14665, 14614, 14564, 14513, 14463, 14413, 14364, 14315, 14266, 14218,
    14170, 14122, 14075, 14028, 13981, 13935, 13888, 13843, 13797, 13752,
    13707, 13662, 13618, 13574, 13530, 13487, 13443, 13400, 13358, 13315,
    13273, 13231, 13190, 13148, 13107, 13066, 13026, 12985, 12945, 12906,
    12866, 12827, 12788, 12749, 12710, 12672, 12633, 12596, 12558, 12520,
    12483, 12446, 12409, 12373, 12336, 12300, 12264, 12228, 12193, 12157,
    12122, 12087, 12053, 12018, 11984, 11950, 11916, 11882, 11848, 11815,
    11782, 11749, 11716, 11683, 11651, 11619, 11586, 11555, 11523, 11491,
    11460, 11429, 11398, 11367, 11336, 11305, 11275, 11245, 11215, 11185,
    11155, 11125, 11096, 11067, 11038, 11009, 10980, 10951, 10923, 10894,
    10866, 10838, 10810, 10782, 10755, 10727, 10700, 10673, 10645, 10618,
    10592, 10565, 10538, 10512, 10486, 10460, 10434, 10408, 10382, 10356,
    10331, 10305, 10280, 10255, 10230, 10205, 10180, 10156, 10131, 10107,
    10082, 10058, 10034, 10010, 9986, 9963, 9939, 9916, 9892, 9869,
    9846, 9823, 9800, 9777, 9754, 9732, 9709, 9687, 9664, 9642,
    9620, 9598, 9576, 9554, 9533, 9511, 9489, 9468, 9447, 9425,
    9404, 9383, 9362, 9341, 9321, 9300, 9279, 9259, 9239, 9218,
    9198, 9178, 9158, 9138, 9118, 9098, 9079, 9059, 9039, 9020,
    9001, 8981, 8962, 8943, 8924, 8905, 8886, 8867, 8849, 8830,
    8812, 8793, 8775, 8756, 8738, 8720, 8702, 8684, 8666, 8648,
    8630, 8613, 8595, 8577, 8560, 8542, 8525, 8508, 8490, 8473,
    8456, 8439, 8422, 8405, 8389, 8372, 8355, 8339, 8322, 8306,
    8289, 8273, 8257, 8240, 8224, 8208, 8192], dtype=np.int32)


def _apply_sign(v, s):
    return -v if s < 0 else v


def _iclip(v, lo, hi):
    return max(lo, min(hi, v))


def _iclip_wmp(v):
    cv = _iclip(v, -32768, 32767)
    return _apply_sign((abs(cv) + 32) >> 6, cv) * 64


def _resolve_divisor_32(d):
    shift = d.bit_length() - 1
    e = d - (1 << shift)
    f = (e + (1 << (shift - 9))) >> (shift - 8) if shift > 8 \
        else e << (8 - shift)
    return int(_DIV_LUT[f]), shift + 14


def get_shear_params(wm) -> bool:
    """Fill wm.alpha/beta/gamma/delta; returns True if params are invalid
    (too sheared for warp filters)."""
    mat = wm.matrix
    if mat[2] <= 0:
        return True
    wm.abcd[0] = _iclip_wmp(mat[2] - 0x10000)
    wm.abcd[1] = _iclip_wmp(mat[3])
    idiv, shift = _resolve_divisor_32(abs(mat[2]))
    y = _apply_sign(idiv, mat[2])
    rnd = (1 << shift) >> 1
    v1 = (mat[4] * 0x10000) * y
    wm.abcd[2] = _iclip_wmp(_apply_sign((abs(v1) + rnd) >> shift, v1))
    v2 = (mat[3] * mat[4]) * y
    wm.abcd[3] = _iclip_wmp(mat[5] - _apply_sign((abs(v2) + rnd) >> shift, v2)
                            - 0x10000)
    return (4 * abs(wm.abcd[0]) + 7 * abs(wm.abcd[1]) >= 0x10000) or \
        (4 * abs(wm.abcd[2]) + 4 * abs(wm.abcd[3]) >= 0x10000)


def _resolve_divisor_64(d):
    shift = d.bit_length() - 1
    e = d - (1 << shift)
    f = (e + (1 << (shift - 9))) >> (shift - 8) if shift > 8 \
        else e << (8 - shift)
    return int(_DIV_LUT[f]), shift + 14


def _get_mult_shift_ndiag(px, idet, shift):
    v1 = px * idet
    v2 = _apply_sign((abs(v1) + ((1 << shift) >> 1)) >> shift, v1)
    return _iclip(v2, -0x1FFF, 0x1FFF)


def _get_mult_shift_diag(px, idet, shift):
    v1 = px * idet
    v2 = _apply_sign((abs(v1) + ((1 << shift) >> 1)) >> shift, v1)
    return _iclip(v2, 0xE001, 0x11FFF)


def find_affine_int(pts, np_, bw4, bh4, mvy, mvx, wm, bx4, by4) -> bool:
    """Least-squares affine solve; returns True on failure (det == 0)."""
    mat = wm.matrix
    a = [[0, 0], [0, 0]]
    bx = [0, 0]
    by = [0, 0]
    rsuy = 2 * bh4 - 1
    rsux = 2 * bw4 - 1
    suy = rsuy * 8
    sux = rsux * 8
    duy = suy + mvy
    dux = sux + mvx
    isuy = by4 * 4 + rsuy
    isux = bx4 * 4 + rsux

    for i in range(np_):
        dx = pts[i][1][0] - dux
        dy = pts[i][1][1] - duy
        sx = pts[i][0][0] - sux
        sy = pts[i][0][1] - suy
        if abs(sx - dx) < 256 and abs(sy - dy) < 256:
            a[0][0] += ((sx * sx) >> 2) + sx * 2 + 8
            a[0][1] += ((sx * sy) >> 2) + sx + sy + 4
            a[1][1] += ((sy * sy) >> 2) + sy * 2 + 8
            bx[0] += ((sx * dx) >> 2) + sx + dx + 8
            bx[1] += ((sy * dx) >> 2) + sy + dx + 4
            by[0] += ((sx * dy) >> 2) + sx + dy + 4
            by[1] += ((sy * dy) >> 2) + sy + dy + 8

    det = a[0][0] * a[1][1] - a[0][1] * a[0][1]
    if det == 0:
        return True
    idet, shift = _resolve_divisor_64(abs(det))
    idet = _apply_sign(idet, det)
    shift -= 16
    if shift < 0:
        idet <<= -shift
        shift = 0

    mat[2] = _get_mult_shift_diag(a[1][1] * bx[0] - a[0][1] * bx[1],
                                  idet, shift)
    mat[3] = _get_mult_shift_ndiag(a[0][0] * bx[1] - a[0][1] * bx[0],
                                   idet, shift)
    mat[4] = _get_mult_shift_ndiag(a[1][1] * by[0] - a[0][1] * by[1],
                                   idet, shift)
    mat[5] = _get_mult_shift_diag(a[0][0] * by[1] - a[0][1] * by[0],
                                  idet, shift)
    mat[0] = _iclip(mvx * 0x2000 - (isux * (mat[2] - 0x10000)
                                    + isuy * mat[3]), -0x800000, 0x7FFFFF)
    mat[1] = _iclip(mvy * 0x2000 - (isux * mat[4]
                                    + isuy * (mat[5] - 0x10000)),
                    -0x800000, 0x7FFFFF)
    return False
