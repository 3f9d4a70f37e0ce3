"""Inverse transforms — exact integer 1-D kernels + 2-D wrapper.

Behavioral parity with the reference (src/itx_1d.c:92-1066, src/itx_tmpl.c:
44-205; AV1 spec 7.13.3). Rotations are expressed at canonical 12-bit scale
``(a*ca + b*cb + 2048) >> 12`` — the reference's (C-4096) overflow tricks and
half-scale >>11 forms are bit-exact rewrites of this, which Python's
arbitrary-precision ints don't need. Additions clip to the per-pass range
like the reference (deterministic behavior on out-of-range streams).
"""

from __future__ import annotations

import numpy as np

from .. import tables
from ..levels import TxfmType
from ..native import lib as _native

# per rect-tx-size intermediate down-shift (reference itx_tmpl.c:160-178)
TX_SHIFT = [0, 1, 2, 2, 2,  # 4x4, 8x8, 16x16, 32x32, 64x64
            0, 0, 1, 1, 1, 1, 1, 1,  # 4x8, 8x4, 8x16, 16x8, 16x32, 32x16, 32x64, 64x32
            1, 1, 2, 2, 2, 2]  # 4x16, 16x4, 8x32, 32x8, 16x64, 64x16

DCT, ADST, FLIPADST, IDENTITY = 0, 1, 2, 3

# txtp -> (horizontal/row 1-D type, vertical/col 1-D type). The TxfmType
# enum names vertical first (ADST_DCT = ADST vertical, DCT horizontal);
# reference itx_tmpl.c's assign macros apply the corresponding swap.
TX1D_TYPES = {
    TxfmType.DCT_DCT: (DCT, DCT),
    TxfmType.ADST_DCT: (DCT, ADST),
    TxfmType.DCT_ADST: (ADST, DCT),
    TxfmType.ADST_ADST: (ADST, ADST),
    TxfmType.FLIPADST_DCT: (DCT, FLIPADST),
    TxfmType.DCT_FLIPADST: (FLIPADST, DCT),
    TxfmType.FLIPADST_FLIPADST: (FLIPADST, FLIPADST),
    TxfmType.ADST_FLIPADST: (FLIPADST, ADST),
    TxfmType.FLIPADST_ADST: (ADST, FLIPADST),
    TxfmType.IDTX: (IDENTITY, IDENTITY),
    TxfmType.V_DCT: (IDENTITY, DCT),
    TxfmType.H_DCT: (DCT, IDENTITY),
    TxfmType.V_ADST: (IDENTITY, ADST),
    TxfmType.H_ADST: (ADST, IDENTITY),
    TxfmType.V_FLIPADST: (IDENTITY, FLIPADST),
    TxfmType.H_FLIPADST: (FLIPADST, IDENTITY),
}


def _rr(a, ca, b, cb):
    return (a * ca + b * cb + 2048) >> 12


def _r181(v):
    return (v * 181 + 128) >> 8


def dct4(c, o, s, clip):
    in0, in1, in2, in3 = c[o], c[o + s], c[o + 2 * s], c[o + 3 * s]
    t0 = _r181(in0 + in2)
    t1 = _r181(in0 - in2)
    t2 = _rr(in1, 1567, in3, -3784)
    t3 = _rr(in1, 3784, in3, 1567)
    c[o] = clip(t0 + t3)
    c[o + s] = clip(t1 + t2)
    c[o + 2 * s] = clip(t1 - t2)
    c[o + 3 * s] = clip(t0 - t3)


def dct8(c, o, s, clip):
    dct4(c, o, s * 2, clip)
    in1, in3, in5, in7 = c[o + s], c[o + 3 * s], c[o + 5 * s], c[o + 7 * s]
    t4a = _rr(in1, 799, in7, -4017)
    t5a = _rr(in5, 3406, in3, -2276)
    t6a = _rr(in5, 2276, in3, 3406)
    t7a = _rr(in1, 4017, in7, 799)
    t4 = clip(t4a + t5a)
    t5a = clip(t4a - t5a)
    t7 = clip(t7a + t6a)
    t6a = clip(t7a - t6a)
    t5 = _r181(t6a - t5a)
    t6 = _r181(t6a + t5a)
    t0, t1, t2, t3 = c[o], c[o + 2 * s], c[o + 4 * s], c[o + 6 * s]
    c[o + 0 * s] = clip(t0 + t7)
    c[o + 1 * s] = clip(t1 + t6)
    c[o + 2 * s] = clip(t2 + t5)
    c[o + 3 * s] = clip(t3 + t4)
    c[o + 4 * s] = clip(t3 - t4)
    c[o + 5 * s] = clip(t2 - t5)
    c[o + 6 * s] = clip(t1 - t6)
    c[o + 7 * s] = clip(t0 - t7)


def dct16(c, o, s, clip):
    dct8(c, o, s * 2, clip)
    in1, in3 = c[o + s], c[o + 3 * s]
    in5, in7 = c[o + 5 * s], c[o + 7 * s]
    in9, in11 = c[o + 9 * s], c[o + 11 * s]
    in13, in15 = c[o + 13 * s], c[o + 15 * s]

    t8a = _rr(in1, 401, in15, -4076)
    t9a = _rr(in9, 3166, in7, -2598)
    t10a = _rr(in5, 1931, in11, -3612)
    t11a = _rr(in13, 3920, in3, -1189)
    t12a = _rr(in13, 1189, in3, 3920)
    t13a = _rr(in5, 3612, in11, 1931)
    t14a = _rr(in9, 2598, in7, 3166)
    t15a = _rr(in1, 4076, in15, 401)

    t8 = clip(t8a + t9a)
    t9 = clip(t8a - t9a)
    t10 = clip(t11a - t10a)
    t11 = clip(t11a + t10a)
    t12 = clip(t12a + t13a)
    t13 = clip(t12a - t13a)
    t14 = clip(t15a - t14a)
    t15 = clip(t15a + t14a)

    t9a = _rr(t14, 1567, t9, -3784)
    t14a = _rr(t14, 3784, t9, 1567)
    t10a = _rr(t13, -3784, t10, -1567)
    t13a = _rr(t13, 1567, t10, -3784)

    t8a = clip(t8 + t11)
    t9 = clip(t9a + t10a)
    t10 = clip(t9a - t10a)
    t11a = clip(t8 - t11)
    t12a = clip(t15 - t12)
    t13 = clip(t14a - t13a)
    t14 = clip(t14a + t13a)
    t15a = clip(t15 + t12)

    t10a = _r181(t13 - t10)
    t13a = _r181(t13 + t10)
    t11 = _r181(t12a - t11a)
    t12 = _r181(t12a + t11a)

    t0, t1, t2, t3 = c[o], c[o + 2 * s], c[o + 4 * s], c[o + 6 * s]
    t4, t5, t6, t7 = c[o + 8 * s], c[o + 10 * s], c[o + 12 * s], c[o + 14 * s]
    out = [t0 + t15a, t1 + t14, t2 + t13a, t3 + t12,
           t4 + t11, t5 + t10a, t6 + t9, t7 + t8a,
           t7 - t8a, t6 - t9, t5 - t10a, t4 - t11,
           t3 - t12, t2 - t13a, t1 - t14, t0 - t15a]
    for i, v in enumerate(out):
        c[o + i * s] = clip(v)


def dct32(c, o, s, clip):
    dct16(c, o, s * 2, clip)
    i_ = [c[o + k * s] for k in range(32)]
    (in1, in3, in5, in7, in9, in11, in13, in15, in17, in19, in21, in23,
     in25, in27, in29, in31) = [i_[k] for k in range(1, 32, 2)]

    t16a = _rr(in1, 201, in31, -4091)
    t17a = _rr(in17, 3035, in15, -2751)
    t18a = _rr(in9, 1751, in23, -3703)
    t19a = _rr(in25, 3857, in7, -1380)
    t20a = _rr(in5, 995, in27, -3973)
    t21a = _rr(in21, 3513, in11, -2106)
    t22a = _rr(in13, 2440, in19, -3290)
    t23a = _rr(in29, 4052, in3, -601)
    t24a = _rr(in29, 601, in3, 4052)
    t25a = _rr(in13, 3290, in19, 2440)
    t26a = _rr(in21, 2106, in11, 3513)
    t27a = _rr(in5, 3973, in27, 995)
    t28a = _rr(in25, 1380, in7, 3857)
    t29a = _rr(in9, 3703, in23, 1751)
    t30a = _rr(in17, 2751, in15, 3035)
    t31a = _rr(in1, 4091, in31, 201)

    t16 = clip(t16a + t17a)
    t17 = clip(t16a - t17a)
    t18 = clip(t19a - t18a)
    t19 = clip(t19a + t18a)
    t20 = clip(t20a + t21a)
    t21 = clip(t20a - t21a)
    t22 = clip(t23a - t22a)
    t23 = clip(t23a + t22a)
    t24 = clip(t24a + t25a)
    t25 = clip(t24a - t25a)
    t26 = clip(t27a - t26a)
    t27 = clip(t27a + t26a)
    t28 = clip(t28a + t29a)
    t29 = clip(t28a - t29a)
    t30 = clip(t31a - t30a)
    t31 = clip(t31a + t30a)

    t17a = _rr(t30, 799, t17, -4017)
    t30a = _rr(t30, 4017, t17, 799)
    t18a = _rr(t29, -4017, t18, -799)
    t29a = _rr(t29, 799, t18, -4017)
    t21a = _rr(t26, 3406, t21, -2276)
    t26a = _rr(t26, 2276, t21, 3406)
    t22a = _rr(t25, -2276, t22, -3406)
    t25a = _rr(t25, 3406, t22, -2276)

    t16a = clip(t16 + t19)
    t17_ = clip(t17a + t18a)
    t18 = clip(t17a - t18a)
    t19a = clip(t16 - t19)
    t20a = clip(t23 - t20)
    t21 = clip(t22a - t21a)
    t22 = clip(t22a + t21a)
    t23a = clip(t23 + t20)
    t24a = clip(t24 + t27)
    t25 = clip(t25a + t26a)
    t26 = clip(t25a - t26a)
    t27a = clip(t24 - t27)
    t28a = clip(t31 - t28)
    t29_ = clip(t30a - t29a)
    t30 = clip(t30a + t29a)
    t31a = clip(t31 + t28)
    t17, t29 = t17_, t29_

    t18a = _rr(t29, 1567, t18, -3784)
    t29a = _rr(t29, 3784, t18, 1567)
    t19_ = _rr(t28a, 1567, t19a, -3784)
    t28 = _rr(t28a, 3784, t19a, 1567)
    t20_ = _rr(t27a, -3784, t20a, -1567)
    t27_ = _rr(t27a, 1567, t20a, -3784)
    t21a = _rr(t26, -3784, t21, -1567)
    t26a = _rr(t26, 1567, t21, -3784)
    t19, t20, t27 = t19_, t20_, t27_

    t16 = clip(t16a + t23a)
    t17a = clip(t17 + t22)
    t18_ = clip(t18a + t21a)
    t19a = clip(t19 + t20)
    t20a = clip(t19 - t20)
    t21_ = clip(t18a - t21a)
    t22a = clip(t17 - t22)
    t23 = clip(t16a - t23a)
    t24 = clip(t31a - t24a)
    t25a = clip(t30 - t25)
    t26_ = clip(t29a - t26a)
    t27a = clip(t28 - t27)
    t28a = clip(t28 + t27)
    t29_ = clip(t29a + t26a)
    t30a = clip(t30 + t25)
    t31 = clip(t31a + t24a)
    t18, t21, t26, t29 = t18_, t21_, t26_, t29_

    t20 = _r181(t27a - t20a)
    t27 = _r181(t27a + t20a)
    t21a = _r181(t26 - t21)
    t26a = _r181(t26 + t21)
    t22 = _r181(t25a - t22a)
    t25 = _r181(t25a + t22a)
    t23a = _r181(t24 - t23)
    t24a = _r181(t24 + t23)

    evens = [c[o + 2 * k * s] for k in range(16)]
    odds = [t31, t30a, t29, t28a, t27, t26a, t25, t24a,
            t23a, t22, t21a, t20, t19a, t18, t17a, t16]
    for k in range(16):
        c[o + k * s] = clip(evens[k] + odds[k])
        c[o + (31 - k) * s] = clip(evens[k] - odds[k])


def dct64(c, o, s, clip):
    dct32(c, o, s * 2, clip)
    i_ = [c[o + k * s] for k in range(0, 32)]
    (in1, in3, in5, in7, in9, in11, in13, in15, in17, in19, in21, in23,
     in25, in27, in29, in31) = [i_[k] for k in range(1, 32, 2)]

    t32a = (in1 * 101 + 2048) >> 12
    t33a = (in31 * -2824 + 2048) >> 12
    t34a = (in17 * 1660 + 2048) >> 12
    t35a = (in15 * -1474 + 2048) >> 12
    t36a = (in9 * 897 + 2048) >> 12
    t37a = (in23 * -2191 + 2048) >> 12
    t38a = (in25 * 2359 + 2048) >> 12
    t39a = (in7 * -700 + 2048) >> 12
    t40a = (in5 * 501 + 2048) >> 12
    t41a = (in27 * -2520 + 2048) >> 12
    t42a = (in21 * 2019 + 2048) >> 12
    t43a = (in11 * -1092 + 2048) >> 12
    t44a = (in13 * 1285 + 2048) >> 12
    t45a = (in19 * -1842 + 2048) >> 12
    t46a = (in29 * 2675 + 2048) >> 12
    t47a = (in3 * -301 + 2048) >> 12
    t48a = (in3 * 4085 + 2048) >> 12
    t49a = (in29 * 3102 + 2048) >> 12
    t50a = (in19 * 3659 + 2048) >> 12
    t51a = (in13 * 3889 + 2048) >> 12
    t52a = (in11 * 3948 + 2048) >> 12
    t53a = (in21 * 3564 + 2048) >> 12
    t54a = (in27 * 3229 + 2048) >> 12
    t55a = (in5 * 4065 + 2048) >> 12
    t56a = (in7 * 4036 + 2048) >> 12
    t57a = (in25 * 3349 + 2048) >> 12
    t58a = (in23 * 3461 + 2048) >> 12
    t59a = (in9 * 3996 + 2048) >> 12
    t60a = (in15 * 3822 + 2048) >> 12
    t61a = (in17 * 3745 + 2048) >> 12
    t62a = (in31 * 2967 + 2048) >> 12
    t63a = (in1 * 4095 + 2048) >> 12

    t32 = clip(t32a + t33a)
    t33 = clip(t32a - t33a)
    t34 = clip(t35a - t34a)
    t35 = clip(t35a + t34a)
    t36 = clip(t36a + t37a)
    t37 = clip(t36a - t37a)
    t38 = clip(t39a - t38a)
    t39 = clip(t39a + t38a)
    t40 = clip(t40a + t41a)
    t41 = clip(t40a - t41a)
    t42 = clip(t43a - t42a)
    t43 = clip(t43a + t42a)
    t44 = clip(t44a + t45a)
    t45 = clip(t44a - t45a)
    t46 = clip(t47a - t46a)
    t47 = clip(t47a + t46a)
    t48 = clip(t48a + t49a)
    t49 = clip(t48a - t49a)
    t50 = clip(t51a - t50a)
    t51 = clip(t51a + t50a)
    t52 = clip(t52a + t53a)
    t53 = clip(t52a - t53a)
    t54 = clip(t55a - t54a)
    t55 = clip(t55a + t54a)
    t56 = clip(t56a + t57a)
    t57 = clip(t56a - t57a)
    t58 = clip(t59a - t58a)
    t59 = clip(t59a + t58a)
    t60 = clip(t60a + t61a)
    t61 = clip(t60a - t61a)
    t62 = clip(t63a - t62a)
    t63 = clip(t63a + t62a)

    t33a = _rr(t33, -4076, t62, 401)
    t34a = _rr(t34, -401, t61, -4076)
    t37a = _rr(t37, -2598, t58, 3166)
    t38a = _rr(t38, -3166, t57, -2598)
    t41a = _rr(t41, -3612, t54, 1931)
    t42a = _rr(t42, -1931, t53, -3612)
    t45a = _rr(t45, -1189, t50, 3920)
    t46a = _rr(t46, -3920, t49, -1189)
    t49a = _rr(t46, -1189, t49, 3920)
    t50a = _rr(t45, 3920, t50, 1189)
    t53a = _rr(t42, -3612, t53, 1931)
    t54a = _rr(t41, 1931, t54, 3612)
    t57a = _rr(t38, -2598, t57, 3166)
    t58a = _rr(t37, 3166, t58, 2598)
    t61a = _rr(t34, -4076, t61, 401)
    t62a = _rr(t33, 401, t62, 4076)

    t32a = clip(t32 + t35)
    t33 = clip(t33a + t34a)
    t34 = clip(t33a - t34a)
    t35a = clip(t32 - t35)
    t36a = clip(t39 - t36)
    t37 = clip(t38a - t37a)
    t38 = clip(t38a + t37a)
    t39a = clip(t39 + t36)
    t40a = clip(t40 + t43)
    t41 = clip(t41a + t42a)
    t42 = clip(t41a - t42a)
    t43a = clip(t40 - t43)
    t44a = clip(t47 - t44)
    t45 = clip(t46a - t45a)
    t46 = clip(t46a + t45a)
    t47a = clip(t47 + t44)
    t48a = clip(t48 + t51)
    t49 = clip(t49a + t50a)
    t50 = clip(t49a - t50a)
    t51a = clip(t48 - t51)
    t52a = clip(t55 - t52)
    t53 = clip(t54a - t53a)
    t54 = clip(t54a + t53a)
    t55a = clip(t55 + t52)
    t56a = clip(t56 + t59)
    t57 = clip(t57a + t58a)
    t58 = clip(t57a - t58a)
    t59a = clip(t56 - t59)
    t60a = clip(t63 - t60)
    t61 = clip(t62a - t61a)
    t62 = clip(t62a + t61a)
    t63a = clip(t63 + t60)

    t34a = _rr(t34, -4017, t61, 799)
    t35_ = _rr(t35a, -4017, t60a, 799)
    t36_ = _rr(t36a, -799, t59a, -4017)
    t37a = _rr(t37, -799, t58, -4017)
    t42a = _rr(t42, -2276, t53, 3406)
    t43_ = _rr(t43a, -2276, t52a, 3406)
    t44_ = _rr(t44a, -3406, t51a, -2276)
    t45a = _rr(t45, -3406, t50, -2276)
    t50a = _rr(t45, -2276, t50, 3406)
    t51_ = _rr(t44a, -2276, t51a, 3406)
    t52_ = _rr(t43a, 3406, t52a, 2276)
    t53a = _rr(t42, 3406, t53, 2276)
    t58a = _rr(t37, -4017, t58, 799)
    t59_ = _rr(t36a, -4017, t59a, 799)
    t60_ = _rr(t35a, 799, t60a, 4017)
    t61a = _rr(t34, 799, t61, 4017)
    t35, t36, t43, t44 = t35_, t36_, t43_, t44_
    t50, t51, t52 = t50a, t51_, t52_
    t59, t60 = t59_, t60_

    t32 = clip(t32a + t39a)
    t33a = clip(t33 + t38)
    t34_ = clip(t34a + t37a)
    t35a = clip(t35 + t36)
    t36a = clip(t35 - t36)
    t37_ = clip(t34a - t37a)
    t38a = clip(t33 - t38)
    t39 = clip(t32a - t39a)
    t40 = clip(t47a - t40a)
    t41a = clip(t46 - t41)
    t42_ = clip(t45a - t42a)
    t43a = clip(t44 - t43)
    t44a = clip(t44 + t43)
    t45_ = clip(t45a + t42a)
    t46a = clip(t46 + t41)
    t47 = clip(t47a + t40a)
    t48 = clip(t48a + t55a)
    t49a = clip(t49 + t54)
    t50_ = clip(t50 + t53a)
    t51a = clip(t51 + t52)
    t52a = clip(t51 - t52)
    t53_ = clip(t50 - t53a)
    t54a = clip(t49 - t54)
    t55 = clip(t48a - t55a)
    t56 = clip(t63a - t56a)
    t57a = clip(t62 - t57)
    t58_ = clip(t61a - t58a)
    t59a = clip(t60 - t59)
    t60a = clip(t60 + t59)
    t61_ = clip(t61a + t58a)
    t62a = clip(t62 + t57)
    t63 = clip(t63a + t56a)
    t34, t37, t42, t45 = t34_, t37_, t42_, t45_
    t50, t53, t58, t61 = t50_, t53_, t58_, t61_

    t36 = _rr(t36a, -3784, t59a, 1567)
    t37a = _rr(t37, -3784, t58, 1567)
    t38_ = _rr(t38a, -3784, t57a, 1567)
    t39a = _rr(t39, -3784, t56, 1567)
    t40a = _rr(t40, -1567, t55, -3784)
    t41_ = _rr(t41a, -1567, t54a, -3784)
    t42a = _rr(t42, -1567, t53, -3784)
    t43_ = _rr(t43a, -1567, t52a, -3784)
    t52_ = _rr(t43a, -3784, t52a, 1567)
    t53a = _rr(t42, -3784, t53, 1567)
    t54_ = _rr(t41a, -3784, t54a, 1567)
    t55a = _rr(t40, -3784, t55, 1567)
    t56a = _rr(t39, 1567, t56, 3784)
    t57_ = _rr(t38a, 1567, t57a, 3784)
    t58a = _rr(t37, 1567, t58, 3784)
    t59_ = _rr(t36a, 1567, t59a, 3784)
    t38, t41, t43 = t38_, t41_, t43_
    t52, t54, t57, t59 = t52_, t54_, t57_, t59_

    t32a = clip(t32 + t47)
    t33_ = clip(t33a + t46a)
    t34a = clip(t34 + t45)
    t35_ = clip(t35a + t44a)
    t36a = clip(t36 + t43)
    t37_ = clip(t37a + t42a)
    t38a = clip(t38 + t41)
    t39_ = clip(t39a + t40a)
    t40_ = clip(t39a - t40a)
    t41a = clip(t38 - t41)
    t42_ = clip(t37a - t42a)
    t43a = clip(t36 - t43)
    t44_ = clip(t35a - t44a)
    t45a = clip(t34 - t45)
    t46_ = clip(t33a - t46a)
    t47a = clip(t32 - t47)
    t48a = clip(t63 - t48)
    t49_ = clip(t62a - t49a)
    t50a = clip(t61 - t50)
    t51_ = clip(t60a - t51a)
    t52a = clip(t59 - t52)
    t53_ = clip(t58a - t53a)
    t54a = clip(t57 - t54)
    t55_ = clip(t56a - t55a)
    t56_ = clip(t56a + t55a)
    t57a = clip(t57 + t54)
    t58_ = clip(t58a + t53a)
    t59a = clip(t59 + t52)
    t60_ = clip(t60a + t51a)
    t61a = clip(t61 + t50)
    t62_ = clip(t62a + t49a)
    t63a = clip(t63 + t48)
    t33, t35, t37, t39 = t33_, t35_, t37_, t39_
    t40, t42, t44, t46 = t40_, t42_, t44_, t46_
    t49, t51, t53, t55 = t49_, t51_, t53_, t55_
    t56, t58, t60, t62 = t56_, t58_, t60_, t62_

    t40a = _r181(t55 - t40)
    t41_ = _r181(t54a - t41a)
    t42a = _r181(t53 - t42)
    t43_ = _r181(t52a - t43a)
    t44a = _r181(t51 - t44)
    t45_ = _r181(t50a - t45a)
    t46a = _r181(t49 - t46)
    t47_ = _r181(t48a - t47a)
    t48_ = _r181(t47a + t48a)
    t49a = _r181(t46 + t49)
    t50_ = _r181(t45a + t50a)
    t51a = _r181(t44 + t51)
    t52_ = _r181(t43a + t52a)
    t53a = _r181(t42 + t53)
    t54_ = _r181(t41a + t54a)
    t55a = _r181(t40 + t55)
    t41, t43, t45, t47 = t41_, t43_, t45_, t47_
    t48, t50, t52, t54 = t48_, t50_, t52_, t54_

    evens = [c[o + 2 * k * s] for k in range(32)]
    odds = [t63a, t62, t61a, t60, t59a, t58, t57a, t56,
            t55a, t54, t53a, t52, t51a, t50, t49a, t48,
            t47, t46a, t45, t44a, t43, t42a, t41, t40a,
            t39, t38a, t37, t36a, t35, t34a, t33, t32a]
    for k in range(32):
        c[o + k * s] = clip(evens[k] + odds[k])
        c[o + (63 - k) * s] = clip(evens[k] - odds[k])


def adst4(cin, oi, si, cout, oo, so, clip):
    in0, in1 = cin[oi], cin[oi + si]
    in2, in3 = cin[oi + 2 * si], cin[oi + 3 * si]
    cout[oo + 0 * so] = (1321 * in0 + 3803 * in2 + 2482 * in3
                         + 3344 * in1 + 2048) >> 12
    cout[oo + 1 * so] = (2482 * in0 - 1321 * in2 - 3803 * in3
                         + 3344 * in1 + 2048) >> 12
    cout[oo + 2 * so] = (209 * (in0 - in2 + in3) + 128) >> 8
    cout[oo + 3 * so] = (3803 * in0 + 2482 * in2 - 1321 * in3
                         - 3344 * in1 + 2048) >> 12


def adst8(cin, oi, si, cout, oo, so, clip):
    i_ = [cin[oi + k * si] for k in range(8)]
    in0, in1, in2, in3, in4, in5, in6, in7 = i_
    t0a = _rr(in7, 4076, in0, 401)
    t1a = _rr(in7, 401, in0, -4076)
    t2a = _rr(in5, 3612, in2, 1931)
    t3a = _rr(in5, 1931, in2, -3612)
    t4a = _rr(in3, 2598, in4, 3166)
    t5a = _rr(in3, 3166, in4, -2598)
    t6a = _rr(in1, 1189, in6, 3920)
    t7a = _rr(in1, 3920, in6, -1189)

    t0 = clip(t0a + t4a)
    t1 = clip(t1a + t5a)
    t2 = clip(t2a + t6a)
    t3 = clip(t3a + t7a)
    t4 = clip(t0a - t4a)
    t5 = clip(t1a - t5a)
    t6 = clip(t2a - t6a)
    t7 = clip(t3a - t7a)

    t4a = _rr(t4, 3784, t5, 1567)
    t5a = _rr(t4, 1567, t5, -3784)
    t6a = _rr(t7, 3784, t6, -1567)
    t7a = _rr(t7, 1567, t6, 3784)

    cout[oo + 0 * so] = clip(t0 + t2)
    cout[oo + 7 * so] = -clip(t1 + t3)
    t2 = clip(t0 - t2)
    t3 = clip(t1 - t3)
    cout[oo + 1 * so] = -clip(t4a + t6a)
    cout[oo + 6 * so] = clip(t5a + t7a)
    t6 = clip(t4a - t6a)
    t7 = clip(t5a - t7a)

    cout[oo + 3 * so] = -_r181(t2 + t3)
    cout[oo + 4 * so] = _r181(t2 - t3)
    cout[oo + 2 * so] = _r181(t6 + t7)
    cout[oo + 5 * so] = -_r181(t6 - t7)


def adst16(cin, oi, si, cout, oo, so, clip):
    i_ = [cin[oi + k * si] for k in range(16)]
    (in0, in1, in2, in3, in4, in5, in6, in7, in8, in9, in10, in11,
     in12, in13, in14, in15) = i_

    t0 = _rr(in15, 4091, in0, 201)
    t1 = _rr(in15, 201, in0, -4091)
    t2 = _rr(in13, 3973, in2, 995)
    t3 = _rr(in13, 995, in2, -3973)
    t4 = _rr(in11, 3703, in4, 1751)
    t5 = _rr(in11, 1751, in4, -3703)
    t6 = _rr(in9, 3290, in6, 2440)
    t7 = _rr(in9, 2440, in6, -3290)
    t8 = _rr(in7, 2751, in8, 3035)
    t9 = _rr(in7, 3035, in8, -2751)
    t10 = _rr(in5, 2106, in10, 3513)
    t11 = _rr(in5, 3513, in10, -2106)
    t12 = _rr(in3, 1380, in12, 3857)
    t13 = _rr(in3, 3857, in12, -1380)
    t14 = _rr(in1, 601, in14, 4052)
    t15 = _rr(in1, 4052, in14, -601)

    t0a = clip(t0 + t8)
    t1a = clip(t1 + t9)
    t2a = clip(t2 + t10)
    t3a = clip(t3 + t11)
    t4a = clip(t4 + t12)
    t5a = clip(t5 + t13)
    t6a = clip(t6 + t14)
    t7a = clip(t7 + t15)
    t8a = clip(t0 - t8)
    t9a = clip(t1 - t9)
    t10a = clip(t2 - t10)
    t11a = clip(t3 - t11)
    t12a = clip(t4 - t12)
    t13a = clip(t5 - t13)
    t14a = clip(t6 - t14)
    t15a = clip(t7 - t15)

    t8 = _rr(t8a, 4017, t9a, 799)
    t9 = _rr(t8a, 799, t9a, -4017)
    t10 = _rr(t10a, 2276, t11a, 3406)
    t11 = _rr(t10a, 3406, t11a, -2276)
    t12 = _rr(t13a, 4017, t12a, -799)
    t13 = _rr(t13a, 799, t12a, 4017)
    t14 = _rr(t15a, 2276, t14a, -3406)
    t15 = _rr(t15a, 3406, t14a, 2276)

    t0 = clip(t0a + t4a)
    t1 = clip(t1a + t5a)
    t2 = clip(t2a + t6a)
    t3 = clip(t3a + t7a)
    t4 = clip(t0a - t4a)
    t5 = clip(t1a - t5a)
    t6 = clip(t2a - t6a)
    t7 = clip(t3a - t7a)
    t8a = clip(t8 + t12)
    t9a = clip(t9 + t13)
    t10a = clip(t10 + t14)
    t11a = clip(t11 + t15)
    t12a = clip(t8 - t12)
    t13a = clip(t9 - t13)
    t14a = clip(t10 - t14)
    t15a = clip(t11 - t15)

    t4a = _rr(t4, 3784, t5, 1567)
    t5a = _rr(t4, 1567, t5, -3784)
    t6a = _rr(t7, 3784, t6, -1567)
    t7a = _rr(t7, 1567, t6, 3784)
    t12 = _rr(t12a, 3784, t13a, 1567)
    t13 = _rr(t12a, 1567, t13a, -3784)
    t14 = _rr(t15a, 3784, t14a, -1567)
    t15 = _rr(t15a, 1567, t14a, 3784)

    cout[oo + 0 * so] = clip(t0 + t2)
    cout[oo + 15 * so] = -clip(t1 + t3)
    t2a = clip(t0 - t2)
    t3a = clip(t1 - t3)
    cout[oo + 3 * so] = -clip(t4a + t6a)
    cout[oo + 12 * so] = clip(t5a + t7a)
    t6 = clip(t4a - t6a)
    t7 = clip(t5a - t7a)
    cout[oo + 1 * so] = -clip(t8a + t10a)
    cout[oo + 14 * so] = clip(t9a + t11a)
    t10 = clip(t8a - t10a)
    t11 = clip(t9a - t11a)
    cout[oo + 2 * so] = clip(t12 + t14)
    cout[oo + 13 * so] = -clip(t13 + t15)
    t14a = clip(t12 - t14)
    t15a = clip(t13 - t15)

    cout[oo + 7 * so] = -_r181(t2a + t3a)
    cout[oo + 8 * so] = _r181(t2a - t3a)
    cout[oo + 4 * so] = _r181(t6 + t7)
    cout[oo + 11 * so] = -_r181(t6 - t7)
    cout[oo + 6 * so] = _r181(t10 + t11)
    cout[oo + 9 * so] = -_r181(t10 - t11)
    cout[oo + 5 * so] = -_r181(t14a + t15a)
    cout[oo + 10 * so] = _r181(t14a - t15a)


def identity(n):
    def fn(c, o, s, clip):
        if n == 4:
            for i in range(4):
                v = c[o + s * i]
                c[o + s * i] = v + ((v * 1697 + 2048) >> 12)
        elif n == 8:
            for i in range(8):
                c[o + s * i] *= 2
        elif n == 16:
            for i in range(16):
                v = c[o + s * i]
                c[o + s * i] = 2 * v + ((v * 1697 + 1024) >> 11)
        else:
            for i in range(32):
                c[o + s * i] *= 4
    return fn


def wht4(c, o, s):
    in0, in1, in2, in3 = c[o], c[o + s], c[o + 2 * s], c[o + 3 * s]
    t0 = in0 + in1
    t2 = in2 - in3
    t4 = (t0 - t2) >> 1
    t3 = t4 - in3
    t1 = t4 - in1
    c[o + 0 * s] = t0 - t3
    c[o + 1 * s] = t3
    c[o + 2 * s] = t1
    c[o + 3 * s] = t2 + t1


def _adst_dispatch(n, flip):
    base = {4: adst4, 8: adst8, 16: adst16}[n]

    def fn(c, o, s, clip):
        if flip:
            base(c, o, s, c, o + (n - 1) * s, -s, clip)
        else:
            base(c, o, s, c, o, s, clip)
    return fn


_1D_FNS = {}
for _lsz, _n in ((0, 4), (1, 8), (2, 16), (3, 32), (4, 64)):
    _1D_FNS[(_lsz, DCT)] = {4: dct4, 8: dct8, 16: dct16,
                            32: dct32, 64: dct64}[_n]
    if _n <= 16:
        _1D_FNS[(_lsz, ADST)] = _adst_dispatch(_n, False)
        _1D_FNS[(_lsz, FLIPADST)] = _adst_dispatch(_n, True)
    if _n <= 32:
        _1D_FNS[(_lsz, IDENTITY)] = identity(_n)


def add_residual(plane, dst_y, dst_x, r, bitdepth):
    """Clipped residual add at (dst_y, dst_x) (the replay-side half of
    reference inv_txfm_add, src/itx_tmpl.c:118)."""
    h, w = r.shape
    if _native is not None and r.flags["C_CONTIGUOUS"]:
        if r.dtype == np.int32:
            _native.dtpu_add_residual(
                plane.ctypes.data, plane.shape[1], dst_y, dst_x,
                r.ctypes.data, h, w, (1 << bitdepth) - 1)
            return
        if r.dtype == np.int16:
            _native.dtpu_add_residual16(
                plane.ctypes.data, plane.shape[1], dst_y, dst_x,
                r.ctypes.data, h, w, (1 << bitdepth) - 1)
            return
    dst = plane[dst_y : dst_y + h, dst_x : dst_x + w]
    np.clip(dst + r, 0, (1 << bitdepth) - 1, out=dst)


def itx_add_cached(t, plane, dst_y, dst_x, tx, txtp, cf, eob, bitdepth):
    """itx_add, but in pass-2 replay prefer the residual precomputed by
    the batched pass-2 stage (dav1d_tpu.pipeline): the inverse transform
    depends only on the coefficients, so pipeline.run_pass2 evaluates all
    of them up front in (tx, txtp)-grouped batches and replay just adds."""
    rec = getattr(t, "cur_rec", None)
    if t.pass_ == 2 and rec is not None:
        resid_list = rec.get("resid")
        if resid_list is not None:
            r = resid_list[t.rec_coef_pos - 1]
            if r is not None:
                add_residual(plane, dst_y, dst_x, r, bitdepth)
                return
    itx_add(plane, dst_y, dst_x, tx, txtp, cf, eob, bitdepth)


def itx_add(plane, dst_y, dst_x, tx, txtp, cf, eob, bitdepth):
    """2-D inverse transform + add (reference inv_txfm_add_c,
    src/itx_tmpl.c:44-121). cf is the column-major coefficient vector."""
    t_dim = tables.txfm_info()[tx]
    w = 4 * int(t_dim[0])
    h = 4 * int(t_dim[1])
    lw, lh = int(t_dim[2]), int(t_dim[3])
    maxp = (1 << bitdepth) - 1
    dst = plane[dst_y : dst_y + h, dst_x : dst_x + w]

    if txtp == TxfmType.WHT_WHT:
        tmp = [0] * 16
        for y in range(4):
            for x in range(4):
                tmp[y * 4 + x] = int(cf[y + x * 4]) >> 2
        for y in range(4):
            wht4(tmp, y * 4, 1)
        for x in range(4):
            wht4(tmp, x, 4)
        blk = np.array(tmp, dtype=np.int64).reshape(4, 4)
        np.clip(dst + blk, 0, maxp, out=dst)
        return

    is_rect2 = w * 2 == h or h * 2 == w
    shift = TX_SHIFT[tx]
    rnd = (1 << shift) >> 1
    has_dconly = txtp == TxfmType.DCT_DCT

    if eob < has_dconly:
        dc = int(cf[0])
        if is_rect2:
            dc = (dc * 181 + 128) >> 8
        dc = (dc * 181 + 128) >> 8
        dc = (dc + rnd) >> shift
        dc = (dc * 181 + 128 + 2048) >> 12
        np.clip(dst + dc, 0, maxp, out=dst)
        return

    row_t, col_t = TX1D_TYPES[txtp]
    sh = min(h, 32)
    sw = min(w, 32)
    if bitdepth == 8:
        row_min = col_min = -(1 << 15)
    else:
        row_min = -(maxp + 1) << 7
        col_min = -(maxp + 1) << 5
    row_max = ~row_min
    col_max = ~col_min

    def rclip(v):
        return np.clip(v, row_min, row_max)

    def cclip(v):
        return np.clip(v, col_min, col_max)

    first_fn = _1D_FNS[(lw, row_t)]
    second_fn = _1D_FNS[(lh, col_t)]

    if w * h >= 256:
        # lane formulation (same shape as the batched device kernel,
        # dav1d_tpu.ops.itx): the 1-D kernels are polymorphic over the
        # lane container -- here each lane is an int64 numpy vector
        grid = np.asarray(cf[: sw * sh], dtype=np.int64).reshape(sw, sh)
        if is_rect2:
            grid = (grid * 181 + 128) >> 8
        zrow = np.zeros(sh, dtype=np.int64)
        lanes = [grid[x].copy() if x < sw else zrow.copy()
                 for x in range(w)]
        first_fn(lanes, 0, 1, rclip)
        mid = cclip((np.stack(lanes, axis=1) + rnd) >> shift)  # (sh, w)
        zcol = np.zeros(w, dtype=np.int64)
        lanes = [mid[y].copy() if y < sh else zcol.copy()
                 for y in range(h)]
        second_fn(lanes, 0, 1, cclip)
        blk = np.stack(lanes, axis=0)  # (h, w)
        np.clip(dst + ((blk + 8) >> 4), 0, maxp, out=dst)
        return

    # small transforms: scalar lanes beat numpy per-op overhead
    def rclip_s(v):
        return min(max(v, row_min), row_max)

    def cclip_s(v):
        return min(max(v, col_min), col_max)

    tmp = [0] * (w * h)
    for y in range(sh):
        if is_rect2:
            for x in range(sw):
                tmp[y * w + x] = (int(cf[y + x * sh]) * 181 + 128) >> 8
        else:
            for x in range(sw):
                tmp[y * w + x] = int(cf[y + x * sh])
        first_fn(tmp, y * w, 1, rclip_s)
    for i in range(w * sh):
        tmp[i] = cclip_s((tmp[i] + rnd) >> shift)
    for x in range(w):
        second_fn(tmp, x, w, cclip_s)
    blk = np.array(tmp, dtype=np.int64).reshape(h, w)
    np.clip(dst + ((blk + 8) >> 4), 0, maxp, out=dst)
