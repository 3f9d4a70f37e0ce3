"""Neighbour-context derivation for inter symbols (reference src/env.h)."""

from __future__ import annotations

from .levels import CompInterType


def get_comp_ctx(a, l, yb4, xb4, have_top, have_left):
    if have_top:
        if have_left:
            if a.comp_type[xb4]:
                if l.comp_type[yb4]:
                    return 4
                return 2 + (int(l.ref[0][yb4]) >= 4 or int(l.ref[0][yb4]) < 0)
            if l.comp_type[yb4]:
                return 2 + (int(a.ref[0][xb4]) >= 4 or int(a.ref[0][xb4]) < 0)
            return int((int(l.ref[0][yb4]) >= 4) ^ (int(a.ref[0][xb4]) >= 4))
        return 3 if a.comp_type[xb4] else int(int(a.ref[0][xb4]) >= 4)
    if have_left:
        return 3 if l.comp_type[yb4] else int(int(l.ref[0][yb4]) >= 4)
    return 1


def _has_uni_comp(edge, off):
    return (int(edge.ref[0][off]) < 4) == (int(edge.ref[1][off]) < 4)


def get_comp_dir_ctx(a, l, yb4, xb4, have_top, have_left):
    if have_top and have_left:
        a_intra, l_intra = a.intra[xb4], l.intra[yb4]
        if a_intra and l_intra:
            return 2
        if a_intra or l_intra:
            edge, off = (l, yb4) if a_intra else (a, xb4)
            if edge.comp_type[off] == CompInterType.NONE:
                return 2
            return 1 + 2 * _has_uni_comp(edge, off)
        a_comp = a.comp_type[xb4] != CompInterType.NONE
        l_comp = l.comp_type[yb4] != CompInterType.NONE
        a_ref0, l_ref0 = int(a.ref[0][xb4]), int(l.ref[0][yb4])
        if not a_comp and not l_comp:
            return 1 + 2 * ((a_ref0 >= 4) == (l_ref0 >= 4))
        if not a_comp or not l_comp:
            edge, off = (a, xb4) if a_comp else (l, yb4)
            if not _has_uni_comp(edge, off):
                return 1
            return 3 + ((a_ref0 >= 4) == (l_ref0 >= 4))
        a_uni, l_uni = _has_uni_comp(a, xb4), _has_uni_comp(l, yb4)
        if not a_uni and not l_uni:
            return 0
        if not a_uni or not l_uni:
            return 2
        return 3 + ((a_ref0 == 4) == (l_ref0 == 4))
    if have_top or have_left:
        edge, off = (l, yb4) if have_left else (a, xb4)
        if edge.intra[off]:
            return 2
        if edge.comp_type[off] == CompInterType.NONE:
            return 2
        return 4 * _has_uni_comp(edge, off)
    return 2


def get_jnt_comp_ctx(order_hint_n_bits, poc, ref0poc, ref1poc, a, l, yb4, xb4):
    from .obu import get_poc_diff
    d0 = abs(get_poc_diff(order_hint_n_bits, ref0poc, poc))
    d1 = abs(get_poc_diff(order_hint_n_bits, poc, ref1poc))
    offset = int(d0 == d1)
    a_ctx = int(a.comp_type[xb4] >= CompInterType.AVG
                or int(a.ref[0][xb4]) == 6)
    l_ctx = int(l.comp_type[yb4] >= CompInterType.AVG
                or int(l.ref[0][yb4]) == 6)
    return 3 * offset + a_ctx + l_ctx


def get_mask_comp_ctx(a, l, yb4, xb4):
    a_ctx = 1 if a.comp_type[xb4] >= CompInterType.SEG else \
        (3 if int(a.ref[0][xb4]) == 6 else 0)
    l_ctx = 1 if l.comp_type[yb4] >= CompInterType.SEG else \
        (3 if int(l.ref[0][yb4]) == 6 else 0)
    return min(a_ctx + l_ctx, 5)


def get_filter_ctx(a, l, comp, dir_, ref, yb4, xb4):
    a_filter = int(a.filter[dir_][xb4]) if (
        int(a.ref[0][xb4]) == ref or int(a.ref[1][xb4]) == ref) else 3
    l_filter = int(l.filter[dir_][yb4]) if (
        int(l.ref[0][yb4]) == ref or int(l.ref[1][yb4]) == ref) else 3
    if a_filter == l_filter:
        return comp * 4 + a_filter
    if a_filter == 3:
        return comp * 4 + l_filter
    if l_filter == 3:
        return comp * 4 + a_filter
    return comp * 4 + 3


def _cnt_cmp(c0, c1):
    return 1 if c0 == c1 else (0 if c0 < c1 else 2)


def _gather(a, l, yb4, xb4, have_top, have_left, fn):
    cnt = [0, 0, 0, 0, 0, 0, 0]
    if have_top and not a.intra[xb4]:
        fn(cnt, int(a.ref[0][xb4]))
        if a.comp_type[xb4]:
            fn(cnt, int(a.ref[1][xb4]))
    if have_left and not l.intra[yb4]:
        fn(cnt, int(l.ref[0][yb4]))
        if l.comp_type[yb4]:
            fn(cnt, int(l.ref[1][yb4]))
    return cnt


def av1_get_ref_ctx(a, l, yb4, xb4, have_top, have_left):
    def fn(cnt, r):
        cnt[int(r >= 4)] += 1
    c = _gather(a, l, yb4, xb4, have_top, have_left, fn)
    return _cnt_cmp(c[0], c[1])


def av1_get_fwd_ref_ctx(a, l, yb4, xb4, have_top, have_left):
    def fn(cnt, r):
        if 0 <= r < 4:
            cnt[r] += 1
    c = _gather(a, l, yb4, xb4, have_top, have_left, fn)
    return _cnt_cmp(c[0] + c[1], c[2] + c[3])


def av1_get_fwd_ref_1_ctx(a, l, yb4, xb4, have_top, have_left):
    def fn(cnt, r):
        if 0 <= r < 2:
            cnt[r] += 1
    c = _gather(a, l, yb4, xb4, have_top, have_left, fn)
    return _cnt_cmp(c[0], c[1])


def av1_get_fwd_ref_2_ctx(a, l, yb4, xb4, have_top, have_left):
    def fn(cnt, r):
        if r >= 0 and (r ^ 2) < 2:
            cnt[r - 2] += 1
    c = _gather(a, l, yb4, xb4, have_top, have_left, fn)
    return _cnt_cmp(c[0], c[1])


def av1_get_bwd_ref_ctx(a, l, yb4, xb4, have_top, have_left):
    def fn(cnt, r):
        if r >= 4:
            cnt[r - 4] += 1
    c = _gather(a, l, yb4, xb4, have_top, have_left, fn)
    return _cnt_cmp(c[1] + c[0], c[2])


def av1_get_bwd_ref_1_ctx(a, l, yb4, xb4, have_top, have_left):
    def fn(cnt, r):
        if r >= 4:
            cnt[r - 4] += 1
    c = _gather(a, l, yb4, xb4, have_top, have_left, fn)
    return _cnt_cmp(c[0], c[1])


def av1_get_uni_p1_ctx(a, l, yb4, xb4, have_top, have_left):
    def fn(cnt, r):
        if 0 <= r - 1 < 3:
            cnt[r - 1] += 1
    c = _gather(a, l, yb4, xb4, have_top, have_left, fn)
    return _cnt_cmp(c[0], c[1] + c[2])


av1_get_ref_2_ctx = av1_get_bwd_ref_ctx
av1_get_ref_3_ctx = av1_get_fwd_ref_ctx
av1_get_ref_4_ctx = av1_get_fwd_ref_1_ctx
av1_get_ref_5_ctx = av1_get_fwd_ref_2_ctx
av1_get_ref_6_ctx = av1_get_bwd_ref_1_ctx
av1_get_uni_p_ctx = av1_get_ref_ctx
av1_get_uni_p2_ctx = av1_get_fwd_ref_2_ctx


def get_drl_context(mvstack, ref_idx):
    if mvstack[ref_idx]["weight"] >= 640:
        return int(mvstack[ref_idx + 1]["weight"] < 640)
    return 2 if mvstack[ref_idx + 1]["weight"] < 640 else 0


def findoddzero(arr, off, n):
    """any intra[off + 2*i + 1] == 0 for i < n (reference env.h
    findoddzero over &buf[1])."""
    for i in range(n):
        if not arr[off + i * 2]:
            return True
    return False