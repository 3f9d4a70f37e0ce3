/* Native deblocking loop filter: one 4px-aligned strip per call.
 *
 * Bit-exact port of the Python reference (dav1d_tpu/recon/lf.py
 * _loop_filter + _lf_sb); semantics follow the reference loop_filter /
 * loop_filter_sb128{y,uv} (src/loopfilter_tmpl.c:36-241).  Filtering is
 * immediate and in mask order — the reference's serial order — which the
 * batched Python path is already proven equivalent to (segments within a
 * pass have disjoint read/write sets).
 *
 * Planes are the decoder's int32 canvases; levels are the (h4, b4_stride,
 * 4) uint8 cache; E/I LUTs are the 64-entry int32 tables from calc_eih.
 */

#include <stdint.h>
#include <stddef.h>
#include <stdlib.h>

static inline int lf_clip(int v, int lo, int hi)
{
    return v < lo ? lo : v > hi ? hi : v;
}

/* Filter 4 lines across one edge.  px0 points at q0 of line 0; `line`
 * advances lines, `step` advances taps (both in elements). */
static void lf_edge4(int32_t *px0, ptrdiff_t line, ptrdiff_t step,
                     int E, int I, int H, int wd, int bitdepth)
{
    const int bd_m8 = bitdepth - 8;
    const int F = 1 << bd_m8;
    const int maxp = (1 << bitdepth) - 1;
    const int cd_lim = 128 << bd_m8;
    E <<= bd_m8;
    I <<= bd_m8;
    H <<= bd_m8;

    for (int i = 0; i < 4; i++, px0 += line) {
        int32_t *p = px0;
#define GET(o) ((int)p[(ptrdiff_t)(o) * step])
#define PUT(o, v) (p[(ptrdiff_t)(o) * step] = (int32_t)(v))
        const int p1 = GET(-2), p0 = GET(-1), q0 = GET(0), q1 = GET(1);
        int fm = abs(p1 - p0) <= I && abs(q1 - q0) <= I &&
                 abs(p0 - q0) * 2 + (abs(p1 - q1) >> 1) <= E;
        int p2 = 0, q2 = 0, p3 = 0, q3 = 0;
        if (wd > 4) {
            p2 = GET(-3);
            q2 = GET(2);
            fm = fm && abs(p2 - p1) <= I && abs(q2 - q1) <= I;
            if (wd > 6) {
                p3 = GET(-4);
                q3 = GET(3);
                fm = fm && abs(p3 - p2) <= I && abs(q3 - q2) <= I;
            }
        }
        if (!fm)
            continue;

        int flat8out = 0;
        int p6 = 0, p5 = 0, p4 = 0, q4 = 0, q5 = 0, q6 = 0;
        if (wd >= 16) {
            p6 = GET(-7);
            p5 = GET(-6);
            p4 = GET(-5);
            q4 = GET(4);
            q5 = GET(5);
            q6 = GET(6);
            flat8out = abs(p6 - p0) <= F && abs(p5 - p0) <= F &&
                       abs(p4 - p0) <= F && abs(q4 - q0) <= F &&
                       abs(q5 - q0) <= F && abs(q6 - q0) <= F;
        }
        int flat8in = 0;
        if (wd >= 6)
            flat8in = abs(p2 - p0) <= F && abs(p1 - p0) <= F &&
                      abs(q1 - q0) <= F && abs(q2 - q0) <= F;
        if (wd >= 8)
            flat8in = flat8in && abs(p3 - p0) <= F && abs(q3 - q0) <= F;

        if (wd >= 16 && flat8out && flat8in) {
            PUT(-6, (p6 * 7 + p5 * 2 + p4 * 2 + p3 + p2 + p1 + p0 + q0
                     + 8) >> 4);
            PUT(-5, (p6 * 5 + p5 * 2 + p4 * 2 + p3 * 2 + p2 + p1 + p0 + q0
                     + q1 + 8) >> 4);
            PUT(-4, (p6 * 4 + p5 + p4 * 2 + p3 * 2 + p2 * 2 + p1 + p0 + q0
                     + q1 + q2 + 8) >> 4);
            PUT(-3, (p6 * 3 + p5 + p4 + p3 * 2 + p2 * 2 + p1 * 2 + p0 + q0
                     + q1 + q2 + q3 + 8) >> 4);
            PUT(-2, (p6 * 2 + p5 + p4 + p3 + p2 * 2 + p1 * 2 + p0 * 2 + q0
                     + q1 + q2 + q3 + q4 + 8) >> 4);
            PUT(-1, (p6 + p5 + p4 + p3 + p2 + p1 * 2 + p0 * 2 + q0 * 2
                     + q1 + q2 + q3 + q4 + q5 + 8) >> 4);
            PUT(0, (p5 + p4 + p3 + p2 + p1 + p0 * 2 + q0 * 2 + q1 * 2
                    + q2 + q3 + q4 + q5 + q6 + 8) >> 4);
            PUT(1, (p4 + p3 + p2 + p1 + p0 + q0 * 2 + q1 * 2 + q2 * 2
                    + q3 + q4 + q5 + q6 * 2 + 8) >> 4);
            PUT(2, (p3 + p2 + p1 + p0 + q0 + q1 * 2 + q2 * 2 + q3 * 2
                    + q4 + q5 + q6 * 3 + 8) >> 4);
            PUT(3, (p2 + p1 + p0 + q0 + q1 + q2 * 2 + q3 * 2 + q4 * 2
                    + q5 + q6 * 4 + 8) >> 4);
            PUT(4, (p1 + p0 + q0 + q1 + q2 + q3 * 2 + q4 * 2 + q5 * 2
                    + q6 * 5 + 8) >> 4);
            PUT(5, (p0 + q0 + q1 + q2 + q3 + q4 * 2 + q5 * 2 + q6 * 7
                    + 8) >> 4);
        } else if (wd >= 8 && flat8in) {
            PUT(-3, (p3 + p3 + p3 + 2 * p2 + p1 + p0 + q0 + 4) >> 3);
            PUT(-2, (p3 + p3 + p2 + 2 * p1 + p0 + q0 + q1 + 4) >> 3);
            PUT(-1, (p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2 + 4) >> 3);
            PUT(0, (p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3 + 4) >> 3);
            PUT(1, (p1 + p0 + q0 + 2 * q1 + q2 + q3 + q3 + 4) >> 3);
            PUT(2, (p0 + q0 + q1 + 2 * q2 + q3 + q3 + q3 + 4) >> 3);
        } else if (wd == 6 && flat8in) {
            PUT(-2, (p2 + 2 * p2 + 2 * p1 + 2 * p0 + q0 + 4) >> 3);
            PUT(-1, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3);
            PUT(0, (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3);
            PUT(1, (p0 + 2 * q0 + 2 * q1 + 2 * q2 + q2 + 4) >> 3);
        } else {
            const int hev = abs(p1 - p0) > H || abs(q1 - q0) > H;
            int f;
            if (hev) {
                f = lf_clip(p1 - q1, -cd_lim, cd_lim - 1);
                f = lf_clip(3 * (q0 - p0) + f, -cd_lim, cd_lim - 1);
            } else {
                f = lf_clip(3 * (q0 - p0), -cd_lim, cd_lim - 1);
            }
            const int f1 = (f + 4 < cd_lim - 1 ? f + 4 : cd_lim - 1) >> 3;
            const int f2 = (f + 3 < cd_lim - 1 ? f + 3 : cd_lim - 1) >> 3;
            PUT(-1, lf_clip(p0 + f2, 0, maxp));
            PUT(0, lf_clip(q0 - f1, 0, maxp));
            if (!hev) {
                const int g = (f1 + 1) >> 1;
                PUT(-2, lf_clip(p1 + g, 0, maxp));
                PUT(1, lf_clip(q1 - g, 0, maxp));
            }
        }
#undef GET
#undef PUT
    }
}

/* Horizontal-edge variant: the 4 filtered lines are CONTIGUOUS pixels
 * (taps step by the plane stride), so the whole edge rides one 4-lane
 * int32 vector per tap — a branchless mask-blend port of the scalar
 * form above (the masked formulation recon/lf.py _loop_filter_batch
 * uses), bit-exact by the same arithmetic. */
typedef int32_t lf_v4 __attribute__((vector_size(16), aligned(4),
                                     may_alias));

static inline lf_v4 lfv_abs(lf_v4 v)
{
    const lf_v4 m = v < 0;
    return (v ^ m) - m;
}

static inline lf_v4 lfv_blend(lf_v4 m, lf_v4 a, lf_v4 b)
{
    return (a & m) | (b & ~m);
}

static inline lf_v4 lfv_clamp(lf_v4 v, lf_v4 lo, lf_v4 hi)
{
    v = lfv_blend(v < lo, lo, v);
    return lfv_blend(v > hi, hi, v);
}

typedef int32_t lf_v8 __attribute__((vector_size(32), aligned(4),
                                     may_alias));

#define LF_CORE_NAME lf_core4_impl
#define LF_VT lf_v4
#define LF_NL 4
#include "lf_core.h"

#define LF_CORE_NAME lf_core8_impl
#define LF_VT lf_v8
#define LF_NL 8
#include "lf_core.h"

static int lf_core4(lf_v4 *t, int E, int I, int H, int wd,
                    int bitdepth)
{
    const int bd_m8 = bitdepth - 8;
    const lf_v4 zero = {0};
    return lf_core4_impl(t, zero + (E << bd_m8), zero + (I << bd_m8),
                         zero + (H << bd_m8), wd, bitdepth);
}


static void lf_edge4_h(int32_t *px0, ptrdiff_t stride, int E, int I,
                       int H, int wd, int bitdepth)
{
    const int lo = wd >= 16 ? -7 : wd >= 8 ? -4 : wd == 6 ? -3 : -2;
    const int hi = wd >= 16 ? 6 : wd >= 8 ? 3 : wd == 6 ? 2 : 1;
    lf_v4 t[14];
    for (int o = lo; o <= hi; o++)
        t[o + 7] = *(const lf_v4 *)(px0 + (ptrdiff_t)o * stride);
    if (!lf_core4(t, E, I, H, wd, bitdepth))
        return;
    const int slo = wd >= 16 ? -6 : wd >= 8 ? -3 : -2;
    const int shi = wd >= 16 ? 5 : wd >= 8 ? 2 : 1;
    for (int o = slo; o <= shi; o++)
        *(lf_v4 *)(px0 + (ptrdiff_t)o * stride) = t[o + 7];
}

static inline void lf_tr4(lf_v4 *a, lf_v4 *b, lf_v4 *c, lf_v4 *d)
{
    const lf_v4 t0 = __builtin_shufflevector(*a, *b, 0, 4, 1, 5);
    const lf_v4 t1 = __builtin_shufflevector(*a, *b, 2, 6, 3, 7);
    const lf_v4 t2 = __builtin_shufflevector(*c, *d, 0, 4, 1, 5);
    const lf_v4 t3 = __builtin_shufflevector(*c, *d, 2, 6, 3, 7);
    *a = __builtin_shufflevector(t0, t2, 0, 1, 4, 5);
    *b = __builtin_shufflevector(t0, t2, 2, 3, 6, 7);
    *c = __builtin_shufflevector(t1, t3, 0, 1, 4, 5);
    *d = __builtin_shufflevector(t1, t3, 2, 3, 6, 7);
}

/* Vertical-edge variant: taps run along the rows, so the 4 edge lines
 * load as 4 row segments and transpose into per-tap vectors (4x4
 * shuffle transposes), run the same masked core, and transpose back.
 * Window sizes match the scalar reads: 8 columns from -4 below wd16
 * (vertical edges start at x >= 4), 16 from -8 at wd16 (x >= 16 by
 * transform geometry). */
static void lf_edge4_v(int32_t *px0, ptrdiff_t stride, int E, int I,
                       int H, int wd, int bitdepth)
{
    lf_v4 g[4][4]; /* [col group][row] */
    const int wide = wd >= 16;
    const int ng = wide ? 4 : 2;
    const int base = wide ? -8 : -4;
    for (int r = 0; r < 4; r++) {
        const int32_t *row = px0 + (ptrdiff_t)r * stride + base;
        for (int gi = 0; gi < ng; gi++)
            g[gi][r] = *(const lf_v4 *)(row + 4 * gi);
    }
    for (int gi = 0; gi < ng; gi++)
        lf_tr4(&g[gi][0], &g[gi][1], &g[gi][2], &g[gi][3]);
    /* column j of the window = g[j>>2][j&3]; tap o = column o - base */
    lf_v4 t[14];
    const int lo = wide ? -7 : wd >= 8 ? -4 : wd == 6 ? -3 : -2;
    const int hi = wide ? 6 : wd >= 8 ? 3 : wd == 6 ? 2 : 1;
    for (int o = lo; o <= hi; o++) {
        const int j = o - base;
        t[o + 7] = g[j >> 2][j & 3];
    }
    if (!lf_core4(t, E, I, H, wd, bitdepth))
        return;
    const int slo = wide ? -6 : wd >= 8 ? -3 : -2;
    const int shi = wide ? 5 : wd >= 8 ? 2 : 1;
    for (int o = slo; o <= shi; o++) {
        const int j = o - base;
        g[j >> 2][j & 3] = t[o + 7];
    }
    for (int gi = 0; gi < ng; gi++)
        lf_tr4(&g[gi][0], &g[gi][1], &g[gi][2], &g[gi][3]);
    for (int r = 0; r < 4; r++) {
        int32_t *row = px0 + (ptrdiff_t)r * stride + base;
        for (int gi = 0; gi < ng; gi++)
            *(lf_v4 *)(row + 4 * gi) = g[gi][r];
    }
}

/* Paired horizontal-edge filter: two adjacent 4px cells of the same
 * edge (8 contiguous columns) with the same width class but their own
 * strengths ride one 8-lane pass (low lanes = left cell). */
static void lf_edge8_h(int32_t *px0, ptrdiff_t stride, int EA, int IA,
                       int HA, int EB, int IB, int HB, int wd,
                       int bitdepth)
{
    const int bd_m8 = bitdepth - 8;
    const lf_v8 zero = {0};
    const lf_v8 lo = {-1, -1, -1, -1, 0, 0, 0, 0};
    lf_v8 vE = ((zero + (EA << bd_m8)) & lo) |
               ((zero + (EB << bd_m8)) & ~lo);
    lf_v8 vI = ((zero + (IA << bd_m8)) & lo) |
               ((zero + (IB << bd_m8)) & ~lo);
    lf_v8 vH = ((zero + (HA << bd_m8)) & lo) |
               ((zero + (HB << bd_m8)) & ~lo);
    const int tlo = wd >= 16 ? -7 : wd >= 8 ? -4 : wd == 6 ? -3 : -2;
    const int thi = wd >= 16 ? 6 : wd >= 8 ? 3 : wd == 6 ? 2 : 1;
    lf_v8 t[14];
    for (int o = tlo; o <= thi; o++)
        __builtin_memcpy(&t[o + 7], px0 + (ptrdiff_t)o * stride, 32);
    if (!lf_core8_impl(t, vE, vI, vH, wd, bitdepth))
        return;
    const int slo = wd >= 16 ? -6 : wd >= 8 ? -3 : -2;
    const int shi = wd >= 16 ? 5 : wd >= 8 ? 2 : 1;
    for (int o = slo; o <= shi; o++)
        __builtin_memcpy(px0 + (ptrdiff_t)o * stride, &t[o + 7], 32);
}

/* Paired vertical-edge filter: two vertically adjacent 4-line cells of
 * the same column edge (8 consecutive rows), same width class, own
 * strengths (low lanes = upper cell). */
static void lf_edge8_v(int32_t *px0, ptrdiff_t stride, int EA, int IA,
                       int HA, int EB, int IB, int HB, int wd,
                       int bitdepth)
{
    const int bd_m8 = bitdepth - 8;
    const lf_v8 zero = {0};
    const lf_v8 lo = {-1, -1, -1, -1, 0, 0, 0, 0};
    lf_v8 vE = ((zero + (EA << bd_m8)) & lo) |
               ((zero + (EB << bd_m8)) & ~lo);
    lf_v8 vI = ((zero + (IA << bd_m8)) & lo) |
               ((zero + (IB << bd_m8)) & ~lo);
    lf_v8 vH = ((zero + (HA << bd_m8)) & lo) |
               ((zero + (HB << bd_m8)) & ~lo);
    const int wide = wd >= 16;
    const int ng = wide ? 4 : 2;
    const int base = wide ? -8 : -4;
    lf_v4 g[2][4][4]; /* [half][col group][row] */
    for (int h = 0; h < 2; h++)
        for (int r = 0; r < 4; r++) {
            const int32_t *row =
                px0 + (ptrdiff_t)(4 * h + r) * stride + base;
            for (int gi = 0; gi < ng; gi++)
                g[h][gi][r] = *(const lf_v4 *)(row + 4 * gi);
        }
    for (int h = 0; h < 2; h++)
        for (int gi = 0; gi < ng; gi++)
            lf_tr4(&g[h][gi][0], &g[h][gi][1], &g[h][gi][2],
                   &g[h][gi][3]);
    lf_v8 t[14];
    const int tlo = wide ? -7 : wd >= 8 ? -4 : wd == 6 ? -3 : -2;
    const int thi = wide ? 6 : wd >= 8 ? 3 : wd == 6 ? 2 : 1;
    for (int o = tlo; o <= thi; o++) {
        const int j = o - base;
        const lf_v4 a = g[0][j >> 2][j & 3], b = g[1][j >> 2][j & 3];
        t[o + 7] = __builtin_shufflevector(a, b, 0, 1, 2, 3, 4, 5, 6, 7);
    }
    if (!lf_core8_impl(t, vE, vI, vH, wd, bitdepth))
        return;
    const int slo = wide ? -6 : wd >= 8 ? -3 : -2;
    const int shi = wide ? 5 : wd >= 8 ? 2 : 1;
    for (int o = slo; o <= shi; o++) {
        const int j = o - base;
        const lf_v8 v = t[o + 7];
        g[0][j >> 2][j & 3] =
            __builtin_shufflevector(v, v, 0, 1, 2, 3);
        g[1][j >> 2][j & 3] =
            __builtin_shufflevector(v, v, 4, 5, 6, 7);
    }
    for (int h = 0; h < 2; h++)
        for (int gi = 0; gi < ng; gi++)
            lf_tr4(&g[h][gi][0], &g[h][gi][1], &g[h][gi][2],
                   &g[h][gi][3]);
    for (int h = 0; h < 2; h++)
        for (int r = 0; r < 4; r++) {
            int32_t *row = px0 + (ptrdiff_t)(4 * h + r) * stride + base;
            for (int gi = 0; gi < ng; gi++)
                *(lf_v4 *)(row + 4 * gi) = g[h][gi][r];
        }
}

/* Clipped residual add: plane[dy:dy+h, dx:dx+w] += r, clip [0, maxp]
 * (the replay-side half of reference inv_txfm_add, src/itx_tmpl.c:118). */
void dtpu_add_residual(int32_t *plane, int64_t stride, int dy, int dx,
                       const int32_t *r, int h, int w, int maxp)
{
    int32_t *row = plane + (int64_t)dy * stride + dx;
    for (int y = 0; y < h; y++, row += stride, r += w)
        for (int x = 0; x < w; x++) {
            int v = row[x] + r[x];
            row[x] = v < 0 ? 0 : v > maxp ? maxp : v;
        }
}

/* int16 residual variant (8-bit residuals come back from the device as
 * int16 to halve the transfer) */
void dtpu_add_residual16(int32_t *plane, int64_t stride, int dy, int dx,
                         const int16_t *r, int h, int w, int maxp)
{
    int32_t *row = plane + (int64_t)dy * stride + dx;
    for (int y = 0; y < h; y++, row += stride, r += w)
        for (int x = 0; x < w; x++) {
            int v = row[x] + r[x];
            row[x] = v < 0 ? 0 : v > maxp ? maxp : v;
        }
}

/* ---- deblock edge-plane construction ------------------------------------
 *
 * Edge state is two frame-wide byte planes (see recon/lf.py): wd_v holds
 * the width class of each cell's LEFT (vertical) edge, wd_h its TOP
 * (horizontal) edge, as class+1 (0 = no filter).  Coordinates are
 * absolute 4x4 cell positions; `stride` is the plane row stride. */

#include <string.h>

static inline int imin(int a, int b) { return a < b ? a : b; }

/* Intra block: block edges take min(tx, neighbour tx); inner tx edges
 * take this block's tx class (edge semantics of AV1 spec 7.14.5;
 * reference mask_edges_intra, src/lf_mask.c:149-200). */
void dtpu_mask_edges_intra(uint8_t *wd_v, uint8_t *wd_h, int64_t stride,
                           int by, int bx, int w4, int h4,
                           int twl4c, int thl4c, int tw, int th,
                           uint8_t *a, uint8_t *l)
{
    uint8_t *v = wd_v + (int64_t)by * stride + bx;
    uint8_t *h = wd_h + (int64_t)by * stride + bx;
    for (int y = 0; y < h4; y++)
        v[(int64_t)y * stride] = (uint8_t)(1 + imin(twl4c, l[y]));
    for (int x = 0; x < w4; x++)
        h[x] = (uint8_t)(1 + imin(thl4c, a[x]));
    for (int x = tw; x < w4; x += tw)
        for (int y = 0; y < h4; y++)
            v[(int64_t)y * stride + x] = (uint8_t)(1 + twl4c);
    for (int y = th; y < h4; y += th)
        memset(h + (int64_t)y * stride, 1 + thl4c, w4);

    memset(a, thl4c, w4);
    memset(l, twl4c, h4);
}

/* Chroma edges (reference mask_edges_chroma, src/lf_mask.c:202-258);
 * inner tx edges are skipped for fully-skipped inter blocks. */
void dtpu_mask_edges_chroma(uint8_t *wd_v, uint8_t *wd_h, int64_t stride,
                            int cby, int cbx, int cw4, int ch4,
                            int skip_inter, int twl4c, int thl4c,
                            int tw, int th, uint8_t *a, uint8_t *l)
{
    uint8_t *v = wd_v + (int64_t)cby * stride + cbx;
    uint8_t *h = wd_h + (int64_t)cby * stride + cbx;
    for (int y = 0; y < ch4; y++)
        v[(int64_t)y * stride] = (uint8_t)(1 + imin(twl4c, l[y]));
    for (int x = 0; x < cw4; x++)
        h[x] = (uint8_t)(1 + imin(thl4c, a[x]));
    if (!skip_inter) {
        for (int x = tw; x < cw4; x += tw)
            for (int y = 0; y < ch4; y++)
                v[(int64_t)y * stride + x] = (uint8_t)(1 + twl4c);
        for (int y = th; y < ch4; y += th)
            memset(h + (int64_t)y * stride, 1 + thl4c, cw4);
    }

    memset(a, thl4c, cw4);
    memset(l, twl4c, ch4);
}

/* reference decomp_tx (src/lf_mask.c:40-77); txa: [2][2][32][32] */
static void decomp_tx(uint8_t (*txa)[2][32][32], const uint8_t *ti_tbl,
                      int from_tx, int depth, int y_off, int x_off,
                      uint32_t tm0, uint32_t tm1, int y0, int x0)
{
    const uint8_t *ti = ti_tbl + 8 * from_tx;
    const int tw = ti[0], th = ti[1];
    const int is_split = (from_tx == 0 || depth > 1) ? 0
        : (int)(((depth ? tm1 : tm0) >> (y_off * 4 + x_off)) & 1);
    if (is_split) {
        const int sub = ti[6];
        const int htw4 = tw >> 1, hth4 = th >> 1;
        decomp_tx(txa, ti_tbl, sub, depth + 1, y_off * 2, x_off * 2,
                  tm0, tm1, y0, x0);
        if (tw >= th)
            decomp_tx(txa, ti_tbl, sub, depth + 1, y_off * 2, x_off * 2 + 1,
                      tm0, tm1, y0, x0 + htw4);
        if (th >= tw) {
            decomp_tx(txa, ti_tbl, sub, depth + 1, y_off * 2 + 1, x_off * 2,
                      tm0, tm1, y0 + hth4, x0);
            if (tw >= th)
                decomp_tx(txa, ti_tbl, sub, depth + 1, y_off * 2 + 1,
                          x_off * 2 + 1, tm0, tm1, y0 + hth4, x0 + htw4);
        }
    } else {
        const int lw = imin(2, ti[2]), lh = imin(2, ti[3]);
        for (int y = y0; y < y0 + th; y++) {
            memset(&txa[0][0][y][x0], lw, tw);
            memset(&txa[1][0][y][x0], lh, tw);
            txa[0][1][y][x0] = tw;
        }
        memset(&txa[1][1][y0][x0], th, tw);
    }
}

/* Inter block: var-tx tree decomposed to a per-cell tx map, then block
 * and inner-tx edges (reference mask_edges_inter, src/lf_mask.c:79-147). */
void dtpu_mask_edges_inter(uint8_t *wd_v, uint8_t *wd_h, int64_t stride,
                           int by, int bx, int w4, int h4,
                           int skip, int max_tx, uint32_t tm0, uint32_t tm1,
                           const uint8_t *ti_tbl, uint8_t *a, uint8_t *l)
{
    const uint8_t *ti = ti_tbl + 8 * max_tx;
    const int tw = ti[0], th = ti[1];
    static _Thread_local uint8_t txa[2][2][32][32];
    memset(txa, 0, sizeof(txa));

    for (int y = 0, y_off = 0; y < h4; y += th, y_off++)
        for (int x = 0, x_off = 0; x < w4; x += tw, x_off++)
            decomp_tx(txa, ti_tbl, max_tx, 0, y_off, x_off, tm0, tm1, y, x);

    uint8_t *v = wd_v + (int64_t)by * stride + bx;
    uint8_t *h = wd_h + (int64_t)by * stride + bx;
    for (int y = 0; y < h4; y++)
        v[(int64_t)y * stride] = (uint8_t)(1 + imin(txa[0][0][y][0], l[y]));
    for (int x = 0; x < w4; x++)
        h[x] = (uint8_t)(1 + imin(txa[1][0][0][x], a[x]));

    if (!skip) {
        for (int y = 0; y < h4; y++) {
            int ltx = txa[0][0][y][0];
            int step = txa[0][1][y][0];
            for (int x = step; x < w4; x += step) {
                const int rtx = txa[0][0][y][x];
                v[(int64_t)y * stride + x] =
                    (uint8_t)(1 + imin(rtx, ltx));
                ltx = rtx;
                step = txa[0][1][y][x];
            }
        }
        for (int x = 0; x < w4; x++) {
            int ttx = txa[1][0][0][x];
            int step = txa[1][1][0][x];
            for (int y = step; y < h4; y += step) {
                const int btx = txa[1][0][y][x];
                h[(int64_t)y * stride + x] =
                    (uint8_t)(1 + imin(ttx, btx));
                ttx = btx;
                step = txa[1][1][y][x];
            }
        }
    }

    for (int y = 0; y < h4; y++)
        l[y] = txa[0][0][y][w4 - 1];
    memcpy(a, &txa[1][0][h4 - 1][0], w4);
}

/* Batched edge apply: filter n recorded edges of one plane/direction.
 * ys/xs are 4x4 cell coordinates, cls the width class values (1-based),
 * L the resolved filter levels (nonzero).  dir 0 = vertical edges
 * (taps run horizontally), 1 = horizontal. */
/* Whole-plane pass: walk the width-class byte plane and the level plane
 * directly (the in-C form of recon/lf.py _collect_edges + _apply_edges:
 * q-side level with p-side fallback, frame boundary never filtered).
 * level rows are lvl_stride bytes of 4-byte cells; the cell's pd_idx
 * byte is the filter level. */
void dtpu_lf_filter_plane(int32_t *plane, int64_t stride,
                          const uint8_t *wd, int64_t wd_stride,
                          const uint8_t *level, int64_t lvl_stride,
                          int pd_idx, int n_rows, int n_cols,
                          const int32_t *e_lut, const int32_t *i_lut,
                          int dir, int is_uv, int bitdepth)
{
    static const int wd_y_map[4] = {0, 4, 8, 16};
    static const int wd_uv_map[3] = {0, 4, 6};
    const int *wd_map = is_uv ? wd_uv_map : wd_y_map;

    if (dir == 0) {
        /* vertical edges: two vertically adjacent cells of one column
         * edge are disjoint (8 consecutive rows) — pair them into the
         * 8-lane core when their width classes match */
        for (int y = 0; y < n_rows; y += 2) {
            const int has2 = y + 1 < n_rows;
            const uint8_t *wrA = wd + (int64_t)y * wd_stride;
            const uint8_t *wrB = wrA + (has2 ? wd_stride : 0);
            const uint8_t *lrA = level + (int64_t)y * lvl_stride;
            const uint8_t *lrB = lrA + (has2 ? lvl_stride : 0);
            int x = 1;
            while (x < n_cols) {
                if (!(x & 7) && x + 8 <= n_cols) {
                    uint64_t wa, wb = 0;
                    memcpy(&wa, wrA + x, 8);
                    if (has2)
                        memcpy(&wb, wrB + x, 8);
                    if (!(wa | wb)) {
                        x += 8;
                        continue;
                    }
                }
                const int cA = wrA[x], cB = has2 ? wrB[x] : 0;
                if (!(cA | cB)) {
                    x++;
                    continue;
                }
                int lvA = 0, lvB = 0;
                if (cA) {
                    lvA = lrA[x * 4 + pd_idx];
                    if (!lvA)
                        lvA = lrA[(x - 1) * 4 + pd_idx];
                }
                if (cB) {
                    lvB = lrB[x * 4 + pd_idx];
                    if (!lvB)
                        lvB = lrB[(x - 1) * 4 + pd_idx];
                }
                int32_t *px = plane + (int64_t)y * 4 * stride + x * 4;
                if (lvA && lvB && cA == cB) {
                    lf_edge8_v(px, stride, e_lut[lvA], i_lut[lvA],
                               lvA >> 4, e_lut[lvB], i_lut[lvB],
                               lvB >> 4, wd_map[cA], bitdepth);
                } else {
                    if (lvA)
                        lf_edge4_v(px, stride, e_lut[lvA], i_lut[lvA],
                                   lvA >> 4, wd_map[cA], bitdepth);
                    if (lvB)
                        lf_edge4_v(px + 4 * stride, stride, e_lut[lvB],
                                   i_lut[lvB], lvB >> 4, wd_map[cB],
                                   bitdepth);
                }
                x++;
            }
        }
        return;
    }

    /* horizontal edges: two horizontally adjacent cells of one row
     * edge are disjoint (8 contiguous columns) — same pairing */
    for (int y = 1; y < n_rows; y++) {
        const uint8_t *wrow = wd + (int64_t)y * wd_stride;
        const uint8_t *lrow = level + (int64_t)y * lvl_stride;
        int x = 0;
        while (x < n_cols) {
            if (!(x & 7) && x + 8 <= n_cols) {
                uint64_t wword;
                memcpy(&wword, wrow + x, 8);
                if (!wword) {
                    x += 8;
                    continue;
                }
            }
            const int c = wrow[x];
            if (!c) {
                x++;
                continue;
            }
            int lv = lrow[x * 4 + pd_idx];
            if (!lv)
                lv = lrow[x * 4 + pd_idx - lvl_stride];
            if (!lv) {
                x++;
                continue;
            }
            const int wd_px = wd_map[c];
            if (x + 1 < n_cols && wrow[x + 1] == c) {
                int lv2 = lrow[(x + 1) * 4 + pd_idx];
                if (!lv2)
                    lv2 = lrow[(x + 1) * 4 + pd_idx - lvl_stride];
                if (lv2) {
                    lf_edge8_h(plane + (int64_t)y * 4 * stride + x * 4,
                               stride, e_lut[lv], i_lut[lv], lv >> 4,
                               e_lut[lv2], i_lut[lv2], lv2 >> 4, wd_px,
                               bitdepth);
                    x += 2;
                    continue;
                }
            }
            lf_edge4_h(plane + (int64_t)y * 4 * stride + x * 4,
                       stride, e_lut[lv], i_lut[lv], lv >> 4, wd_px,
                       bitdepth);
            x++;
        }
    }
}
