/* Native batched inverse transforms: the host tier of the pass-2
 * residual stage (reference inv_txfm_add_c 2-D wrapper,
 * src/itx_tmpl.c:44-130; 1-D kernels in itx1d_gen.h are generated from
 * the decoder's own canonical-scale Python derivations by
 * tools/gen_itx_c.py).  Bit-exact with recon/itx.py itx_batch_np
 * (tests/test_native_itx.py). */

#include <stdlib.h>
#include <string.h>

#include "dtpu.h"
#include "itx1d_gen.h"

static inline int ulg2(int v)
{
    int n = 0;
    while (v > 1) {
        v >>= 1;
        n++;
    }
    return n;
}

typedef int32_t dtpu_v8i __attribute__((vector_size(32)));
typedef int16_t dtpu_v8h __attribute__((vector_size(16)));

/* int16 residual stores: the final (v + 8) >> 4 output is bounded by
 * (col_max + 8) >> 4 < 2 * (maxp + 1) <= 2^13 at every bitdepth (the
 * col pass clips to +-(maxp+1)<<5 before the shift), so residuals
 * always fit int16 — the replay adders already take elsz = 2 (the
 * device tier's 8-bit transfer format).  i16 halves the dominant
 * memory traffic of the host residual stage. */
static inline void itx_out_flat(void *out, int64_t base, int64_t nout,
                                int32_t o, int i16)
{
    if (i16) {
        int16_t *op = (int16_t *)out + base;
        for (int64_t i = 0; i < nout; i++)
            op[i] = (int16_t)o;
    } else {
        int32_t *op = (int32_t *)out + base;
        for (int64_t i = 0; i < nout; i++)
            op[i] = o;
    }
}

static inline void itx_out_scalar(void *out, int64_t idx, int64_t v,
                                  int i16)
{
    if (i16)
        ((int16_t *)out)[idx] = (int16_t)v;
    else
        ((int32_t *)out)[idx] = (int32_t)v;
}

/* 8x8 lane transpose shuffle network: consumes a0..a7 (8-lane vectors
 * of type VT, lane = block), defines r0..r7 (lane = x position).
 * Shared by the int64 and int32 detranspose stores below. */
#define TR_SHUF(a, b, ...) __builtin_shufflevector(a, b, __VA_ARGS__)
#define DTPU_TR8X8(VT)                                                  \
    const VT b0 = TR_SHUF(a0, a1, 0, 8, 2, 10, 4, 12, 6, 14),           \
             b1 = TR_SHUF(a0, a1, 1, 9, 3, 11, 5, 13, 7, 15),           \
             b2 = TR_SHUF(a2, a3, 0, 8, 2, 10, 4, 12, 6, 14),           \
             b3 = TR_SHUF(a2, a3, 1, 9, 3, 11, 5, 13, 7, 15),           \
             b4 = TR_SHUF(a4, a5, 0, 8, 2, 10, 4, 12, 6, 14),           \
             b5 = TR_SHUF(a4, a5, 1, 9, 3, 11, 5, 13, 7, 15),           \
             b6 = TR_SHUF(a6, a7, 0, 8, 2, 10, 4, 12, 6, 14),           \
             b7 = TR_SHUF(a6, a7, 1, 9, 3, 11, 5, 13, 7, 15);           \
    const VT d0 = TR_SHUF(b0, b2, 0, 1, 8, 9, 4, 5, 12, 13),            \
             d2 = TR_SHUF(b0, b2, 2, 3, 10, 11, 6, 7, 14, 15),          \
             d1 = TR_SHUF(b1, b3, 0, 1, 8, 9, 4, 5, 12, 13),            \
             d3 = TR_SHUF(b1, b3, 2, 3, 10, 11, 6, 7, 14, 15),          \
             d4 = TR_SHUF(b4, b6, 0, 1, 8, 9, 4, 5, 12, 13),            \
             d6 = TR_SHUF(b4, b6, 2, 3, 10, 11, 6, 7, 14, 15),          \
             d5 = TR_SHUF(b5, b7, 0, 1, 8, 9, 4, 5, 12, 13),            \
             d7 = TR_SHUF(b5, b7, 2, 3, 10, 11, 6, 7, 14, 15);          \
    const VT r0 = TR_SHUF(d0, d4, 0, 1, 2, 3, 8, 9, 10, 11),            \
             r4 = TR_SHUF(d0, d4, 4, 5, 6, 7, 12, 13, 14, 15),          \
             r1 = TR_SHUF(d1, d5, 0, 1, 2, 3, 8, 9, 10, 11),            \
             r5 = TR_SHUF(d1, d5, 4, 5, 6, 7, 12, 13, 14, 15),          \
             r2 = TR_SHUF(d2, d6, 0, 1, 2, 3, 8, 9, 10, 11),            \
             r6 = TR_SHUF(d2, d6, 4, 5, 6, 7, 12, 13, 14, 15),          \
             r3 = TR_SHUF(d3, d7, 0, 1, 2, 3, 8, 9, 10, 11),            \
             r7 = TR_SHUF(d3, d7, 4, 5, 6, 7, 12, 13, 14, 15)

static void itx_batch_ptrs_i32(const int32_t *const *cfp, int64_t nb,
                               int w, int h, int shift, int row_t,
                               int col_t, int is_rect2, int bitdepth,
                               const uint8_t *xb, const uint8_t *yb,
                               void *out, int i16);

/* cfp: per-block coefficient pointers ((sw*sh) int32 column-major each);
 * out: (nb, h, w) int32 residuals ((x + 8) >> 4 scaled).  The pointer
 * form lets the caller feed blocks straight out of the pass-1 capture
 * arena with no per-frame stacking copy.
 *
 * xb/yb (optional, NULL = unknown): per-block INCLUSIVE upper bounds on
 * the x / y coordinate of any nonzero coefficient, derived by the
 * caller from the block's eob and the scan order (the reference keys
 * its eob-gated sub-kernel choice off the same fact,
 * src/itx_tmpl.c:44-130).  They bound the staging scan, shrink the
 * mid-buffer clear, and expose an exact flat fast path for DC-only
 * DCT_DCT blocks. */
static void itx_batch_core(const int32_t *const *cfp, int64_t nb, int w,
                           int h, int shift, int row_t, int col_t,
                           int is_rect2, int bitdepth, int is_wht,
                           const uint8_t *xb, const uint8_t *yb,
                           void *out, int i16)
{
    const int sw = w < 32 ? w : 32, sh = h < 32 ? h : 32;
    const int64_t nout = (int64_t)w * h;

    if (is_wht) {
        for (int64_t b = 0; b < nb; b++) {
            const int32_t *const cf = cfp[b];
            int64_t m[16];
            for (int x = 0; x < 4; x++)
                for (int y = 0; y < 4; y++)
                    m[y * 4 + x] = cf[x * 4 + y] >> 2;
            for (int y = 0; y < 4; y++)
                itx1d_wht4(m + y * 4, 1, 0, 0);
            for (int x = 0; x < 4; x++)
                itx1d_wht4(m + x, 4, 0, 0);
            for (int i = 0; i < 16; i++)
                itx_out_scalar(out, b * nout + i, m[i], i16);
        }
        return;
    }

    if (bitdepth <= 10) {
        /* 16-lane int32 path: bit-identical (generator-certified
         * interval bounds) at twice the SIMD width */
        itx_batch_ptrs_i32(cfp, nb, w, h, shift, row_t, col_t,
                           is_rect2, bitdepth, xb, yb, out, i16);
        return;
    }

    const int64_t maxp = (1ll << bitdepth) - 1;
    const int64_t row_min =
        bitdepth == 8 ? -(1ll << 15) : -((maxp + 1) << 7);
    const int64_t col_min =
        bitdepth == 8 ? -(1ll << 15) : -((maxp + 1) << 5);
    const int64_t row_max = ~row_min, col_max = ~col_min;
    const int64_t rnd = (1ll << shift) >> 1;
    const itx1d_fn *rowfns = itx1d_table[ulg2(w >> 2)][row_t];
    const itx1d_fn *colfns = itx1d_table[ulg2(h >> 2)][col_t];

    /* 8 blocks per pass: staging is position-major with the block index
     * in the SIMD lane (dtpu_v8 = 8x int64), so the generated 1-D
     * kernels run 8 transforms per instruction stream.  A short tail
     * group leaves the unused lanes zero (stores skip them). */
    const dtpu_v8 vrow_min = row_min - (dtpu_v8){0},
                  vrow_max = row_max - (dtpu_v8){0},
                  vcol_min = col_min - (dtpu_v8){0},
                  vcol_max = col_max - (dtpu_v8){0};
    static _Thread_local dtpu_v8 m[64 * 64];
    int64_t *const ml = (int64_t *)m;
    for (int64_t g = 0; g < nb; g += 8) {
        const int lanes = nb - g < 8 ? (int)(nb - g) : 8;

        /* group-wide scan bounds (max over the 8 lanes; callers sort by
         * eob so bounds stay tight within a group) */
        int gxb = sw - 1, gyb = sh - 1;
        if (xb) {
            gxb = gyb = 0;
            for (int l = 0; l < lanes; l++) {
                if (xb[g + l] > gxb)
                    gxb = xb[g + l];
                if (yb[g + l] > gyb)
                    gyb = yb[g + l];
            }
        }

        /* DC-only DCT_DCT group: the whole 2-D pipeline collapses to
         * one flat value per block (row dct of a lone DC input is the
         * uniform (v*181+128)>>8; mid rescale + col clip as in the
         * main path; col dct uniform again; final (v+8)>>4).  Exactly
         * the reference's dconly shortcut (src/itx_tmpl.c:50-90). */
        if (xb && !gxb && !gyb && !row_t && !col_t) {
            for (int l = 0; l < lanes; l++) {
                int64_t v = cfp[g + l][0];
                if (is_rect2)
                    v = (v * 181 + 128) >> 8;
                v = (v * 181 + 128) >> 8;
                v = (v + rnd) >> shift;
                v = v < col_min ? col_min : v > col_max ? col_max : v;
                const int32_t o = (int32_t)((v * 181 + 128 + 2048) >> 12);
                itx_out_flat(out, (g + l) * nout, nout, o, i16);
            }
            continue;
        }

        /* clear only the rows the col kernel can read: its eob-gated
         * variant for ymax <= gyb reads at most ycap = 4<<var inputs;
         * everything below is written by the col pass itself before the
         * detranspose reads it */
        int ycap = sh;
        if (xb) {
            const int cvar = gyb < 4 ? 0 : 62 - __builtin_clzll(
                                 (uint64_t)gyb);
            ycap = 4 << cvar;
            if (ycap > sh)
                ycap = sh;
        }
        for (int x = 0; x < w; x++)
            memset(m + x * h, 0, sizeof(dtpu_v8) * ycap);

        /* rows (fixed y) that are all-zero across every lane skip the
         * 1-D row transform and the mid-stage rescale outright: the
         * 1-D transforms are linear (0 -> 0) and the mid stage maps 0
         * to 0 exactly ((0 + (1<<shift>>1)) >> shift == 0, clip keeps
         * it).  Callers sort batches by eob so sparse blocks cluster
         * and the mask stays sparse across the 8 lanes. */
        uint32_t rowmask = 0;
        int xmax = 0;
        for (int l = 0; l < lanes; l++) {
            const int32_t *const cf = cfp[g + l];
            const int lxb = xb ? xb[g + l] : sw - 1;
            const int lyb = yb ? yb[g + l] : sh - 1;
            for (int x = 0; x <= lxb; x++)
                for (int y = 0; y <= lyb; y++) {
                    int64_t v = cf[x * sh + y];
                    if (!v)
                        continue;
                    rowmask |= 1u << y;
                    if (x > xmax)
                        xmax = x;
                    if (is_rect2)
                        v = (v * 181 + 128) >> 8;
                    ml[(x * h + y) * 8 + l] = v;
                }
        }
        if (!rowmask) {
            /* every lane all-zero: 1-D transforms are linear, output
             * is identically ((0 + 8) >> 4) == 0 */
            memset((char *)out + g * nout * (i16 ? 2 : 4), 0,
                   (size_t)lanes * nout * (i16 ? 2 : 4));
            continue;
        }
        /* eob-gated sub-kernels (reference's eob-based downshift
         * variants): the row pass needs only inputs x <= xmax live,
         * the col pass only inputs y <= ymax (rows outside rowmask
         * stayed zero: linear transforms, and the mid-stage rescale
         * maps 0 to 0 exactly). */
        const int ymax = 31 - __builtin_clz(rowmask);
        const itx1d_fn rowfn =
            rowfns[xmax < 4 ? 0 : 62 - __builtin_clzll((uint64_t)xmax)];
        const itx1d_fn colfn =
            colfns[ymax < 4 ? 0 : 62 - __builtin_clzll((uint64_t)ymax)];
        for (int y = 0; y < sh; y++) {
            if (!(rowmask >> y & 1))
                continue;
            rowfn(m + y, h, vrow_min, vrow_max);
            for (int x = 0; x < w; x++) {
                const dtpu_v8 v = (m[x * h + y] + rnd) >> shift;
                m[x * h + y] = vclip64(v, vcol_min, vcol_max);
            }
        }
        for (int x = 0; x < w; x++)
            colfn(m + x * h, 1, vcol_min, vcol_max);
        /* detranspose + final >>4: position-major 8-lane vectors back
         * into per-block row-major int32.  8 x-positions x 8 lanes at a
         * time via a shuffle-network 8x8 int64 transpose (full groups;
         * a short tail group keeps the scalar form). */
        if (lanes == 8 && !(w & 7)) {
            const dtpu_v8 v8 = 8 - (dtpu_v8){0};
            for (int x0 = 0; x0 < w; x0 += 8) {
                const dtpu_v8 *c0 = m + (x0 + 0) * h,
                              *c1 = m + (x0 + 1) * h,
                              *c2 = m + (x0 + 2) * h,
                              *c3 = m + (x0 + 3) * h,
                              *c4 = m + (x0 + 4) * h,
                              *c5 = m + (x0 + 5) * h,
                              *c6 = m + (x0 + 6) * h,
                              *c7 = m + (x0 + 7) * h;
                for (int y = 0; y < h; y++) {
                    const dtpu_v8 a0 = (c0[y] + v8) >> 4,
                                  a1 = (c1[y] + v8) >> 4,
                                  a2 = (c2[y] + v8) >> 4,
                                  a3 = (c3[y] + v8) >> 4,
                                  a4 = (c4[y] + v8) >> 4,
                                  a5 = (c5[y] + v8) >> 4,
                                  a6 = (c6[y] + v8) >> 4,
                                  a7 = (c7[y] + v8) >> 4;
                    DTPU_TR8X8(dtpu_v8);
                    const int64_t pos = y * w + x0;
#define ITX_ST64(i, r)                                                  \
    do {                                                                \
        if (i16) {                                                      \
            const dtpu_v8h s = __builtin_convertvector(r, dtpu_v8h);    \
            memcpy((int16_t *)out + (g + i) * nout + pos, &s, 16);      \
        } else {                                                        \
            const dtpu_v8i s = __builtin_convertvector(r, dtpu_v8i);    \
            memcpy((int32_t *)out + (g + i) * nout + pos, &s, 32);      \
        }                                                               \
    } while (0)
                    ITX_ST64(0, r0);
                    ITX_ST64(1, r1);
                    ITX_ST64(2, r2);
                    ITX_ST64(3, r3);
                    ITX_ST64(4, r4);
                    ITX_ST64(5, r5);
                    ITX_ST64(6, r6);
                    ITX_ST64(7, r7);
#undef ITX_ST64
                }
            }
        } else {
            for (int l = 0; l < lanes; l++) {
                const int64_t ob = (g + l) * nout;
                for (int y = 0; y < h; y++)
                    for (int x = 0; x < w; x++)
                        itx_out_scalar(
                            out, ob + y * w + x,
                            (ml[(x * h + y) * 8 + l] + 8) >> 4, i16);
            }
        }
    }
}

/* int32 16-lane variant for bitdepth <= 10: the generator certifies
 * (interval analysis over |input| <= 2^17) that every intermediate of
 * every 1-D kernel fits int32, so this computes bit-identical values to
 * the int64 path with twice the lanes per vector and half the staging
 * traffic. */
static void itx_batch_ptrs_i32(const int32_t *const *cfp, int64_t nb,
                               int w, int h, int shift, int row_t,
                               int col_t, int is_rect2, int bitdepth,
                               const uint8_t *xb, const uint8_t *yb,
                               void *out, int i16)
{
    const int sw = w < 32 ? w : 32, sh = h < 32 ? h : 32;
    const int64_t nout = (int64_t)w * h;
    const int64_t maxp = (1ll << bitdepth) - 1;
    const int32_t row_min =
        bitdepth == 8 ? -(1 << 15) : (int32_t)(-((maxp + 1) << 7));
    const int32_t col_min =
        bitdepth == 8 ? -(1 << 15) : (int32_t)(-((maxp + 1) << 5));
    const int32_t row_max = ~row_min, col_max = ~col_min;
    const int32_t rnd = (1 << shift) >> 1;
    const itx1d_i32_fn *rowfns = itx1d_table_i32[ulg2(w >> 2)][row_t];
    const itx1d_i32_fn *colfns = itx1d_table_i32[ulg2(h >> 2)][col_t];

    const dtpu_v16 vrow_min = row_min - (dtpu_v16){0},
                   vrow_max = row_max - (dtpu_v16){0},
                   vcol_min = col_min - (dtpu_v16){0},
                   vcol_max = col_max - (dtpu_v16){0},
                   vrnd = rnd - (dtpu_v16){0};
    static _Thread_local dtpu_v16 m[64 * 64];
    int32_t *const ml = (int32_t *)m;
    for (int64_t g = 0; g < nb; g += 16) {
        const int lanes = nb - g < 16 ? (int)(nb - g) : 16;

        int gxb = sw - 1, gyb = sh - 1;
        if (xb) {
            gxb = gyb = 0;
            for (int l = 0; l < lanes; l++) {
                if (xb[g + l] > gxb)
                    gxb = xb[g + l];
                if (yb[g + l] > gyb)
                    gyb = yb[g + l];
            }
        }

        if (xb && !gxb && !gyb && !row_t && !col_t) {
            for (int l = 0; l < lanes; l++) {
                int64_t v = cfp[g + l][0];
                if (is_rect2)
                    v = (v * 181 + 128) >> 8;
                v = (v * 181 + 128) >> 8;
                v = (v + rnd) >> shift;
                v = v < col_min ? col_min : v > col_max ? col_max : v;
                const int32_t o = (int32_t)((v * 181 + 128 + 2048) >> 12);
                itx_out_flat(out, (g + l) * nout, nout, o, i16);
            }
            continue;
        }

        int ycap = sh;
        if (xb) {
            const int cvar = gyb < 4 ? 0 : 62 - __builtin_clzll(
                                 (uint64_t)gyb);
            ycap = 4 << cvar;
            if (ycap > sh)
                ycap = sh;
        }
        for (int x = 0; x < w; x++)
            memset(m + x * h, 0, sizeof(dtpu_v16) * ycap);

        uint32_t rowmask = 0;
        int xmax = 0;
        for (int l = 0; l < lanes; l++) {
            const int32_t *const cf = cfp[g + l];
            const int lxb = xb ? xb[g + l] : sw - 1;
            const int lyb = yb ? yb[g + l] : sh - 1;
            for (int x = 0; x <= lxb; x++)
                for (int y = 0; y <= lyb; y++) {
                    int32_t v = cf[x * sh + y];
                    if (!v)
                        continue;
                    rowmask |= 1u << y;
                    if (x > xmax)
                        xmax = x;
                    if (is_rect2)
                        v = (v * 181 + 128) >> 8;
                    ml[(x * h + y) * 16 + l] = v;
                }
        }
        if (!rowmask) {
            memset((char *)out + g * nout * (i16 ? 2 : 4), 0,
                   (size_t)lanes * nout * (i16 ? 2 : 4));
            continue;
        }
        const int ymax = 31 - __builtin_clz(rowmask);
        const itx1d_i32_fn rowfn =
            rowfns[xmax < 4 ? 0 : 62 - __builtin_clzll((uint64_t)xmax)];
        const itx1d_i32_fn colfn =
            colfns[ymax < 4 ? 0 : 62 - __builtin_clzll((uint64_t)ymax)];
        for (int y = 0; y < sh; y++) {
            if (!(rowmask >> y & 1))
                continue;
            rowfn(m + y, h, vrow_min, vrow_max);
            for (int x = 0; x < w; x++) {
                const dtpu_v16 v = (m[x * h + y] + vrnd) >> shift;
                m[x * h + y] = vclip32(v, vcol_min, vcol_max);
            }
        }
        for (int x = 0; x < w; x++)
            colfn(m + x * h, 1, vcol_min, vcol_max);
        /* detranspose + final >>4: two 8-lane halves per 16-lane group,
         * each through the 8x8 int32 shuffle-network transpose */
        if (lanes == 16 && !(w & 7)) {
            const dtpu_v8i v8 = 8 - (dtpu_v8i){0};
            for (int half = 0; half < 2; half++) {
                const int32_t *const hb = ml + half * 8;
                const int64_t go = g + half * 8;
                for (int x0 = 0; x0 < w; x0 += 8) {
                    for (int y = 0; y < h; y++) {
                        const int32_t *p = hb + ((x0 * h) + y) * 16;
                        dtpu_v8i a0, a1, a2, a3, a4, a5, a6, a7;
                        memcpy(&a0, p, 32);
                        memcpy(&a1, p + h * 16, 32);
                        memcpy(&a2, p + 2 * h * 16, 32);
                        memcpy(&a3, p + 3 * h * 16, 32);
                        memcpy(&a4, p + 4 * h * 16, 32);
                        memcpy(&a5, p + 5 * h * 16, 32);
                        memcpy(&a6, p + 6 * h * 16, 32);
                        memcpy(&a7, p + 7 * h * 16, 32);
                        a0 = (a0 + v8) >> 4;
                        a1 = (a1 + v8) >> 4;
                        a2 = (a2 + v8) >> 4;
                        a3 = (a3 + v8) >> 4;
                        a4 = (a4 + v8) >> 4;
                        a5 = (a5 + v8) >> 4;
                        a6 = (a6 + v8) >> 4;
                        a7 = (a7 + v8) >> 4;
                        DTPU_TR8X8(dtpu_v8i);
                        const int64_t pos = y * w + x0;
#define ITX_ST32(i, r)                                                  \
    do {                                                                \
        if (i16) {                                                      \
            const dtpu_v8h s = __builtin_convertvector(r, dtpu_v8h);    \
            memcpy((int16_t *)out + (go + i) * nout + pos, &s, 16);     \
        } else {                                                        \
            memcpy((int32_t *)out + (go + i) * nout + pos, &r, 32);     \
        }                                                               \
    } while (0)
                        ITX_ST32(0, r0);
                        ITX_ST32(1, r1);
                        ITX_ST32(2, r2);
                        ITX_ST32(3, r3);
                        ITX_ST32(4, r4);
                        ITX_ST32(5, r5);
                        ITX_ST32(6, r6);
                        ITX_ST32(7, r7);
#undef ITX_ST32
                    }
                }
            }
        } else {
            for (int l = 0; l < lanes; l++) {
                const int64_t ob = (g + l) * nout;
                for (int y = 0; y < h; y++)
                    for (int x = 0; x < w; x++)
                        itx_out_scalar(
                            out, ob + y * w + x,
                            (ml[(x * h + y) * 16 + l] + 8) >> 4, i16);
            }
        }
    }
}

void dtpu_itx_batch_ptrs_b(const int32_t *const *cfp, int64_t nb, int w,
                           int h, int shift, int row_t, int col_t,
                           int is_rect2, int bitdepth, int is_wht,
                           const uint8_t *xb, const uint8_t *yb,
                           int32_t *out)
{
    itx_batch_core(cfp, nb, w, h, shift, row_t, col_t, is_rect2,
                   bitdepth, is_wht, xb, yb, out, 0);
}

/* int16-residual form (see itx_out_flat bound proof above) */
void dtpu_itx_batch_ptrs_b16(const int32_t *const *cfp, int64_t nb,
                             int w, int h, int shift, int row_t,
                             int col_t, int is_rect2, int bitdepth,
                             int is_wht, const uint8_t *xb,
                             const uint8_t *yb, int16_t *out)
{
    itx_batch_core(cfp, nb, w, h, shift, row_t, col_t, is_rect2,
                   bitdepth, is_wht, xb, yb, out, 1);
}

void dtpu_itx_batch_ptrs(const int32_t *const *cfp, int64_t nb, int w,
                         int h, int shift, int row_t, int col_t,
                         int is_rect2, int bitdepth, int is_wht,
                         int32_t *out)
{
    dtpu_itx_batch_ptrs_b(cfp, nb, w, h, shift, row_t, col_t, is_rect2,
                          bitdepth, is_wht, 0, 0, out);
}

/* contiguous form: cf is (nb, sw*sh) int32 */
void dtpu_itx_batch(const int32_t *cf, int64_t nb, int w, int h,
                    int shift, int row_t, int col_t, int is_rect2,
                    int bitdepth, int is_wht, int32_t *out)
{
    const int sw = w < 32 ? w : 32, sh = h < 32 ? h : 32;
    const int64_t ncoef = (int64_t)sw * sh;
    const int32_t **cfp = malloc((size_t)nb * sizeof(*cfp));
    if (!cfp)
        return;
    for (int64_t b = 0; b < nb; b++)
        cfp[b] = cf + b * ncoef;
    dtpu_itx_batch_ptrs(cfp, nb, w, h, shift, row_t, col_t, is_rect2,
                        bitdepth, is_wht, out);
    free(cfp);
}
