/* Ref-MV prediction: spatial scans, temporal projection, candidate stack.
 *
 * Bit-exact port of the Python reference dav1d_tpu/refmvs.py (itself
 * parity-tested against the oracle; reference src/refmvs.c:40-651, AV1
 * spec 7.10.2).  The Python module remains the fallback/reference; this
 * is the hot path used by the native block-decode layer (decode.c).
 */

#include <string.h>
#include "dtpu.h"

#define INVALID_MV_Y (-32768)
#define EDGE_I444_TOP_HAS_RIGHT 1

static inline int imin_(int a, int b) { return a < b ? a : b; }
static inline int imax_(int a, int b) { return a > b ? a : b; }
static inline int iclip_(int v, int lo, int hi)
{
    return v < lo ? lo : v > hi ? hi : v;
}

/* spec 7.9.3 Div_Mult (reference src/refmvs.c:176-181) */
static const int div_mult[32] = {
    0, 16384, 8192, 5461, 4096, 3276, 2730, 2340,
    2048, 1820, 1638, 1489, 1365, 1260, 1170, 1092,
    1024, 963, 910, 862, 819, 780, 744, 712,
    682, 655, 630, 606, 585, 564, 546, 528,
};

static void mv_projection(int mvy, int mvx, int num, int den,
                          int *oy, int *ox)
{
    const int frac = num * div_mult[den];
    const int64_t y = (int64_t)mvy * frac, x = (int64_t)mvx * frac;
    *oy = (int)iclip_((int)((y + 8192 + (y < 0 ? -1 : 0)) >> 14),
                      -0x3FFF, 0x3FFF);
    *ox = (int)iclip_((int)((x + 8192 + (x < 0 ? -1 : 0)) >> 14),
                      -0x3FFF, 0x3FFF);
}

static inline void fix_int_mv_precision(int *y, int *x)
{
    *x = (int16_t)((*x - (*x >> 15) + 3) & ~7);
    *y = (int16_t)((*y - (*y >> 15) + 3) & ~7);
}

static inline void fix_mv_precision(const DtpuRefMvsFrame *rf, int *y, int *x)
{
    if (rf->force_integer_mv) {
        fix_int_mv_precision(y, x);
    } else if (!rf->hp) {
        *x = (int16_t)((*x - (*x >> 15)) & ~1);
        *y = (int16_t)((*y - (*y >> 15)) & ~1);
    }
}

static inline int apply_sign_(int v, int64_t s)
{
    return s < 0 ? -v : v;
}

void dtpu_get_gmv_2d(const DtpuGmv *gm, int bx4, int by4, int bw4, int bh4,
                     int force_integer_mv, int hp, int *out_y, int *out_x)
{
    if (gm->type == 0) { /* IDENTITY */
        *out_y = *out_x = 0;
        return;
    }
    if (gm->type == 1) { /* TRANSLATION */
        int y = gm->matrix[0] >> 13;
        int x = gm->matrix[1] >> 13;
        if (force_integer_mv)
            fix_int_mv_precision(&y, &x);
        *out_y = y;
        *out_x = x;
        return;
    }
    const int x = bx4 * 4 + bw4 * 2 - 1;
    const int y = by4 * 4 + bh4 * 2 - 1;
    const int64_t xc = (int64_t)(gm->matrix[2] - (1 << 16)) * x
                       + (int64_t)gm->matrix[3] * y + gm->matrix[0];
    const int64_t yc = (int64_t)(gm->matrix[5] - (1 << 16)) * y
                       + (int64_t)gm->matrix[4] * x + gm->matrix[1];
    const int shift = 16 - (3 - !hp);
    const int64_t rnd = (1ll << shift) >> 1;
    int ry = apply_sign_(
        (int)((((yc < 0 ? -yc : yc) + rnd) >> shift) << (!hp)), yc);
    int rx = apply_sign_(
        (int)((((xc < 0 ? -xc : xc) + rnd) >> shift) << (!hp)), xc);
    if (force_integer_mv)
        fix_int_mv_precision(&ry, &rx);
    *out_y = ry;
    *out_x = rx;
}

void dtpu_splat_mv(DtpuRefMvsFrame *rf, int by4, int bx4, int bw4, int bh4,
                   int mvy0, int mvx0, int mvy1, int mvx1,
                   int ref0, int ref1, int bs, int mf)
{
    RefMvsBlock blk;
    blk.mv[0][0] = (int16_t)mvy0;
    blk.mv[0][1] = (int16_t)mvx0;
    blk.mv[1][0] = (int16_t)mvy1;
    blk.mv[1][1] = (int16_t)mvx1;
    blk.ref[0] = (int8_t)ref0;
    blk.ref[1] = (int8_t)ref1;
    blk.bs = (uint8_t)bs;
    blk.mf = (uint8_t)mf;
    for (int y = 0; y < bh4; y++) {
        RefMvsBlock *row = rf->r + (int64_t)(by4 + y) * rf->r_stride + bx4;
        for (int x = 0; x < bw4; x++)
            row[x] = blk;
    }
}

/* reference save_tmvs_c (src/refmvs.c:763-803); in-C form of refmvs.py
 * save_tmvs: per-8x8 cell the bottom-right 4x4 sample's candidate 1
 * wins over candidate 0; a candidate qualifies when its ref's
 * mfmv_sign bit is set and both MV components are under 4096. */
void dtpu_save_tmvs(const DtpuRefMvsFrame *rf, const uint8_t *mfmv_sign,
                    int col_start8, int col_end8, int row_start8,
                    int row_end8)
{
    if (row_end8 > rf->ih8)
        row_end8 = rf->ih8;
    if (col_end8 > rf->iw8)
        col_end8 = rf->iw8;
    for (int y = row_start8; y < row_end8; y++) {
        const RefMvsBlock *crow =
            rf->r + (int64_t)(y * 2 + 1) * rf->r_stride + 1;
        TmvBlock *orow = rf->rp + (int64_t)y * rf->rp_stride;
        for (int x = col_start8; x < col_end8; x++) {
            const RefMvsBlock *c = crow + x * 2;
            TmvBlock o = {{0, 0}, 0};
            for (int idx = 1; idx >= 0; idx--) {
                const int ref = c->ref[idx];
                if (ref > 0 && ref <= 7 && mfmv_sign[ref - 1]) {
                    const int ay = c->mv[idx][0] < 0 ? -c->mv[idx][0]
                                                     : c->mv[idx][0];
                    const int ax = c->mv[idx][1] < 0 ? -c->mv[idx][1]
                                                     : c->mv[idx][1];
                    if ((ay | ax) < 4096) {
                        o.mv[0] = c->mv[idx][0];
                        o.mv[1] = c->mv[idx][1];
                        o.ref = (int8_t)ref;
                        break;
                    }
                }
            }
            orow[x] = o;
        }
    }
}

/* reference load_tmvs_c (src/refmvs.c:691-761); port of refmvs.py
 * load_tmvs (per-cell formulation). */
void dtpu_load_tmvs(const DtpuRefMvsFrame *rf, int col_start8, int col_end8,
                    int row_start8, int row_end8)
{
    if (row_end8 > rf->ih8)
        row_end8 = rf->ih8;
    const int col_start8i = imax_(col_start8 - 8, 0);
    const int col_end8i = imin_(col_end8 + 8, rf->iw8);

    TmvBlock *rp_proj = rf->rp_proj;
    const int stride = rf->rp_stride;
    for (int y = row_start8; y < row_end8; y++)
        for (int x = col_start8; x < col_end8; x++) {
            TmvBlock *c = rp_proj + (int64_t)y * stride + x;
            c->mv[0] = INVALID_MV_Y;
            c->mv[1] = INVALID_MV_Y;
        }

    for (int n = 0; n < rf->n_mfmvs; n++) {
        const int ref2cur = rf->mfmv_ref2cur[n];
        if (ref2cur == -(1 << 7))
            continue;
        const int ref = rf->mfmv_ref[n];
        const int ref_sign = ref - 4;
        const TmvBlock *r = rf->rp_ref[ref];
        const int *ref2ref_n = rf->mfmv_ref2ref[n];
        for (int y = row_start8; y < row_end8; y++) {
            const int y_sb_align = y & ~7;
            const int y_proj_start = imax_(y_sb_align, row_start8);
            const int y_proj_end = imin_(y_sb_align + 8, row_end8);
            const TmvBlock *row = r + (int64_t)y * stride;
            for (int x = col_start8i; x < col_end8i; x++) {
                const int b_ref = row[x].ref;
                if (!b_ref)
                    continue;
                const int ref2ref = ref2ref_n[b_ref - 1];
                if (!ref2ref)
                    continue;
                const int b_mvy = row[x].mv[0], b_mvx = row[x].mv[1];
                int oy, ox;
                mv_projection(b_mvy, b_mvx, ref2cur, ref2ref, &oy, &ox);
                const int aoy = oy < 0 ? -oy : oy;
                const int pos_y =
                    y + (((oy ^ ref_sign) < 0) ? -(aoy >> 6) : (aoy >> 6));
                if (!(y_proj_start <= pos_y && pos_y < y_proj_end))
                    continue;
                const int aox = ox < 0 ? -ox : ox;
                const int pos_x =
                    x + (((ox ^ ref_sign) < 0) ? -(aox >> 6) : (aox >> 6));
                const int x_sb_align = x & ~7;
                if (imax_(x_sb_align - 8, col_start8) <= pos_x &&
                    pos_x < imin_(x_sb_align + 16, col_end8)) {
                    TmvBlock *c = rp_proj + (int64_t)pos_y * stride + pos_x;
                    c->mv[0] = (int16_t)b_mvy;
                    c->mv[1] = (int16_t)b_mvx;
                    c->ref = (int8_t)ref2ref;
                }
            }
        }
    }
}

/* ---- dav1d_refmvs_find equivalent ---------------------------------------- */

typedef struct {
    const DtpuRefMvsFrame *rf;
    int tile_col[2], tile_row[2];
    int ref[2];
    int gmv_valid[2]; /* gmv[i] is not None */
    int gmv[2][2];    /* per idx (y, x) */
    int tgmv[2][2];
    DtpuMvCand *stack;
    int n;
    const uint8_t *block_dim;
} FindCtx;

static void add_spatial_candidate(FindCtx *c, int weight,
                                  const RefMvsBlock *b, int *flags)
{
    if (b->mv[0][0] == INVALID_MV_Y && b->mv[0][1] == INVALID_MV_Y)
        return;
    if (c->ref[1] == -1) {
        for (int n = 0; n < 2; n++) {
            if (b->ref[n] == c->ref[0]) {
                int cy, cx;
                if ((b->mf & 1) && c->gmv_valid[0]) {
                    cy = c->gmv[0][0];
                    cx = c->gmv[0][1];
                } else {
                    cy = b->mv[n][0];
                    cx = b->mv[n][1];
                }
                flags[1] = 1;
                flags[0] |= b->mf >> 1;
                for (int m = 0; m < c->n; m++)
                    if (c->stack[m].mv[0][0] == cy &&
                        c->stack[m].mv[0][1] == cx) {
                        c->stack[m].weight += weight;
                        return;
                    }
                if (c->n < 8) {
                    DtpuMvCand *e = &c->stack[c->n++];
                    e->mv[0][0] = cy;
                    e->mv[0][1] = cx;
                    e->mv[1][0] = 0;
                    e->mv[1][1] = 0;
                    e->weight = weight;
                }
                return;
            }
        }
    } else if (b->ref[0] == c->ref[0] && b->ref[1] == c->ref[1]) {
        int c0y, c0x, c1y, c1x;
        if ((b->mf & 1) && c->gmv_valid[0]) {
            c0y = c->gmv[0][0];
            c0x = c->gmv[0][1];
        } else {
            c0y = b->mv[0][0];
            c0x = b->mv[0][1];
        }
        if ((b->mf & 1) && c->gmv_valid[1]) {
            c1y = c->gmv[1][0];
            c1x = c->gmv[1][1];
        } else {
            c1y = b->mv[1][0];
            c1x = b->mv[1][1];
        }
        flags[1] = 1;
        flags[0] |= b->mf >> 1;
        for (int m = 0; m < c->n; m++)
            if (c->stack[m].mv[0][0] == c0y && c->stack[m].mv[0][1] == c0x &&
                c->stack[m].mv[1][0] == c1y && c->stack[m].mv[1][1] == c1x) {
                c->stack[m].weight += weight;
                return;
            }
        if (c->n < 8) {
            DtpuMvCand *e = &c->stack[c->n++];
            e->mv[0][0] = c0y;
            e->mv[0][1] = c0x;
            e->mv[1][0] = c1y;
            e->mv[1][1] = c1x;
            e->weight = weight;
        }
    }
}

static int scan_row(FindCtx *c, const RefMvsBlock *row, int bx4, int bw4,
                    int w4, int max_rows, int step, int *flags)
{
    const RefMvsBlock *cand_b = &row[bx4];
    const uint8_t *fd = c->block_dim + 4 * cand_b->bs;
    int cand_bw4 = fd[0];
    int ln = imax_(step, imin_(bw4, cand_bw4));
    if (bw4 <= cand_bw4) {
        const int weight =
            bw4 == 1 ? 2 : imax_(2, imin_(2 * max_rows, fd[1]));
        add_spatial_candidate(c, ln * weight, cand_b, flags);
        return weight >> 1;
    }
    int x = 0;
    for (;;) {
        add_spatial_candidate(c, ln * 2, &row[bx4 + x], flags);
        x += ln;
        if (x >= w4)
            return 1;
        cand_bw4 = c->block_dim[4 * row[bx4 + x].bs];
        ln = imax_(step, cand_bw4);
    }
}

static int scan_col(FindCtx *c, int rows_base, int col, int bh4, int h4,
                    int max_cols, int step, int *flags)
{
    const RefMvsBlock *r = c->rf->r;
    const int stride = c->rf->r_stride;
    const RefMvsBlock *cand_b = &r[(int64_t)rows_base * stride + col];
    const uint8_t *fd = c->block_dim + 4 * cand_b->bs;
    int cand_bh4 = fd[1];
    int ln = imax_(step, imin_(bh4, cand_bh4));
    if (bh4 <= cand_bh4) {
        const int weight =
            bh4 == 1 ? 2 : imax_(2, imin_(2 * max_cols, fd[0]));
        add_spatial_candidate(c, ln * weight, cand_b, flags);
        return weight >> 1;
    }
    int y = 0;
    for (;;) {
        add_spatial_candidate(
            c, ln * 2, &r[(int64_t)(rows_base + y) * stride + col], flags);
        y += ln;
        if (y >= h4)
            return 1;
        cand_bh4 =
            c->block_dim[4 * r[(int64_t)(rows_base + y) * stride + col].bs
                         + 1];
        ln = imax_(step, cand_bh4);
    }
}

static void add_temporal_candidate(FindCtx *c, const TmvBlock *rb,
                                   int *gctx)
{
    if (rb->mv[0] == INVALID_MV_Y && rb->mv[1] == INVALID_MV_Y)
        return;
    const DtpuRefMvsFrame *rf = c->rf;
    int my, mx;
    mv_projection(rb->mv[0], rb->mv[1], rf->pocdiff[c->ref[0] - 1], rb->ref,
                  &my, &mx);
    fix_mv_precision(rf, &my, &mx);
    if (c->ref[1] == -1) {
        if (gctx) {
            const int dx = mx - c->tgmv[0][1], dy = my - c->tgmv[0][0];
            *gctx = ((dx < 0 ? -dx : dx) | (dy < 0 ? -dy : dy)) >= 16;
        }
        for (int m = 0; m < c->n; m++)
            if (c->stack[m].mv[0][0] == my && c->stack[m].mv[0][1] == mx) {
                c->stack[m].weight += 2;
                return;
            }
        if (c->n < 8) {
            DtpuMvCand *e = &c->stack[c->n++];
            e->mv[0][0] = my;
            e->mv[0][1] = mx;
            e->mv[1][0] = 0;
            e->mv[1][1] = 0;
            e->weight = 2;
        }
    } else {
        int m1y, m1x;
        mv_projection(rb->mv[0], rb->mv[1], rf->pocdiff[c->ref[1] - 1],
                      rb->ref, &m1y, &m1x);
        fix_mv_precision(rf, &m1y, &m1x);
        for (int m = 0; m < c->n; m++)
            if (c->stack[m].mv[0][0] == my && c->stack[m].mv[0][1] == mx &&
                c->stack[m].mv[1][0] == m1y && c->stack[m].mv[1][1] == m1x) {
                c->stack[m].weight += 2;
                return;
            }
        if (c->n < 8) {
            DtpuMvCand *e = &c->stack[c->n++];
            e->mv[0][0] = my;
            e->mv[0][1] = mx;
            e->mv[1][0] = m1y;
            e->mv[1][1] = m1x;
            e->weight = 2;
        }
    }
}

static void add_single_extended(FindCtx *c, const RefMvsBlock *cand_b,
                                int sign)
{
    const int *sign_bias = c->rf->sign_bias;
    for (int n = 0; n < 2; n++) {
        const int cand_ref = cand_b->ref[n];
        if (cand_ref <= 0)
            break;
        int cy = cand_b->mv[n][0], cx = cand_b->mv[n][1];
        if (sign ^ sign_bias[cand_ref - 1]) {
            cy = -cy;
            cx = -cx;
        }
        int found = 0;
        for (int m = 0; m < c->n; m++)
            if (c->stack[m].mv[0][0] == cy && c->stack[m].mv[0][1] == cx) {
                found = 1;
                break;
            }
        if (!found) {
            DtpuMvCand *e = &c->stack[c->n++];
            e->mv[0][0] = cy;
            e->mv[0][1] = cx;
            e->mv[1][0] = 0;
            e->mv[1][1] = 0;
            e->weight = 2;
        }
    }
}

static void add_compound_extended(FindCtx *c, int same[4][2][2],
                                  int same_count[4],
                                  const RefMvsBlock *cand_b, int sign0,
                                  int sign1)
{
    const int *sign_bias = c->rf->sign_bias;
    for (int n = 0; n < 2; n++) {
        const int cand_ref = cand_b->ref[n];
        if (cand_ref <= 0)
            break;
        const int cy = cand_b->mv[n][0], cx = cand_b->mv[n][1];
        if (cand_ref == c->ref[0]) {
            if (same_count[0] < 2) {
                same[same_count[0]][0][0] = cy;
                same[same_count[0]][0][1] = cx;
                same_count[0]++;
            }
            if (same_count[3] < 2) {
                const int inv = sign1 ^ sign_bias[cand_ref - 1];
                same[2 + same_count[3]][1][0] = inv ? -cy : cy;
                same[2 + same_count[3]][1][1] = inv ? -cx : cx;
                same_count[3]++;
            }
        } else if (cand_ref == c->ref[1]) {
            if (same_count[1] < 2) {
                same[same_count[1]][1][0] = cy;
                same[same_count[1]][1][1] = cx;
                same_count[1]++;
            }
            if (same_count[2] < 2) {
                const int inv = sign0 ^ sign_bias[cand_ref - 1];
                same[2 + same_count[2]][0][0] = inv ? -cy : cy;
                same[2 + same_count[2]][0][1] = inv ? -cx : cx;
                same_count[2]++;
            }
        } else {
            if (same_count[2] < 2) {
                const int inv = sign0 ^ sign_bias[cand_ref - 1];
                same[2 + same_count[2]][0][0] = inv ? -cy : cy;
                same[2 + same_count[2]][0][1] = inv ? -cx : cx;
                same_count[2]++;
            }
            if (same_count[3] < 2) {
                const int inv = sign1 ^ sign_bias[cand_ref - 1];
                same[2 + same_count[3]][1][0] = inv ? -cy : cy;
                same[2 + same_count[3]][1][1] = inv ? -cx : cx;
                same_count[3]++;
            }
        }
    }
}

static void sort_range(DtpuMvCand *stack, int lo, int hi)
{
    int ln = hi;
    while (ln > lo) {
        int last = lo;
        for (int n = lo + 1; n < ln; n++)
            if (stack[n - 1].weight < stack[n].weight) {
                DtpuMvCand tmp = stack[n - 1];
                stack[n - 1] = stack[n];
                stack[n] = tmp;
                last = n;
            }
        ln = last;
    }
}

static void clamp_stack(DtpuMvCand *stack, int n, int bx4, int by4, int bw4,
                        int bh4, const DtpuRefMvsFrame *rf, int both)
{
    const int left = -(bx4 + bw4 + 4) * 4 * 8;
    const int right = (rf->iw4 - bx4 + 4) * 4 * 8;
    const int top = -(by4 + bh4 + 4) * 4 * 8;
    const int bottom = (rf->ih4 - by4 + 4) * 4 * 8;
    for (int m = 0; m < n; m++) {
        stack[m].mv[0][0] = iclip_(stack[m].mv[0][0], top, bottom);
        stack[m].mv[0][1] = iclip_(stack[m].mv[0][1], left, right);
        if (both) {
            stack[m].mv[1][0] = iclip_(stack[m].mv[1][0], top, bottom);
            stack[m].mv[1][1] = iclip_(stack[m].mv[1][1], left, right);
        }
    }
}

/* Returns n_mvs (count before the safe-access fill); mvstack has at
 * least 2 valid entries on return; *out_ctx as in refmvs.py. */
int dtpu_refmvs_find(const DtpuRefMvsFrame *rf,
                     int tile_col_start4, int tile_col_end4,
                     int tile_row_start4, int tile_row_end4,
                     int ref0, int ref1, int bs, int edge_flags,
                     int by4, int bx4, const uint8_t *block_dim,
                     DtpuMvCand *mvstack, int *out_ctx)
{
    FindCtx c;
    c.rf = rf;
    c.tile_col[0] = tile_col_start4;
    c.tile_col[1] = imin_(tile_col_end4, rf->iw4);
    c.tile_row[0] = tile_row_start4;
    c.tile_row[1] = imin_(tile_row_end4, rf->ih4);
    c.ref[0] = ref0;
    c.ref[1] = ref1;
    c.stack = mvstack;
    c.n = 0;
    c.block_dim = block_dim;

    const uint8_t *bd = block_dim + 4 * bs;
    const int bw4 = bd[0], bh4 = bd[1];
    const int w4 = imin_(imin_(bw4, 16), c.tile_col[1] - bx4);
    const int h4 = imin_(imin_(bh4, 16), c.tile_row[1] - by4);

    for (int i = 0; i < 2; i++) {
        c.gmv_valid[i] = 0;
        c.tgmv[i][0] = c.tgmv[i][1] = 0;
        const int r = i ? ref1 : ref0;
        if (r > 0) {
            dtpu_get_gmv_2d(&rf->gmv[r - 1], bx4, by4, bw4, bh4,
                            rf->force_integer_mv, rf->hp,
                            &c.tgmv[i][0], &c.tgmv[i][1]);
            if (rf->gmv[r - 1].type > 1) {
                c.gmv_valid[i] = 1;
                c.gmv[i][0] = c.tgmv[i][0];
                c.gmv[i][1] = c.tgmv[i][1];
            }
        }
    }

    int flags_row[2] = {0, 0}, flags_col[2] = {0, 0};
    int max_rows = 0, max_cols = 0;
    int n_rows = -1, n_cols = -1; /* -1 == "not scanned" (Python None) */
    const RefMvsBlock *r = rf->r;
    const int stride = rf->r_stride;
    if (by4 > c.tile_row[0]) {
        max_rows = imin_((by4 - c.tile_row[0] + 1) >> 1, 2 + (bh4 > 1));
        n_rows = scan_row(&c, &r[(int64_t)(by4 - 1) * stride], bx4, bw4, w4,
                          max_rows, bw4 >= 16 ? 4 : 1, flags_row);
    }
    if (bx4 > c.tile_col[0]) {
        max_cols = imin_((bx4 - c.tile_col[0] + 1) >> 1, 2 + (bw4 > 1));
        n_cols = scan_col(&c, by4, bx4 - 1, bh4, h4, max_cols,
                          bh4 >= 16 ? 4 : 1, flags_col);
    }

    if (n_rows != -1 && (edge_flags & EDGE_I444_TOP_HAS_RIGHT) &&
        imax_(bw4, bh4) <= 16 && bw4 + bx4 < c.tile_col[1])
        add_spatial_candidate(
            &c, 4, &r[(int64_t)(by4 - 1) * stride + bx4 + bw4], flags_row);

    const int have_newmv = flags_row[0] | flags_col[0];
    const int nearest_match = flags_col[1] + flags_row[1];
    const int nearest_cnt = c.n;
    for (int m = 0; m < c.n; m++)
        c.stack[m].weight += 640;

    int globalmv_ctx = rf->use_frame_ref_mvs_hdr;
    if (rf->use_ref_frame_mvs) {
        const int by8 = by4 >> 1, bx8 = bx4 >> 1;
        const TmvBlock *rp_proj = rf->rp_proj;
        const int pstride = rf->rp_stride;
        const int step_h = bw4 >= 16 ? 2 : 1;
        const int step_v = bh4 >= 16 ? 2 : 1;
        const int w8 = imin_((w4 + 1) >> 1, 8);
        const int h8 = imin_((h4 + 1) >> 1, 8);
        for (int y = 0; y < h8; y += step_v)
            for (int x = 0; x < w8; x += step_h)
                add_temporal_candidate(
                    &c, &rp_proj[(int64_t)(by8 + y) * pstride + bx8 + x],
                    (x | y) ? NULL : &globalmv_ctx);
        if (imin_(bw4, bh4) >= 2 && imax_(bw4, bh4) < 16) {
            const int bh8 = bh4 >> 1, bw8 = bw4 >> 1;
            const int has_bottom =
                by8 + bh8 < imin_(c.tile_row[1] >> 1, (by8 & ~7) + 8);
            if (has_bottom &&
                bx8 - 1 >= imax_(c.tile_col[0] >> 1, bx8 & ~7))
                add_temporal_candidate(
                    &c, &rp_proj[(int64_t)(by8 + bh8) * pstride + bx8 - 1],
                    NULL);
            if (bx8 + bw8 < imin_(c.tile_col[1] >> 1, (bx8 & ~7) + 8)) {
                if (has_bottom)
                    add_temporal_candidate(
                        &c,
                        &rp_proj[(int64_t)(by8 + bh8) * pstride + bx8 + bw8],
                        NULL);
                if (by8 + bh8 - 1 <
                    imin_(c.tile_row[1] >> 1, (by8 & ~7) + 8))
                    add_temporal_candidate(
                        &c,
                        &rp_proj[(int64_t)(by8 + bh8 - 1) * pstride + bx8
                                 + bw8],
                        NULL);
            }
        }
    }

    if (n_rows != -1 && n_cols != -1)
        add_spatial_candidate(
            &c, 4, &r[(int64_t)(by4 - 1) * stride + bx4 - 1], flags_row);

    for (int n = 2; n <= 3; n++) {
        if (n_rows != -1 && n > n_rows && n <= max_rows) {
            const int row_idx =
                (by4 & ~31) + (((by4 & 31) - 2 * n + 1) | 1);
            n_rows += scan_row(&c, &r[(int64_t)row_idx * stride], bx4 | 1,
                               bw4, w4, 1 + max_rows - n,
                               bw4 >= 16 ? 4 : 2, flags_row);
        }
        if (n_cols != -1 && n > n_cols && n <= max_cols)
            n_cols += scan_col(&c, (by4 & ~31) + ((by4 & 31) | 1),
                               (bx4 - n * 2 + 1) | 1, bh4, h4,
                               1 + max_cols - n, bh4 >= 16 ? 4 : 2,
                               flags_col);
    }

    const int ref_match_count = flags_col[1] + flags_row[1];

    int refmv_ctx, newmv_ctx;
    if (nearest_match == 0) {
        refmv_ctx = imin_(2, ref_match_count);
        newmv_ctx = ref_match_count > 0;
    } else if (nearest_match == 1) {
        refmv_ctx = imin_(ref_match_count * 3, 4);
        newmv_ctx = 3 - have_newmv;
    } else {
        refmv_ctx = 5;
        newmv_ctx = 5 - have_newmv;
    }

    sort_range(c.stack, 0, nearest_cnt);
    sort_range(c.stack, nearest_cnt, c.n);

    if (ref1 > 0) {
        if (c.n < 2) {
            const int sign0 = rf->sign_bias[ref0 - 1];
            const int sign1 = rf->sign_bias[ref1 - 1];
            const int sz4 = imin_(w4, h4);
            int same[4][2][2];
            memset(same, 0, sizeof(same));
            int same_count[4] = {0, 0, 0, 0};
            if (n_rows != -1)
                for (int x = 0; x < sz4;) {
                    const RefMvsBlock *cand_b =
                        &r[(int64_t)(by4 - 1) * stride + bx4 + x];
                    add_compound_extended(&c, same, same_count, cand_b,
                                          sign0, sign1);
                    x += block_dim[4 * cand_b->bs];
                }
            if (n_cols != -1)
                for (int y = 0; y < sz4;) {
                    const RefMvsBlock *cand_b =
                        &r[(int64_t)(by4 + y) * stride + bx4 - 1];
                    add_compound_extended(&c, same, same_count, cand_b,
                                          sign0, sign1);
                    y += block_dim[4 * cand_b->bs + 1];
                }
            for (int n = 0; n < 2; n++) {
                int m = same_count[n];
                if (m >= 2)
                    continue;
                const int ln = same_count[2 + n];
                if (ln) {
                    same[m][n][0] = same[2][n][0];
                    same[m][n][1] = same[2][n][1];
                    m++;
                    if (m != 2) {
                        if (ln == 2) {
                            same[1][n][0] = same[3][n][0];
                            same[1][n][1] = same[3][n][1];
                            continue;
                        }
                        while (m < 2) {
                            same[m][n][0] = c.tgmv[n][0];
                            same[m][n][1] = c.tgmv[n][1];
                            m++;
                        }
                    }
                } else {
                    while (m < 2) {
                        same[m][n][0] = c.tgmv[n][0];
                        same[m][n][1] = c.tgmv[n][1];
                        m++;
                    }
                }
            }
            const int n0 = c.n;
            if (n0 == 1 && c.stack[0].mv[0][0] == same[0][0][0] &&
                c.stack[0].mv[0][1] == same[0][0][1] &&
                c.stack[0].mv[1][0] == same[0][1][0] &&
                c.stack[0].mv[1][1] == same[0][1][1]) {
                DtpuMvCand *e = &c.stack[c.n++];
                e->mv[0][0] = same[1][0][0];
                e->mv[0][1] = same[1][0][1];
                e->mv[1][0] = same[1][1][0];
                e->mv[1][1] = same[1][1][1];
                e->weight = 2;
            } else {
                while (c.n < 2) {
                    const int i = c.n - n0;
                    DtpuMvCand *e = &c.stack[c.n++];
                    e->mv[0][0] = same[i][0][0];
                    e->mv[0][1] = same[i][0][1];
                    e->mv[1][0] = same[i][1][0];
                    e->mv[1][1] = same[i][1][1];
                    e->weight = 2;
                }
            }
        }
        const int cnt = c.n;
        clamp_stack(c.stack, c.n, bx4, by4, bw4, bh4, rf, 1);
        const int rc2 = refmv_ctx >> 1;
        int ctx;
        if (rc2 == 0)
            ctx = imin_(newmv_ctx, 1);
        else if (rc2 == 1)
            ctx = 1 + imin_(newmv_ctx, 3);
        else
            ctx = imax_(4, imin_(7, 3 + newmv_ctx));
        *out_ctx = ctx;
        return cnt;
    }

    if (c.n < 2 && ref0 > 0) {
        const int sign = rf->sign_bias[ref0 - 1];
        const int sz4 = imin_(w4, h4);
        if (n_rows != -1)
            for (int x = 0; x < sz4 && c.n < 2;) {
                const RefMvsBlock *cand_b =
                    &r[(int64_t)(by4 - 1) * stride + bx4 + x];
                add_single_extended(&c, cand_b, sign);
                x += block_dim[4 * cand_b->bs];
            }
        if (n_cols != -1)
            for (int y = 0; y < sz4 && c.n < 2;) {
                const RefMvsBlock *cand_b =
                    &r[(int64_t)(by4 + y) * stride + bx4 - 1];
                add_single_extended(&c, cand_b, sign);
                y += block_dim[4 * cand_b->bs + 1];
            }
    }

    clamp_stack(c.stack, c.n, bx4, by4, bw4, bh4, rf, 0);
    const int cnt = c.n;
    while (c.n < 2) {
        DtpuMvCand *e = &c.stack[c.n++];
        e->mv[0][0] = c.tgmv[0][0];
        e->mv[0][1] = c.tgmv[0][1];
        e->mv[1][0] = 0;
        e->mv[1][1] = 0;
        e->weight = 0;
    }

    *out_ctx = (refmv_ctx << 4) | (globalmv_ctx << 3) | newmv_ctx;
    return cnt;
}
