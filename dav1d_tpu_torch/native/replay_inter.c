/* Native pass-2 inter replay: the order-free phase-A block walk
 * (motion-compensated prediction from reference frames + cached-residual
 * add) in one C call over the capture arena.
 *
 * Port of the replay half of dav1d_tpu/recon/inter.py recon_b_inter
 * (reference dav1d_recon_b_inter, src/recon_tmpl.c:1557-1985, mc()
 * :938, obmc() :1052, warp_affine() :1115) and the compound helpers of
 * dav1d_tpu/recon/mc_np.py (reference avg/w_avg/mask/w_mask/blend_h/v,
 * src/mc_tmpl.c:628-910).  Bit-identical to the Python replay: the
 * conformance gauntlet (tests/test_e2e_aom.py) decodes every stream
 * through both paths.
 *
 * Inter predictions read only reference-frame pixels, so blocks replay
 * in any order; blocks this walk does not handle (scaled references,
 * interintra — the latter blends an intra prediction and stays in the
 * ordered phase B) are reported back for the Python fallback. */

#include <string.h>

#include "dtpu.h"

/* enum values (dav1d_tpu.levels) */
#define CT_NONE 0
#define CT_WEIGHTED_AVG 1
#define CT_AVG 2
#define CT_SEG 3
#define CT_WEDGE 4
#define MM_OBMC 1
#define MM_WARP 2
#define IPM_GLOBALMV 2
#define CIPM_GLOBALMV_GLOBALMV 6

#define RB_CELL 12 /* refmvs.py RB_DT: mv[2][2] i16, ref[2] i8, bs, mf */

static inline int iclip(int v, int lo, int hi)
{
    return v < lo ? lo : v > hi ? hi : v;
}

static inline int imin(int a, int b) { return a < b ? a : b; }

/* scratch (the decoder is single-threaded on the host side) */
static int32_t s_tmp0[128 * 128], s_tmp1[128 * 128];
static int32_t s_lap[64 * 64];
static uint8_t s_mask[128 * 128]; /* SEG mask at chroma resolution */

typedef struct {
    const DtpuReplayCtx *rc;
    const DtpuInterCtx *ic;
    int ib, maxp, prep_bias;
    int bx, by; /* current block position (4x4 units) */
} ICtx;

static const int64_t *filt_row(int64_t *buf, const int8_t *tbl, int set,
                               int sub)
{
    if (!sub)
        return 0;
    const int8_t *r = tbl + ((int64_t)set * 15 + (sub - 1)) * 8;
    for (int i = 0; i < 8; i++)
        buf[i] = r[i];
    return buf;
}

/* filter2d -> h/v filter family (recon/inter.py _F2D_TO_TYPE) */
static const int f2d_htype[9] = {0, 0, 0, 2, 2, 2, 1, 1, 1};

/* Translation MC: (bw4, bh4) block at (bx, by) with subpel mv into
 * dst/dstride (put) or packed prep intermediates (prep != 0).
 * (recon/inter.py mc_put / mc_prep, unscaled path) */
static void mc_c(const ICtx *c, int pl, int refidx, int bx, int by,
                 int bw4, int bh4, int mvy, int mvx, int f2d, int prep,
                 int32_t *dst, int64_t dstride)
{
    const DtpuInterCtx *ic = c->ic;
    const int ss_hor = pl ? c->rc->ss_hor : 0;
    const int ss_ver = pl ? c->rc->ss_ver : 0;
    const int h_mul = 4 >> ss_hor, v_mul = 4 >> ss_ver;
    const int mx = (mvx & (15 >> !ss_hor)) << !ss_hor;
    const int my = (mvy & (15 >> !ss_ver)) << !ss_ver;
    const int dx = bx * h_mul + (mvx >> (3 + ss_hor));
    const int dy = by * v_mul + (mvy >> (3 + ss_ver));
    const int vw = (ic->ref_w[refidx] + ss_hor) >> ss_hor;
    const int vh = (ic->ref_h[refidx] + ss_ver) >> ss_ver;
    const int w = bw4 * h_mul, h = bh4 * v_mul;
    const int ht = f2d_htype[f2d], vt = f2d % 3;
    int64_t fhb[8], fvb[8];
    const int64_t *fh = filt_row(fhb, ic->subpel_filters,
                                 w > 4 ? ht : 3 + (ht & 1), mx);
    const int64_t *fv = filt_row(fvb, ic->subpel_filters,
                                 h > 4 ? vt : 3 + (vt & 1), my);
    if (prep)
        dtpu_put_8tap(ic->ref_planes[refidx][pl],
                      ic->ref_stride[refidx][pl], vw, vh, dy, dx, w, h,
                      fh, fv, c->ib, c->maxp, 1, c->prep_bias, dst);
    else
        dtpu_put_8tap_into(ic->ref_planes[refidx][pl],
                           ic->ref_stride[refidx][pl], vw, vh, dy, dx, w,
                           h, fh, fv, c->ib, c->maxp, dst, dstride);
}

/* Warped prediction over 8x8 tiles into dst/dstride (put) or packed
 * prep (recon/inter.py warp_affine). mat/abcd from the capture or the
 * frame gmv. */
static void warp_c(const ICtx *c, int pl, int refidx, int bw4, int bh4,
                   const int32_t *mat, const int32_t *abcd, int prep,
                   int32_t *dst, int64_t dstride)
{
    const DtpuInterCtx *ic = c->ic;
    const int ss_hor = pl ? c->rc->ss_hor : 0;
    const int ss_ver = pl ? c->rc->ss_ver : 0;
    const int h_mul = 4 >> ss_hor, v_mul = 4 >> ss_ver;
    const int bw_px = bw4 * h_mul, bh_px = bh4 * v_mul;
    const int vw = (ic->ref_w[refidx] + ss_hor) >> ss_hor;
    const int vh = (ic->ref_h[refidx] + ss_ver) >> ss_ver;
    const int32_t *plane = ic->ref_planes[refidx][pl];
    const int64_t stride = ic->ref_stride[refidx][pl];
    int32_t t64[64];
    for (int y = 0; y < bh_px; y += 8) {
        const int64_t src_y = c->by * 4 + ((y + 4) << ss_ver);
        const int64_t mat3_y = (int64_t)mat[3] * src_y + mat[0];
        const int64_t mat5_y = (int64_t)mat[5] * src_y + mat[1];
        for (int x = 0; x < bw_px; x += 8) {
            const int64_t src_x = c->bx * 4 + ((x + 4) << ss_hor);
            const int64_t mvx = ((int64_t)mat[2] * src_x + mat3_y) >> ss_hor;
            const int64_t mvy = ((int64_t)mat[4] * src_x + mat5_y) >> ss_ver;
            const int dx = (int)(mvx >> 16) - 4;
            const int mx = (int)((mvx & 0xFFFF) - abcd[0] * 4 -
                                 abcd[1] * 7) & ~0x3F;
            const int dy = (int)(mvy >> 16) - 4;
            const int my = (int)((mvy & 0xFFFF) - abcd[2] * 4 -
                                 abcd[3] * 4) & ~0x3F;
            dtpu_warp8x8(plane, stride, vw, vh, dy, dx, abcd, mx, my,
                         c->ib, c->maxp, prep, c->prep_bias,
                         ic->warp_filter, t64);
            for (int r = 0; r < 8; r++)
                memcpy(dst + (int64_t)(y + r) * dstride + x, t64 + 8 * r,
                       8 * sizeof(int32_t));
        }
    }
}

/* OBMC neighbour blends (recon/inter.py obmc, pass-2 branch):
 * lap = neighbour MC, blended into the current prediction with the
 * obmc mask ramps (reference blend_h_c / blend_v_c). */
static int obmc_c(const ICtx *c, int pl, const CapBlock *cb, int bw4,
                  int bh4)
{
    const DtpuReplayCtx *rc = c->rc;
    const DtpuInterCtx *ic = c->ic;
    const int ss_hor = pl ? rc->ss_hor : 0;
    const int ss_ver = pl ? rc->ss_ver : 0;
    const int h_mul = 4 >> ss_hor, v_mul = 4 >> ss_ver;
    const int dst_y = (c->by * 4) >> ss_ver;
    const int dst_x = (c->bx * 4) >> ss_hor;
    int32_t *plane = rc->planes[pl];
    const int64_t stride = rc->stride[pl];

    for (int64_t i = cb->obmc_start; i < cb->obmc_start + cb->obmc_count;
         i++) {
        const CapObmc *o = &ic->cap_obmc[i];
        const int refidx = o->refidx;
        if (!ic->ref_ok[refidx])
            return 0;
        if (o->kind == 0) { /* top */
            if (pl && bw4 * h_mul + bh4 * v_mul < 16)
                continue;
            const int ow4 = imin(o->step4, bw4);
            const int oh4 = imin(bh4, 16) >> 1;
            const int lw = ow4 * h_mul;
            const int lh = ((oh4 * 3 + 3) >> 2) * v_mul;
            mc_c(c, pl, refidx, c->bx + o->off, c->by, ow4,
                 (oh4 * 3 + 3) >> 2, o->mv[0], o->mv[1], o->f2d, 0,
                 s_lap, lw);
            const int h = v_mul * oh4, hb = (h * 3) >> 2;
            int32_t *d = plane + (int64_t)dst_y * stride + dst_x +
                         o->off * h_mul;
            for (int y = 0; y < hb; y++) {
                const int m = ic->obmc_masks[h + y];
                const int32_t *l = s_lap + (int64_t)y * lw;
                int32_t *dr = d + (int64_t)y * stride;
                for (int x = 0; x < lw; x++)
                    dr[x] = (dr[x] * (64 - m) + l[x] * m + 32) >> 6;
            }
        } else { /* left */
            const int ow4 = imin(bw4, 16) >> 1;
            const int oh4 = imin(o->step4, bh4);
            const int lw = ow4 * h_mul;
            mc_c(c, pl, refidx, c->bx, c->by + o->off, ow4, oh4,
                 o->mv[0], o->mv[1], o->f2d, 0, s_lap, lw);
            const int w = h_mul * ow4, wb = (w * 3) >> 2;
            const int h = v_mul * oh4;
            int32_t *d = plane + (int64_t)(dst_y + o->off * v_mul) * stride +
                         dst_x;
            for (int y = 0; y < h; y++) {
                const int32_t *l = s_lap + (int64_t)y * lw;
                int32_t *dr = d + (int64_t)y * stride;
                for (int x = 0; x < wb; x++) {
                    const int m = ic->obmc_masks[w + x];
                    dr[x] = (dr[x] * (64 - m) + l[x] * m + 32) >> 6;
                }
            }
        }
    }
    return 1;
}

/* rb grid cell accessors (refmvs.py RB_DT, packed 12 bytes) */
static inline const uint8_t *rb_cell(const DtpuInterCtx *ic, int by, int bx)
{
    return ic->rb + ((int64_t)by * ic->rb_stride + bx) * RB_CELL;
}

static inline int rb_ref0(const uint8_t *cell)
{
    return (int)(int8_t)cell[8];
}

static inline void rb_mv0(const uint8_t *cell, int *mvy, int *mvx)
{
    int16_t v[2];
    memcpy(v, cell, 4);
    *mvy = v[0];
    *mvx = v[1];
}

/* Sub-8x8 chroma prediction from neighbouring blocks' MVs
 * (recon/inter.py _sub8x8_chroma, reference src/recon_tmpl.c:1650-1712).
 * Returns 0 when a neighbour needs the Python fallback. */
static int sub8x8_chroma_c(const ICtx *c, const CapBlock *cb, int bw4,
                           int bh4, int cdst_y, int cdst_x)
{
    const DtpuReplayCtx *rc = c->rc;
    const DtpuInterCtx *ic = c->ic;
    const int ss_ver = rc->ss_ver;
    const int tl_f2d = cb->sub8x8 & 0xFF;
    const int left_f2d = (cb->sub8x8 >> 8) & 0xFF;
    const int top_f2d = (cb->sub8x8 >> 16) & 0xFF;
    int h_off = 0, v_off = 0;

    /* collect the up-to-3 neighbour jobs first so a bad ref bails
     * before any pixels are written */
    struct {
        const uint8_t *cell;
        int dy, dx, bx, by, f2d;
    } jobs[3];
    int nj = 0;
    if (bw4 == 1 && bh4 == ss_ver) {
        jobs[nj].cell = rb_cell(ic, c->by - 1, c->bx - 1);
        jobs[nj].dy = 0; jobs[nj].dx = 0;
        jobs[nj].bx = c->bx - 1; jobs[nj].by = c->by - 1;
        jobs[nj++].f2d = tl_f2d;
        v_off = 2; h_off = 2;
    }
    if (bw4 == 1) {
        jobs[nj].cell = rb_cell(ic, c->by, c->bx - 1);
        jobs[nj].dy = v_off; jobs[nj].dx = 0;
        jobs[nj].bx = c->bx - 1; jobs[nj].by = c->by;
        jobs[nj++].f2d = left_f2d;
        h_off = 2;
    }
    if (bh4 == ss_ver) {
        jobs[nj].cell = rb_cell(ic, c->by - 1, c->bx);
        jobs[nj].dy = 0; jobs[nj].dx = h_off;
        jobs[nj].bx = c->bx; jobs[nj].by = c->by - 1;
        jobs[nj++].f2d = top_f2d;
        v_off = 2;
    }
    for (int j = 0; j < nj; j++) {
        const int refidx = rb_ref0(jobs[j].cell) - 1;
        if (refidx < 0 || !ic->ref_ok[refidx])
            return 0;
    }
    const int ref0 = cb->pad0 - 1;
    if (!ic->ref_ok[ref0])
        return 0;
    for (int j = 0; j < nj; j++) {
        const int refidx = rb_ref0(jobs[j].cell) - 1;
        int mvy, mvx;
        rb_mv0(jobs[j].cell, &mvy, &mvx);
        for (int pl = 1; pl < 3; pl++)
            mc_c(c, pl, refidx, jobs[j].bx, jobs[j].by, bw4, bh4, mvy,
                 mvx, jobs[j].f2d, 0,
                 rc->planes[pl] +
                     (int64_t)(cdst_y + jobs[j].dy) * rc->stride[pl] +
                     cdst_x + jobs[j].dx,
                 rc->stride[pl]);
    }
    for (int pl = 1; pl < 3; pl++)
        mc_c(c, pl, ref0, c->bx, c->by, bw4, bh4, cb->mv[0][0],
             cb->mv[0][1], cb->filter2d, 0,
             rc->planes[pl] +
                 (int64_t)(cdst_y + v_off) * rc->stride[pl] + cdst_x +
                 h_off,
             rc->stride[pl]);
    return 1;
}

/* compound blends (recon/mc_np.py avg / w_avg / mask_blend / w_mask) */

static void blend_into(const ICtx *c, int32_t *dst, int64_t dstride, int w,
                       int h, const int32_t *t1, const int32_t *t2,
                       int comp_type, int jw, const uint8_t *mask,
                       int mask_stride)
{
    const int ib = c->ib, maxp = c->maxp, bias = c->prep_bias;
    for (int y = 0; y < h; y++) {
        int32_t *d = dst + (int64_t)y * dstride;
        const int32_t *a = t1 + (int64_t)y * w;
        const int32_t *b = t2 + (int64_t)y * w;
        if (comp_type == CT_AVG) {
            const int rnd = (1 << ib) + bias * 2;
            for (int x = 0; x < w; x++)
                d[x] = iclip((a[x] + b[x] + rnd) >> (ib + 1), 0, maxp);
        } else if (comp_type == CT_WEIGHTED_AVG) {
            const int rnd = (8 << ib) + bias * 16;
            for (int x = 0; x < w; x++)
                d[x] = iclip((a[x] * jw + b[x] * (16 - jw) + rnd)
                                 >> (ib + 4),
                             0, maxp);
        } else { /* masked (WEDGE or SEG chroma) */
            const int rnd = (32 << ib) + bias * 64;
            const uint8_t *m = mask + (int64_t)y * mask_stride;
            for (int x = 0; x < w; x++)
                d[x] = iclip((a[x] * m[x] + b[x] * (64 - m[x]) + rnd)
                                 >> (ib + 6),
                             0, maxp);
        }
    }
}

/* Difference-weighted compound (reference w_mask_c): writes pixels into
 * dst and the chroma-resolution mask into s_mask. t1 = tmp[sign]. */
static void w_mask_c(const ICtx *c, int32_t *dst, int64_t dstride, int w,
                     int h, const int32_t *t1, const int32_t *t2, int sign,
                     int ss_hor, int ss_ver, int bitdepth)
{
    const int ib = c->ib, maxp = c->maxp, bias = c->prep_bias;
    const int sh = ib + 6;
    const int rnd = (32 << ib) + bias * 64;
    const int mask_sh = bitdepth + ib - 4;
    const int mask_rnd = 1 << (mask_sh - 5);
    static uint8_t mfull[128 * 128];
    for (int y = 0; y < h; y++) {
        int32_t *d = dst + (int64_t)y * dstride;
        const int32_t *a = t1 + (int64_t)y * w;
        const int32_t *b = t2 + (int64_t)y * w;
        uint8_t *mrow = mfull + (int64_t)y * w;
        for (int x = 0; x < w; x++) {
            const int diff = a[x] - b[x];
            const int ad = diff < 0 ? -diff : diff;
            int m = 38 + ((ad + mask_rnd) >> mask_sh);
            if (m > 64)
                m = 64;
            mrow[x] = (uint8_t)m;
            d[x] = iclip((diff * m + b[x] * 64 + rnd) >> sh, 0, maxp);
        }
    }
    /* subsample to chroma resolution */
    const int cw = w >> ss_hor, chh = h >> ss_ver;
    if (ss_hor) {
        for (int y = 0; y < chh; y++)
            for (int x = 0; x < cw; x++) {
                if (ss_ver) {
                    const int v =
                        mfull[(2 * y) * w + 2 * x] +
                        mfull[(2 * y) * w + 2 * x + 1] +
                        mfull[(2 * y + 1) * w + 2 * x] +
                        mfull[(2 * y + 1) * w + 2 * x + 1];
                    s_mask[y * cw + x] = (uint8_t)((v + 2 - sign) >> 2);
                } else {
                    const int v = mfull[y * w + 2 * x] +
                                  mfull[y * w + 2 * x + 1];
                    s_mask[y * cw + x] = (uint8_t)((v + 1 - sign) >> 1);
                }
            }
    } else {
        memcpy(s_mask, mfull, (size_t)w * h);
    }
}

static const uint8_t *wedge_mask_ptr(const DtpuInterCtx *ic,
                                     int chr_layout_idx, int bs, int sign,
                                     int wedge_idx)
{
    /* tables.py wedge_mask: offsets (3, 11, 36) in 8-byte units;
       bs - BS_32x32(7) */
    const int off = ic->mask_offsets[(chr_layout_idx * 11 + (bs - 7)) * 36 +
                                     sign * 16 + wedge_idx];
    return ic->masks_blob + (int64_t)off * 8;
}

static void add_resid_any2(const DtpuReplayCtx *rc, int pl, int dy, int dx,
                           uint64_t r, int h, int w, int maxp)
{
    if (rc->resid_elsz == 2)
        dtpu_add_residual16(rc->planes[pl], rc->stride[pl], dy, dx,
                            (const int16_t *)r, h, w, maxp);
    else
        dtpu_add_residual(rc->planes[pl], rc->stride[pl], dy, dx,
                          (const int32_t *)r, h, w, maxp);
}

static void add_block_residuals(const DtpuReplayCtx *rc, const CapBlock *cb,
                                int maxp)
{
    for (int64_t m = cb->coef_start; m < cb->coef_start + cb->coef_count;
         m++) {
        const int32_t *mrow = rc->coef_meta + m * CAP_COEF_WORDS;
        if (mrow[0] < 0)
            continue;
        const uint64_t rp = rc->resid_ptrs[m];
        if (!rp)
            continue;
        const uint8_t *ti = rc->txfm_info + 8 * (mrow[2] >> 8);
        add_resid_any2(rc, mrow[2] & 0xFF, mrow[3], mrow[4], rp,
                       4 * ti[1], 4 * ti[0], maxp);
    }
}

/* Replay one plain inter block; returns 0 -> Python fallback. */
static int replay_inter_block(ICtx *c, const CapBlock *cb)
{
    const DtpuReplayCtx *rc = c->rc;
    const DtpuInterCtx *ic = c->ic;
    const int ss_hor = rc->ss_hor, ss_ver = rc->ss_ver;
    const uint8_t *bd = rc->block_dim + 4 * cb->bs;
    const int bw4 = bd[0], bh4 = bd[1];
    const int bx = cb->bx, by = cb->by;
    c->bx = bx;
    c->by = by;
    const int has_chroma = rc->layout != 0 &&
                           (bw4 > ss_hor || (bx & 1)) &&
                           (bh4 > ss_ver || (by & 1));
    const int cbw4 = (bw4 + ss_hor) >> ss_hor;
    const int cbh4 = (bh4 + ss_ver) >> ss_ver;
    const int dst_y = 4 * by, dst_x = 4 * bx;
    const int cdst_y = 4 * (by >> ss_ver), cdst_x = 4 * (bx >> ss_hor);
    const int ref0 = cb->pad0 - 1, ref1 = cb->pad1 - 1;
    const int chr_layout_idx = rc->layout ? 3 - rc->layout : 0;

    if (cb->comp_type == CT_NONE) {
        if (!ic->ref_ok[ref0])
            return 0;
        if (cb->filter2d > 8)
            return 0;
        const int32_t *mat;
        int32_t abcd[4];
        int warp_type;
        if (cb->motion_mode == MM_WARP) {
            if (cb->warp_idx < 0)
                return 0;
            const CapWarp *w = &ic->cap_warp[cb->warp_idx];
            mat = w->matrix;
            for (int i = 0; i < 4; i++)
                abcd[i] = w->abcd[i];
            warp_type = w->type;
        } else {
            mat = ic->gmv_matrix[ref0];
            for (int i = 0; i < 4; i++)
                abcd[i] = ic->gmv_abcd[ref0][i];
            warp_type = ic->gmv_type[ref0];
        }
        const int use_warp_y =
            imin(bw4, bh4) > 1 &&
            ((cb->inter_mode == IPM_GLOBALMV &&
              ic->gmv_warp_allowed[ref0]) ||
             (cb->motion_mode == MM_WARP && warp_type > 1));
        if (use_warp_y) {
            warp_c(c, 0, ref0, bw4, bh4, mat, abcd, 0,
                   rc->planes[0] + (int64_t)dst_y * rc->stride[0] + dst_x,
                   rc->stride[0]);
        } else {
            mc_c(c, 0, ref0, bx, by, bw4, bh4, cb->mv[0][0], cb->mv[0][1],
                 cb->filter2d, 0,
                 rc->planes[0] + (int64_t)dst_y * rc->stride[0] + dst_x,
                 rc->stride[0]);
            if (cb->motion_mode == MM_OBMC && !obmc_c(c, 0, cb, bw4, bh4))
                return 0;
        }
        if (has_chroma) {
            int is_sub8x8 = bw4 == ss_hor || bh4 == ss_ver;
            if (is_sub8x8) {
                if (!ic->rb)
                    return 0;
                if (bw4 == 1)
                    is_sub8x8 &= rb_ref0(rb_cell(ic, by, bx - 1)) > 0;
                if (bh4 == ss_ver)
                    is_sub8x8 &= rb_ref0(rb_cell(ic, by - 1, bx)) > 0;
                if (bw4 == 1 && bh4 == ss_ver)
                    is_sub8x8 &=
                        rb_ref0(rb_cell(ic, by - 1, bx - 1)) > 0;
            }
            if (is_sub8x8) {
                if (cb->sub8x8 < 0)
                    return 0;
                if (!sub8x8_chroma_c(c, cb, bw4, bh4, cdst_y, cdst_x))
                    return 0;
            } else {
                const int use_warp_uv =
                    imin(cbw4, cbh4) > 1 &&
                    ((cb->inter_mode == IPM_GLOBALMV &&
                      ic->gmv_warp_allowed[ref0]) ||
                     (cb->motion_mode == MM_WARP && warp_type > 1));
                for (int pl = 1; pl < 3; pl++) {
                    if (use_warp_uv) {
                        warp_c(c, pl, ref0, bw4, bh4, mat, abcd, 0,
                               rc->planes[pl] +
                                   (int64_t)cdst_y * rc->stride[pl] +
                                   cdst_x,
                               rc->stride[pl]);
                    } else {
                        mc_c(c, pl, ref0, bx & ~ss_hor, by & ~ss_ver,
                             bw4 << (bw4 == ss_hor),
                             bh4 << (bh4 == ss_ver), cb->mv[0][0],
                             cb->mv[0][1], cb->filter2d, 0,
                             rc->planes[pl] +
                                 (int64_t)cdst_y * rc->stride[pl] + cdst_x,
                             rc->stride[pl]);
                        if (cb->motion_mode == MM_OBMC &&
                            !obmc_c(c, pl, cb, bw4, bh4))
                            return 0;
                    }
                }
            }
        }
    } else {
        /* compound */
        if (!ic->ref_ok[ref0] || !ic->ref_ok[ref1])
            return 0;
        if (cb->filter2d > 8)
            return 0;
        const int w_px = bw4 * 4, h_px = bh4 * 4;
        const int refs[2] = {ref0, ref1};
        const int16_t(*mvs)[2] = cb->mv;
        int32_t *tmp[2] = {s_tmp0, s_tmp1};
        for (int i = 0; i < 2; i++) {
            if (cb->inter_mode == CIPM_GLOBALMV_GLOBALMV &&
                ic->gmv_warp_allowed[refs[i]]) {
                int32_t abcd[4];
                for (int k = 0; k < 4; k++)
                    abcd[k] = ic->gmv_abcd[refs[i]][k];
                warp_c(c, 0, refs[i], bw4, bh4, ic->gmv_matrix[refs[i]],
                       abcd, 1, tmp[i], w_px);
            } else {
                mc_c(c, 0, refs[i], bx, by, bw4, bh4, mvs[i][0],
                     mvs[i][1], cb->filter2d, 1, tmp[i], 0);
            }
        }
        const int jw = ic->jnt_weights[ref0][ref1];
        const int sign = cb->mask_sign;
        const uint8_t *cmask = 0; /* chroma-stage mask */
        int cmask_stride = 0;
        int32_t *dst0 = rc->planes[0] + (int64_t)dst_y * rc->stride[0] +
                        dst_x;
        if (cb->comp_type == CT_SEG) {
            w_mask_c(c, dst0, rc->stride[0], w_px, h_px, tmp[sign],
                     tmp[!sign], sign, ss_hor, ss_ver, rc->bitdepth);
            cmask = s_mask;
            cmask_stride = w_px >> ss_hor;
        } else if (cb->comp_type == CT_WEDGE) {
            const uint8_t *m =
                wedge_mask_ptr(ic, 0, cb->bs, 0, cb->wedge_idx);
            blend_into(c, dst0, rc->stride[0], w_px, h_px, tmp[sign],
                       tmp[!sign], CT_WEDGE, 0, m, w_px);
            cmask = wedge_mask_ptr(ic, chr_layout_idx, cb->bs, sign,
                                   cb->wedge_idx);
            cmask_stride = w_px >> ss_hor;
        } else {
            blend_into(c, dst0, rc->stride[0], w_px, h_px, tmp[0], tmp[1],
                       cb->comp_type, jw, 0, 0);
        }
        if (has_chroma) {
            const int cw_px = w_px >> ss_hor, ch_px = h_px >> ss_ver;
            for (int pl = 1; pl < 3; pl++) {
                for (int i = 0; i < 2; i++) {
                    if (cb->inter_mode == CIPM_GLOBALMV_GLOBALMV &&
                        imin(cbw4, cbh4) > 1 &&
                        ic->gmv_warp_allowed[refs[i]]) {
                        int32_t abcd[4];
                        for (int k = 0; k < 4; k++)
                            abcd[k] = ic->gmv_abcd[refs[i]][k];
                        warp_c(c, pl, refs[i], bw4, bh4,
                               ic->gmv_matrix[refs[i]], abcd, 1, tmp[i],
                               cw_px);
                    } else {
                        mc_c(c, pl, refs[i], bx, by, bw4, bh4, mvs[i][0],
                             mvs[i][1], cb->filter2d, 1, tmp[i], 0);
                    }
                }
                int32_t *dstc = rc->planes[pl] +
                                (int64_t)cdst_y * rc->stride[pl] + cdst_x;
                if (cb->comp_type == CT_SEG || cb->comp_type == CT_WEDGE)
                    blend_into(c, dstc, rc->stride[pl], cw_px, ch_px,
                               tmp[sign], tmp[!sign], CT_WEDGE, 0, cmask,
                               cmask_stride);
                else
                    blend_into(c, dstc, rc->stride[pl], cw_px, ch_px,
                               tmp[0], tmp[1], cb->comp_type, jw, 0, 0);
            }
        }
    }
    return 1;
}

int64_t dtpu_inter_replay(const DtpuReplayCtx *rc, const DtpuInterCtx *ic,
                          int64_t start, int64_t end, int add_resid,
                          int64_t *skipped, const uint8_t *handled)
{
    ICtx c;
    c.rc = rc;
    c.ic = ic;
    c.ib = rc->bitdepth == 8 ? 4 : 14 - rc->bitdepth;
    c.maxp = (1 << rc->bitdepth) - 1;
    c.prep_bias = rc->bitdepth == 8 ? 0 : 8192;
    int64_t n_skipped = 0;

    for (int64_t bi = start; bi < end; bi++) {
        const CapBlock *cb = &rc->cap_blocks[bi];
        if (cb->kind != 1 || cb->interintra_type)
            continue;
        if (handled && handled[bi])
            continue; /* predicted by the batched device MC stage */
        /* missing residual (host tier only): whole block to Python */
        int ok = 1;
        if (add_resid) {
            for (int64_t m = cb->coef_start;
                 m < cb->coef_start + cb->coef_count; m++) {
                const int32_t *mrow = rc->coef_meta + m * CAP_COEF_WORDS;
                if (mrow[0] >= 0 && !rc->resid_ptrs[m]) {
                    ok = 0;
                    break;
                }
            }
        }
        if (ok)
            ok = replay_inter_block(&c, cb);
        if (!ok) {
            skipped[n_skipped++] = bi;
            continue;
        }
        if (add_resid && !cb->skip)
            add_block_residuals(rc, cb, c.maxp);
    }
    return n_skipped;
}

void dtpu_add_inter_residuals(const DtpuReplayCtx *rc, int64_t start,
                              int64_t end, const int64_t *skipped,
                              int64_t n_skipped, const uint8_t *handled)
{
    const int maxp = (1 << rc->bitdepth) - 1;
    int64_t si = 0;
    for (int64_t bi = start; bi < end; bi++) {
        while (si < n_skipped && skipped[si] < bi)
            si++;
        if (si < n_skipped && skipped[si] == bi)
            continue;
        if (handled && handled[bi])
            continue; /* added by dtpu_add_block_residuals after scatter */
        const CapBlock *cb = &rc->cap_blocks[bi];
        if (cb->kind != 1 || cb->interintra_type || cb->skip)
            continue;
        add_block_residuals(rc, cb, maxp);
    }
}

/* Residual adds for an explicit block-index list (the device-MC stage's
 * blocks, once their predictions have been scattered into the planes). */
void dtpu_add_block_residuals(const DtpuReplayCtx *rc, const int64_t *idxs,
                              int64_t n)
{
    const int maxp = (1 << rc->bitdepth) - 1;
    for (int64_t i = 0; i < n; i++) {
        const CapBlock *cb = &rc->cap_blocks[idxs[i]];
        if (cb->skip)
            continue;
        add_block_residuals(rc, cb, maxp);
    }
}
