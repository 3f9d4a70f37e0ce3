/* Native block-decode layer: the per-tile-sbrow symbol-decode walk
 * (pass 1 of the two-pass pipeline).
 *
 * Bit-exact port of the Python reference dav1d_tpu/decode/tile.py
 * (decode_sb/decode_b), dav1d_tpu/env.py (neighbour contexts),
 * dav1d_tpu/warpmv.py and the pass-1 capture paths of
 * recon/intra.py//inter.py (reference src/decode.c:683-2389,
 * src/recon_tmpl.c pass-1; AV1 spec 5.11).  The Python modules remain
 * the reference/fallback; capture records land in the flat arenas of
 * DtpuFrameCtx (decode_glue.py rebuilds the replay records).
 */

#include <string.h>

#include "dtpu.h"

#define U8(x) ((uint8_t)(x))

static inline int dmin_(int a, int b) { return a < b ? a : b; }
static inline int dmax_(int a, int b) { return a > b ? a : b; }
static inline int dclip_(int v, int lo, int hi)
{
    return v < lo ? lo : v > hi ? hi : v;
}

/* enum values (dav1d_tpu/levels.py, headers.py) */
enum { BL_128X128 = 0, BL_64X64, BL_32X32, BL_16X16, BL_8X8 };
enum { BP_NONE = 0, BP_H, BP_V, BP_SPLIT, BP_T_TOP, BP_T_BOTTOM,
       BP_T_LEFT, BP_T_RIGHT, BP_H4, BP_V4 };
enum { M_DC_PRED = 0, M_VERT_PRED = 1, M_VERT_LEFT_PRED = 8,
       M_CFL_PRED = 13, M_FILTER_PRED = 13 };
enum { IPM_NEARESTMV = 0, IPM_NEARMV, IPM_GLOBALMV, IPM_NEWMV };
enum { CIPM_NEARESTMV_NEARESTMV = 0, CIPM_NEARMV_NEARMV,
       CIPM_NEARESTMV_NEWMV, CIPM_NEWMV_NEARESTMV, CIPM_NEARMV_NEWMV,
       CIPM_NEWMV_NEARMV, CIPM_GLOBALMV_GLOBALMV, CIPM_NEWMV_NEWMV };
enum { CT_NONE = 0, CT_WEIGHTED_AVG, CT_AVG, CT_SEG, CT_WEDGE };
enum { II_NONE = 0, II_BLEND, II_WEDGE };
enum { MM_TRANSLATION = 0, MM_OBMC, MM_WARP };
enum { TX_4X4 = 0, TX_8X8, TX_16X16, TX_32X32, TX_64X64 };
enum { TXFM_MODE_ONLY4X4 = 0, TXFM_MODE_LARGEST, TXFM_MODE_SWITCHABLE };
enum { FILTER_SWITCHABLE = 4 };
enum { WM_IDENTITY = 0, WM_TRANSLATION, WM_ROT_ZOOM, WM_AFFINE };
enum { RT_NONE = 0, RT_SWITCHABLE, RT_WIENER, RT_SGRPROJ };
enum { TXFM_WHT = 16, TXFM_DCT = 0 };

/* intra-edge flags (intra_edge.py) */
#define EF_I444_TOP 1
#define EF_I422_TOP 2
#define EF_I420_TOP 4
#define EF_ALL_TOP 7
#define EF_I444_LEFT 8
#define EF_I422_LEFT 16
#define EF_I420_LEFT 32
#define EF_ALL_LEFT 56
#define EF_ALL 63

/* ---- per-block mode state (subset of Av1Block) -------------------------- */

typedef struct {
    int bl, bs, bp, intra, seg_id, skip_mode, skip;
    int y_mode, uv_mode, tx, uvtx, pal_sz[2], y_angle, uv_angle;
    int cfl_alpha[2];
    int mv[2][2]; /* [idx][0]=y [1]=x */
    int wedge_idx, mask_sign, interintra_mode;
    int comp_type, inter_mode, motion_mode, drl_idx, ref[2];
    int max_ytx, filter2d, interintra_type;
    uint32_t tx_split0, tx_split1;
} Blk;

/* ---- small msac helpers (delta coding) ---------------------------------- */

static int read_delta(DtpuMsac *s, uint16_t *cdf, int res_log2)
{
    int v = dtpu_decode_symbol_adapt(s, cdf, 3);
    if (v == 3) {
        const int n_bits = 1 + (int)dtpu_decode_bools(s, 3);
        v = (int)dtpu_decode_bools(s, n_bits) + 1 + (1 << n_bits);
    }
    if (v) {
        if (dtpu_decode_bool_equi(s))
            v = -v;
        v *= 1 << res_log2;
    }
    return v;
}

/* ---- quant / loop-filter level recompute (delta q / delta lf) ----------- */

static inline int clip_u8_(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

/* decode/frame.py init_quant_tables (reference src/decode.c:54-74);
 * dq_tbl is the bitdepth-selected (256, 2) table. */
static void recompute_dq(const DtpuFrameCtx *f, DtpuTileCtx *ts, int qidx)
{
    const uint16_t *tbl = f->dq_tbl;
    const int n = f->seg_enabled ? 8 : 1;
    for (int i = 0; i < n; i++) {
        const int yac = f->seg_enabled
            ? clip_u8_(qidx + f->seg_d[i].delta_q) : qidx;
        ts->dq[i][0][0] = tbl[2 * clip_u8_(yac + f->quant_ydc_d)];
        ts->dq[i][0][1] = tbl[2 * yac + 1];
        ts->dq[i][1][0] = tbl[2 * clip_u8_(yac + f->quant_udc_d)];
        ts->dq[i][1][1] = tbl[2 * clip_u8_(yac + f->quant_uac_d) + 1];
        ts->dq[i][2][0] = tbl[2 * clip_u8_(yac + f->quant_vdc_d)];
        ts->dq[i][2][1] = tbl[2 * clip_u8_(yac + f->quant_vac_d) + 1];
    }
}

/* recon/lf.py _calc_lf_value */
static void calc_lf_value(uint8_t out[8][2], const DtpuFrameCtx *f,
                          int base_lvl, int lf_delta, int seg_delta)
{
    const int base =
        dclip_(dclip_(base_lvl + lf_delta, 0, 63) + seg_delta, 0, 63);
    if (!f->lf_mode_ref_delta_enabled) {
        for (int r = 0; r < 8; r++)
            out[r][0] = out[r][1] = U8(base);
        return;
    }
    const int sh = base >= 32;
    out[0][0] = out[0][1] =
        U8(dclip_(base + f->lf_ref_deltas[0] * (1 << sh), 0, 63));
    for (int r = 1; r < 8; r++)
        for (int m = 0; m < 2; m++) {
            const int delta = f->lf_mode_deltas[m] + f->lf_ref_deltas[r];
            out[r][m] = U8(dclip_(base + delta * (1 << sh), 0, 63));
        }
}

/* recon/lf.py calc_lf_values: fills ts->lflvl (8 seg, 4 plane-dir, 8, 2) */
static void recompute_lflvl(const DtpuFrameCtx *f, DtpuTileCtx *ts,
                            const int lf_delta[4])
{
    const int n_seg = f->seg_enabled ? 8 : 1;
    memset(ts->lflvl, 0, sizeof(ts->lflvl));
    if (!f->lf_level_y[0] && !f->lf_level_y[1])
        return;
    const int multi = f->delta_lf_multi;
    for (int s = 0; s < n_seg; s++) {
        const DtpuSegData *sd = f->seg_enabled ? &f->seg_d[s] : NULL;
        calc_lf_value(ts->lflvl[s][0], f, f->lf_level_y[0], lf_delta[0],
                      sd ? sd->delta_lf_y_v : 0);
        calc_lf_value(ts->lflvl[s][1], f, f->lf_level_y[1],
                      lf_delta[multi ? 1 : 0], sd ? sd->delta_lf_y_h : 0);
        if (f->lf_level_u)
            calc_lf_value(ts->lflvl[s][2], f, f->lf_level_u,
                          lf_delta[multi ? 2 : 0], sd ? sd->delta_lf_u : 0);
        if (f->lf_level_v)
            calc_lf_value(ts->lflvl[s][3], f, f->lf_level_v,
                          lf_delta[multi ? 3 : 0], sd ? sd->delta_lf_v : 0);
    }
}

/* ---- restoration-unit info (decode/frame.py _read_restoration_info) ---- */

static void read_restoration_info(DtpuTileCtx *ts, DtpuLrUnit *lr, int p,
                                  int frame_type, const DtpuFrameCtx *f)
{
    DtpuMsac *s = ts->msac;
    DtpuLrRef *ref = &ts->lr_ref[p];

    if (frame_type == RT_SWITCHABLE) {
        const int filt =
            dtpu_decode_symbol_adapt(s, ts->restore_switchable, 2);
        lr->type = (int16_t)(filt + (filt ? 1 : 0));
    } else {
        const int ty = dtpu_decode_bool_adapt(
            s, frame_type == RT_WIENER ? ts->restore_wiener
                                       : ts->restore_sgrproj);
        lr->type = (int16_t)(ty ? frame_type : RT_NONE);
    }

    if (lr->type == RT_WIENER) {
        lr->filter_v[0] = (int16_t)(
            p ? 0 : dtpu_decode_subexp(s, ref->filter_v[0] + 5, 16, 1) - 5);
        lr->filter_v[1] = (int16_t)(
            dtpu_decode_subexp(s, ref->filter_v[1] + 23, 32, 2) - 23);
        lr->filter_v[2] = (int16_t)(
            dtpu_decode_subexp(s, ref->filter_v[2] + 17, 64, 3) - 17);
        lr->filter_h[0] = (int16_t)(
            p ? 0 : dtpu_decode_subexp(s, ref->filter_h[0] + 5, 16, 1) - 5);
        lr->filter_h[1] = (int16_t)(
            dtpu_decode_subexp(s, ref->filter_h[1] + 23, 32, 2) - 23);
        lr->filter_h[2] = (int16_t)(
            dtpu_decode_subexp(s, ref->filter_h[2] + 17, 64, 3) - 17);
        lr->sgr_weights[0] = ref->sgr_weights[0];
        lr->sgr_weights[1] = ref->sgr_weights[1];
        for (int i = 0; i < 3; i++) {
            ref->filter_v[i] = lr->filter_v[i];
            ref->filter_h[i] = lr->filter_h[i];
        }
    } else if (lr->type == RT_SGRPROJ) {
        const int idx = (int)dtpu_decode_bools(s, 4);
        const uint16_t *sp = f->sgr_params + 2 * idx;
        lr->type = (int16_t)(lr->type + idx);
        lr->sgr_weights[0] = (int16_t)(
            sp[0] ? dtpu_decode_subexp(s, ref->sgr_weights[0] + 96, 128, 4)
                        - 96
                  : 0);
        lr->sgr_weights[1] = (int16_t)(
            sp[1] ? dtpu_decode_subexp(s, ref->sgr_weights[1] + 32, 128, 4)
                        - 32
                  : 95);
        for (int i = 0; i < 3; i++) {
            lr->filter_v[i] = ref->filter_v[i];
            lr->filter_h[i] = ref->filter_h[i];
        }
        ref->sgr_weights[0] = lr->sgr_weights[0];
        ref->sgr_weights[1] = lr->sgr_weights[1];
    }
}

/* decode/frame.py _read_lr_for_sb */
static void read_lr_for_sb(DtpuFrameCtx *f, DtpuTileCtx *ts, DtpuTaskCtx *t)
{
    if (!f->restore_planes)
        return;
    const int sb_step = f->sb_step;
    for (int p = 0; p < 3; p++) {
        if (!((f->restore_planes >> p) & 1))
            continue;
        const int ss_ver = p ? f->ss_ver : 0;
        const int ss_hor = p ? f->ss_hor : 0;
        const int usl2 = f->restoration_unit_size[p ? 1 : 0];
        const int y = (t->by * 4) >> ss_ver;
        const int h = (f->frame_h + ss_ver) >> ss_ver;
        const int unit_size = 1 << usl2;
        const int mask = unit_size - 1;
        if (y & mask)
            continue;
        const int half_unit = unit_size >> 1;
        if (y && y + half_unit > h)
            continue;
        const int frame_type = f->restoration_type[p];
        if (f->frame_w0 != f->frame_w1) {
            const int w = (f->frame_w1 + ss_hor) >> ss_hor;
            const int n_units = dmax_(1, (w + half_unit) >> usl2);
            const int d = f->superres_denom;
            const int rnd = unit_size * 8 - 1, shift = usl2 + 3;
            const int x0 = (((4 * t->bx * d) >> ss_hor) + rnd) >> shift;
            const int x1 =
                (((4 * (t->bx + sb_step) * d) >> ss_hor) + rnd) >> shift;
            for (int x = x0; x < dmin_(x1, n_units); x++) {
                const int px_x = x << (usl2 + ss_hor);
                const int sb_idx =
                    (t->by >> 5) * f->sr_sb128w + (px_x >> 7);
                const int unit_idx =
                    ((t->by & 16) >> 3) + ((px_x & 64) >> 6);
                read_restoration_info(
                    ts, &f->lr_units[(sb_idx * 3 + p) * 4 + unit_idx], p,
                    frame_type, f);
            }
        } else {
            const int x = (4 * t->bx) >> ss_hor;
            if (x & mask)
                continue;
            const int w = (f->frame_w0 + ss_hor) >> ss_hor;
            if (x && x + half_unit > w)
                continue;
            const int sb_idx = (t->by >> 5) * f->sr_sb128w + (t->bx >> 5);
            const int unit_idx = ((t->by & 16) >> 3) + ((t->bx & 16) >> 4);
            read_restoration_info(
                ts, &f->lr_units[(sb_idx * 3 + p) * 4 + unit_idx], p,
                frame_type, f);
        }
    }
}

/* ---- MV residual (decode/tile.py read_mv_component_diff/read_mv_residual) */

static int read_mv_component_diff(DtpuMsac *s, DtpuTileCtx *ts, int comp,
                                  int mv_prec)
{
    const int sign = dtpu_decode_bool_adapt(s, ts->mv_sign[comp]);
    const int cl = dtpu_decode_symbol_adapt(s, ts->mv_classes[comp], 10);
    int up, fp = 3, hp = 1;
    if (!cl) {
        up = dtpu_decode_bool_adapt(s, ts->mv_class0[comp]);
        if (mv_prec >= 0) {
            fp = dtpu_decode_symbol_adapt(
                s, ts->mv_class0_fp[comp] + 4 * up, 3);
            if (mv_prec > 0)
                hp = dtpu_decode_bool_adapt(s, ts->mv_class0_hp[comp]);
        }
    } else {
        up = 1 << cl;
        for (int n = 0; n < cl; n++)
            up |= dtpu_decode_bool_adapt(s, ts->mv_classN[comp] + 2 * n)
                  << n;
        if (mv_prec >= 0) {
            fp = dtpu_decode_symbol_adapt(s, ts->mv_classN_fp[comp], 3);
            if (mv_prec > 0)
                hp = dtpu_decode_bool_adapt(s, ts->mv_classN_hp[comp]);
        }
    }
    const int diff = ((up << 3) | (fp << 1) | hp) + 1;
    return sign ? -diff : diff;
}

static void read_mv_residual(DtpuTileCtx *ts, int *y, int *x, int mv_prec)
{
    DtpuMsac *s = ts->msac;
    const int mv_joint = dtpu_decode_symbol_adapt(s, ts->mv_joint, 3);
    if (mv_joint & 2) /* MVJoint.V */
        *y += read_mv_component_diff(s, ts, 0, mv_prec);
    if (mv_joint & 1) /* MVJoint.H */
        *x += read_mv_component_diff(s, ts, 1, mv_prec);
}

/* ---- env.py neighbour contexts ------------------------------------------ */

typedef BlockCtx BC;

static int get_intra_ctx(const BC *a, const BC *l, int yb4, int xb4,
                         int have_top, int have_left)
{
    if (have_left) {
        if (have_top) {
            const int ctx = l->intra[yb4] + a->intra[xb4];
            return ctx + (ctx == 2);
        }
        return l->intra[yb4] * 2;
    }
    return have_top ? a->intra[xb4] * 2 : 0;
}

static int get_comp_ctx(const BC *a, const BC *l, int yb4, int xb4,
                        int have_top, int have_left)
{
    if (have_top) {
        if (have_left) {
            if (a->comp_type[xb4]) {
                if (l->comp_type[yb4])
                    return 4;
                return 2 + (l->ref[0][yb4] >= 4 || l->ref[0][yb4] < 0);
            }
            if (l->comp_type[yb4])
                return 2 + (a->ref[0][xb4] >= 4 || a->ref[0][xb4] < 0);
            return (l->ref[0][yb4] >= 4) ^ (a->ref[0][xb4] >= 4);
        }
        return a->comp_type[xb4] ? 3 : a->ref[0][xb4] >= 4;
    }
    if (have_left)
        return l->comp_type[yb4] ? 3 : l->ref[0][yb4] >= 4;
    return 1;
}

static int has_uni_comp(const BC *e, int off)
{
    return (e->ref[0][off] < 4) == (e->ref[1][off] < 4);
}

static int get_comp_dir_ctx(const BC *a, const BC *l, int yb4, int xb4,
                            int have_top, int have_left)
{
    if (have_top && have_left) {
        const int a_intra = a->intra[xb4], l_intra = l->intra[yb4];
        if (a_intra && l_intra)
            return 2;
        if (a_intra || l_intra) {
            const BC *e = a_intra ? l : a;
            const int off = a_intra ? yb4 : xb4;
            if (e->comp_type[off] == CT_NONE)
                return 2;
            return 1 + 2 * has_uni_comp(e, off);
        }
        const int a_comp = a->comp_type[xb4] != CT_NONE;
        const int l_comp = l->comp_type[yb4] != CT_NONE;
        const int a_ref0 = a->ref[0][xb4], l_ref0 = l->ref[0][yb4];
        if (!a_comp && !l_comp)
            return 1 + 2 * ((a_ref0 >= 4) == (l_ref0 >= 4));
        if (!a_comp || !l_comp) {
            const BC *e = a_comp ? a : l;
            const int off = a_comp ? xb4 : yb4;
            if (!has_uni_comp(e, off))
                return 1;
            return 3 + ((a_ref0 >= 4) == (l_ref0 >= 4));
        }
        const int a_uni = has_uni_comp(a, xb4), l_uni = has_uni_comp(l, yb4);
        if (!a_uni && !l_uni)
            return 0;
        if (!a_uni || !l_uni)
            return 2;
        return 3 + ((a_ref0 == 4) == (l_ref0 == 4));
    }
    if (have_top || have_left) {
        const BC *e = have_left ? l : a;
        const int off = have_left ? yb4 : xb4;
        if (e->intra[off])
            return 2;
        if (e->comp_type[off] == CT_NONE)
            return 2;
        return 4 * has_uni_comp(e, off);
    }
    return 2;
}

static int get_jnt_comp_ctx(const DtpuFrameCtx *f, int ref0, int ref1,
                            const BC *a, const BC *l, int yb4, int xb4)
{
    const int offset = f->jnt_offset[ref0][ref1];
    const int a_ctx = a->comp_type[xb4] >= CT_AVG || a->ref[0][xb4] == 6;
    const int l_ctx = l->comp_type[yb4] >= CT_AVG || l->ref[0][yb4] == 6;
    return offset + a_ctx + l_ctx;
}

static int get_mask_comp_ctx(const BC *a, const BC *l, int yb4, int xb4)
{
    const int a_ctx = a->comp_type[xb4] >= CT_SEG
        ? 1 : (a->ref[0][xb4] == 6 ? 3 : 0);
    const int l_ctx = l->comp_type[yb4] >= CT_SEG
        ? 1 : (l->ref[0][yb4] == 6 ? 3 : 0);
    return dmin_(a_ctx + l_ctx, 5);
}

static int get_filter_ctx(const BC *a, const BC *l, int comp, int dir,
                          int ref, int yb4, int xb4)
{
    const int a_filter =
        (a->ref[0][xb4] == ref || a->ref[1][xb4] == ref)
            ? a->filter[dir][xb4] : 3;
    const int l_filter =
        (l->ref[0][yb4] == ref || l->ref[1][yb4] == ref)
            ? l->filter[dir][yb4] : 3;
    if (a_filter == l_filter)
        return comp * 4 + a_filter;
    if (a_filter == 3)
        return comp * 4 + l_filter;
    if (l_filter == 3)
        return comp * 4 + a_filter;
    return comp * 4 + 3;
}

static int cnt_cmp(int c0, int c1)
{
    return c0 == c1 ? 1 : (c0 < c1 ? 0 : 2);
}

/* the _gather + per-ctx counting family (env.py:98-176): mode selects
 * which ref counter the gathered refs update */
enum { GATHER_FWDBWD, GATHER_FWD03, GATHER_FWD01, GATHER_FWD23,
       GATHER_BWD, GATHER_UNI1 };

static void gather_cnt(int *cnt, int r, int mode)
{
    switch (mode) {
    case GATHER_FWDBWD: cnt[r >= 4]++; break;
    case GATHER_FWD03: if (r >= 0 && r < 4) cnt[r]++; break;
    case GATHER_FWD01: if (r >= 0 && r < 2) cnt[r]++; break;
    case GATHER_FWD23: if (r >= 0 && ((r ^ 2) < 2)) cnt[r - 2]++; break;
    case GATHER_BWD: if (r >= 4) cnt[r - 4]++; break;
    case GATHER_UNI1: if (r >= 1 && r < 4) cnt[r - 1]++; break;
    }
}

static void gather(int *cnt, const BC *a, const BC *l, int yb4, int xb4,
                   int have_top, int have_left, int mode)
{
    memset(cnt, 0, 7 * sizeof(int));
    if (have_top && !a->intra[xb4]) {
        gather_cnt(cnt, a->ref[0][xb4], mode);
        if (a->comp_type[xb4])
            gather_cnt(cnt, a->ref[1][xb4], mode);
    }
    if (have_left && !l->intra[yb4]) {
        gather_cnt(cnt, l->ref[0][yb4], mode);
        if (l->comp_type[yb4])
            gather_cnt(cnt, l->ref[1][yb4], mode);
    }
}

#define DEF_REF_CTX(name, mode, e0, e1)                                     \
    static int name(const BC *a, const BC *l, int yb4, int xb4,             \
                    int have_top, int have_left)                            \
    {                                                                       \
        int c[7];                                                           \
        gather(c, a, l, yb4, xb4, have_top, have_left, mode);               \
        return cnt_cmp(e0, e1);                                             \
    }

DEF_REF_CTX(ref_ctx, GATHER_FWDBWD, c[0], c[1])
DEF_REF_CTX(fwd_ref_ctx, GATHER_FWD03, c[0] + c[1], c[2] + c[3])
DEF_REF_CTX(fwd_ref_1_ctx, GATHER_FWD01, c[0], c[1])
DEF_REF_CTX(fwd_ref_2_ctx, GATHER_FWD23, c[0], c[1])
DEF_REF_CTX(bwd_ref_ctx, GATHER_BWD, c[1] + c[0], c[2])
DEF_REF_CTX(bwd_ref_1_ctx, GATHER_BWD, c[0], c[1])
DEF_REF_CTX(uni_p1_ctx, GATHER_UNI1, c[0], c[1] + c[2])

static int get_drl_context(const DtpuMvCand *stack, int ref_idx)
{
    if (stack[ref_idx].weight >= 640)
        return stack[ref_idx + 1].weight < 640;
    return stack[ref_idx + 1].weight < 640 ? 2 : 0;
}

static int findoddzero(const uint8_t *arr, int off, int n)
{
    for (int i = 0; i < n; i++)
        if (!arr[off + i * 2])
            return 1;
    return 0;
}

/* partition contexts (decode/tile.py:163-181) */
static int get_partition_ctx(const BC *a, const BC *l, int bl, int yb8,
                             int xb8)
{
    return ((a->partition[xb8] >> (4 - bl)) & 1)
           + (((l->partition[yb8] >> (4 - bl)) & 1) << 1);
}

static unsigned gather_left_partition_prob(const uint16_t *cdf, int bl)
{
    unsigned out = (unsigned)(cdf[BP_H - 1] - cdf[BP_H]);
    out += (unsigned)(cdf[BP_SPLIT - 1] - cdf[BP_T_LEFT]);
    if (bl != BL_128X128)
        out += (unsigned)(cdf[BP_H4 - 1] - cdf[BP_H4]);
    return out;
}

static unsigned gather_top_partition_prob(const uint16_t *cdf, int bl)
{
    unsigned out = (unsigned)(cdf[BP_V - 1] - cdf[BP_T_TOP]);
    out += (unsigned)cdf[BP_T_LEFT - 1];
    if (bl != BL_128X128)
        out += (unsigned)(cdf[BP_V4 - 1] - cdf[BP_T_RIGHT]);
    return out;
}

static int get_tx_ctx(const BC *a, const BC *l, int max_tx_lw, int max_tx_lh,
                      int yb4, int xb4)
{
    return ((int8_t)l->tx_intra[yb4] >= max_tx_lh)
           + ((int8_t)a->tx_intra[xb4] >= max_tx_lw);
}

static int neg_deinterleave(int diff, int ref, int max)
{
    if (!ref)
        return diff;
    if (ref >= max - 1)
        return max - diff - 1;
    if (2 * ref < max) {
        if (diff <= 2 * ref) {
            if (diff & 1)
                return ref + ((diff + 1) >> 1);
            return ref - (diff >> 1);
        }
        return diff;
    }
    if (diff <= 2 * (max - ref - 1)) {
        if (diff & 1)
            return ref + ((diff + 1) >> 1);
        return ref - (diff >> 1);
    }
    return max - (diff + 1);
}

/* segmentation (decode/tile.py get_cur_frame_segid / _prev_segid) */
static int get_cur_frame_segid(const DtpuFrameCtx *f, int by, int bx,
                               int have_top, int have_left, int *seg_ctx)
{
    const uint8_t *m = f->cur_segmap;
    const int st = f->cur_segmap_stride;
    if (have_left && have_top) {
        const int l = m[(int64_t)by * st + bx - 1];
        const int a = m[(int64_t)(by - 1) * st + bx];
        const int al = m[(int64_t)(by - 1) * st + bx - 1];
        if (l == a && al == l)
            *seg_ctx = 2;
        else if (l == a || al == l || a == al)
            *seg_ctx = 1;
        else
            *seg_ctx = 0;
        return a == al ? a : l;
    }
    *seg_ctx = 0;
    if (have_left)
        return m[(int64_t)by * st + bx - 1];
    if (have_top)
        return m[(int64_t)(by - 1) * st + bx];
    return 0;
}

static int prev_segid(const DtpuFrameCtx *f, int by, int bx, int w4, int h4)
{
    const uint8_t *m = f->prev_segmap;
    const int st = f->prev_segmap_stride;
    int mn = 8;
    for (int y = 0; y < h4; y++)
        for (int x = 0; x < w4; x++)
            mn = dmin_(mn, m[(int64_t)(by + y) * st + bx + x]);
    return mn;
}

/* ---- palette (decode/tile.py _read_pal_plane/_read_pal_uv/indices) ----- */

static void read_pal_plane(DtpuFrameCtx *f, DtpuTileCtx *ts, DtpuTaskCtx *t,
                           Blk *b, int pl, int sz_ctx, int bx4, int by4)
{
    DtpuMsac *s = ts->msac;
    const int pal_sz = b->pal_sz[pl] =
        dtpu_decode_symbol_adapt(s, ts->pal_sz + (pl * 7 + sz_ctx) * 8, 6)
        + 2;
    uint16_t cache[16], used_cache[8];
    int n_cache = 0;
    /* al_pal layout: [2][32][3][8] */
    int l_cache = pl ? t->pal_sz_uv[32 + by4] : t->l->pal_sz[by4];
    int a_cache = (by4 & 15)
        ? (pl ? t->pal_sz_uv[bx4] : t->a->pal_sz[bx4]) : 0;
    const uint16_t *lpal = t->al_pal + ((1 * 32 + by4) * 3 + pl) * 8;
    const uint16_t *apal = t->al_pal + ((0 * 32 + bx4) * 3 + pl) * 8;
    int li = 0, ai = 0;
    while (l_cache && a_cache) {
        const int lv = lpal[li], av = apal[ai];
        if (lv < av) {
            if (!n_cache || cache[n_cache - 1] != lv)
                cache[n_cache++] = (uint16_t)lv;
            li++;
            l_cache--;
        } else {
            if (av == lv) {
                li++;
                l_cache--;
            }
            if (!n_cache || cache[n_cache - 1] != av)
                cache[n_cache++] = (uint16_t)av;
            ai++;
            a_cache--;
        }
    }
    while (l_cache) {
        const int lv = lpal[li];
        if (!n_cache || cache[n_cache - 1] != lv)
            cache[n_cache++] = (uint16_t)lv;
        li++;
        l_cache--;
    }
    while (a_cache) {
        const int av = apal[ai];
        if (!n_cache || cache[n_cache - 1] != av)
            cache[n_cache++] = (uint16_t)av;
        ai++;
        a_cache--;
    }
    int n_used = 0;
    for (int i = 0; i < n_cache && n_used < pal_sz; i++)
        if (dtpu_decode_bool_equi(s))
            used_cache[n_used++] = cache[i];

    uint16_t *pal = t->scratch_pal[pl];
    if (n_used < pal_sz) {
        const int bpc = f->bitdepth;
        uint16_t newv[8];
        int i = n_used;
        int prev = newv[i] = (uint16_t)dtpu_decode_bools(s, bpc);
        i++;
        if (i < pal_sz) {
            int bits = bpc - 3 + (int)dtpu_decode_bools(s, 2);
            const int maxv = (1 << bpc) - 1;
            while (i < pal_sz) {
                const int delta = (int)dtpu_decode_bools(s, bits);
                prev = newv[i] =
                    (uint16_t)dmin_(prev + delta + !pl, maxv);
                i++;
                if (prev + !pl >= maxv) {
                    for (; i < pal_sz; i++)
                        newv[i] = (uint16_t)maxv;
                    break;
                }
                /* bits = min(bits, 1 + ulog2(maxv - prev - !pl)) */
                {
                    int r = maxv - prev - !pl, lg = 0;
                    while (r > 1) {
                        r >>= 1;
                        lg++;
                    }
                    bits = dmin_(bits, 1 + lg);
                }
            }
        }
        int n = 0, m = n_used;
        for (i = 0; i < pal_sz; i++) {
            if (n < n_used && (m >= pal_sz || used_cache[n] <= newv[m]))
                pal[i] = used_cache[n++];
            else
                pal[i] = newv[m++];
        }
    } else {
        for (int i = 0; i < n_used; i++)
            pal[i] = used_cache[i];
    }
}

static void read_pal_uv(DtpuFrameCtx *f, DtpuTileCtx *ts, DtpuTaskCtx *t,
                        Blk *b, int sz_ctx, int bx4, int by4)
{
    read_pal_plane(f, ts, t, b, 1, sz_ctx, bx4, by4);
    DtpuMsac *s = ts->msac;
    uint16_t *pal = t->scratch_pal[2];
    const int bpc = f->bitdepth;
    if (dtpu_decode_bool_equi(s)) {
        const int bits = bpc - 4 + (int)dtpu_decode_bools(s, 2);
        const int maxv = (1 << bpc) - 1;
        int prev = pal[0] = (uint16_t)dtpu_decode_bools(s, bpc);
        for (int i = 1; i < b->pal_sz[1]; i++) {
            int delta = (int)dtpu_decode_bools(s, bits);
            if (delta && dtpu_decode_bool_equi(s))
                delta = -delta;
            prev = pal[i] = (uint16_t)((prev + delta) & maxv);
        }
    } else {
        for (int i = 0; i < b->pal_sz[1]; i++)
            pal[i] = (uint16_t)dtpu_decode_bools(s, bpc);
    }
}

/* decode/tile.py _order_palette + _read_pal_indices; tmp is the unpacked
 * (bh4*4, bw4*4) index map in the pal arena. */
static void order_palette(const uint8_t *tmp, int stride, int i, int first,
                          int last, uint8_t order[64][8], uint8_t ctxs[64])
{
    int have_top = i > first;
    int n = 0;
    for (int j = first; j >= last; j--, have_top = 1, n++) {
        const int row = i - j, col = j;
        const int have_left = j > 0;
        unsigned mask = 0;
        uint8_t *o = order[n];
        int no = 0;
#define ADD(v_)                                                             \
        do {                                                                \
            const int v = (v_);                                             \
            o[no++] = (uint8_t)v;                                           \
            mask |= 1u << v;                                                \
        } while (0)
        if (!have_left) {
            ctxs[n] = 0;
            ADD(tmp[(row - 1) * stride + col]);
        } else if (!have_top) {
            ctxs[n] = 0;
            ADD(tmp[row * stride + col - 1]);
        } else {
            const int lv = tmp[row * stride + col - 1];
            const int tv = tmp[(row - 1) * stride + col];
            const int tlv = tmp[(row - 1) * stride + col - 1];
            const int same_t_l = tv == lv;
            const int same_t_tl = tv == tlv;
            const int same_l_tl = lv == tlv;
            if (same_t_l && same_t_tl && same_l_tl) {
                ctxs[n] = 4;
                ADD(tv);
            } else if (same_t_l) {
                ctxs[n] = 3;
                ADD(tv);
                ADD(tlv);
            } else if (same_t_tl || same_l_tl) {
                ctxs[n] = 2;
                ADD(tlv);
                ADD(same_t_tl ? lv : tv);
            } else {
                ctxs[n] = 1;
                ADD(dmin_(tv, lv));
                ADD(dmax_(tv, lv));
                ADD(tlv);
            }
        }
#undef ADD
        for (int bit = 0; bit < 8; bit++)
            if (!(mask & (1u << bit)))
                o[no++] = (uint8_t)bit;
    }
}

/* returns the arena offset of the unpacked (bh4*4, bw4*4) map */
static int64_t read_pal_indices(DtpuFrameCtx *f, DtpuTileCtx *ts,
                                DtpuTaskCtx *t, int pal_sz, int pl, int w4,
                                int h4, int bw4, int bh4)
{
    DtpuMsac *s = ts->msac;
    const int stride = bw4 * 4, rows = bh4 * 4;
    const int64_t off = f->pal_used;
    if (off + (int64_t)stride * rows > f->pal_arena_cap) {
        f->error = 1;
        return -1;
    }
    uint8_t *tmp = f->pal_arena + off;
    f->pal_used += (int64_t)stride * rows;
    memset(tmp, 0, (size_t)stride * rows);
    tmp[0] = (uint8_t)dtpu_decode_uniform(s, pal_sz);
    /* color_map cdf: (2, 7, 5, 8) */
    uint16_t *cdf = ts->color_map + ((pl * 7) + (pal_sz - 2)) * 5 * 8;
    static _Thread_local uint8_t order[64][8];
    static _Thread_local uint8_t ctxs[64];
    for (int i = 1; i < 4 * (w4 + h4) - 1; i++) {
        const int first = dmin_(i, w4 * 4 - 1);
        const int last = dmax_(0, i - h4 * 4 + 1);
        order_palette(tmp, stride, i, first, last, order, ctxs);
        int m = 0;
        for (int j = first; j >= last; j--, m++) {
            const int color_idx = dtpu_decode_symbol_adapt(
                s, cdf + ctxs[m] * 8, pal_sz - 1);
            tmp[(i - j) * stride + j] = order[m][color_idx];
        }
    }
    /* replicate the last coded column/row into the invisible edges */
    const int w_px = w4 * 4, h_px = h4 * 4;
    if (w_px < stride)
        for (int y = 0; y < h_px; y++)
            memset(tmp + y * stride + w_px, tmp[y * stride + w_px - 1],
                   stride - w_px);
    if (h_px < rows)
        for (int y = h_px; y < rows; y++)
            memcpy(tmp + y * stride, tmp + (h_px - 1) * stride, stride);
    return off;
}

/* ---- warped-motion math (warpmv.py; reference src/warpmv.c) ------------- */

static const uint16_t div_lut[257] = {
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
    8289, 8273, 8257, 8240, 8224, 8208, 8192,
};

static inline int64_t wapply_sign(int64_t v, int64_t s)
{
    return s < 0 ? -v : v;
}

static inline int iclip_wmp(int64_t v)
{
    const int cv = (int)dclip_((int)v, -32768, 32767);
    const int av = cv < 0 ? -cv : cv;
    return (int)wapply_sign((av + 32) >> 6, cv) * 64;
}

static inline int ulog2_64(uint64_t v)
{
    int n = 0;
    while (v > 1) {
        v >>= 1;
        n++;
    }
    return n;
}

static void resolve_divisor(uint64_t d, int *out_div, int *out_shift)
{
    const int shift = ulog2_64(d);
    const uint64_t e = d - (1ull << shift);
    const int64_t fv = shift > 8
        ? (int64_t)((e + (1ull << (shift - 9))) >> (shift - 8))
        : (int64_t)(e << (8 - shift));
    *out_div = div_lut[fv];
    *out_shift = shift + 14;
}

/* returns nonzero when the shear params are invalid */
static int get_shear_params(CapWarp *wm)
{
    const int32_t *mat = wm->matrix;
    if (mat[2] <= 0)
        return 1;
    wm->abcd[0] = (int16_t)iclip_wmp(mat[2] - 0x10000);
    wm->abcd[1] = (int16_t)iclip_wmp(mat[3]);
    int idiv, shift;
    resolve_divisor((uint64_t)(mat[2] < 0 ? -mat[2] : mat[2]), &idiv,
                    &shift);
    const int64_t y = wapply_sign(idiv, mat[2]);
    const int64_t rnd = (1ll << shift) >> 1;
    const int64_t v1 = ((int64_t)mat[4] * 0x10000) * y;
    wm->abcd[2] = (int16_t)iclip_wmp(
        wapply_sign(((v1 < 0 ? -v1 : v1) + rnd) >> shift, v1));
    const int64_t v2 = ((int64_t)mat[3] * mat[4]) * y;
    wm->abcd[3] = (int16_t)iclip_wmp(
        mat[5] - wapply_sign(((v2 < 0 ? -v2 : v2) + rnd) >> shift, v2)
        - 0x10000);
    return (4 * (wm->abcd[0] < 0 ? -wm->abcd[0] : wm->abcd[0])
            + 7 * (wm->abcd[1] < 0 ? -wm->abcd[1] : wm->abcd[1]) >= 0x10000)
        || (4 * (wm->abcd[2] < 0 ? -wm->abcd[2] : wm->abcd[2])
            + 4 * (wm->abcd[3] < 0 ? -wm->abcd[3] : wm->abcd[3]) >= 0x10000);
}

static int64_t get_mult_shift_ndiag(int64_t px, int64_t idet, int shift)
{
    const int64_t v1 = px * idet;
    const int64_t v2 =
        wapply_sign(((v1 < 0 ? -v1 : v1) + ((1ll << shift) >> 1)) >> shift,
                    v1);
    return dclip_((int)v2, -0x1FFF, 0x1FFF);
}

static int64_t get_mult_shift_diag(int64_t px, int64_t idet, int shift)
{
    const int64_t v1 = px * idet;
    const int64_t v2 =
        wapply_sign(((v1 < 0 ? -v1 : v1) + ((1ll << shift) >> 1)) >> shift,
                    v1);
    return v2 < 0xE001 ? 0xE001 : v2 > 0x11FFF ? 0x11FFF : v2;
}

/* pts: [np][2 src/dst][2 x/y] */
static int find_affine_int(int pts[8][2][2], int np, int bw4, int bh4,
                           int mvy, int mvx, CapWarp *wm, int bx4, int by4)
{
    int32_t *mat = wm->matrix;
    int64_t a00 = 0, a01 = 0, a11 = 0;
    int64_t bx0 = 0, bx1 = 0, by0 = 0, by1 = 0;
    const int rsuy = 2 * bh4 - 1, rsux = 2 * bw4 - 1;
    const int suy = rsuy * 8, sux = rsux * 8;
    const int duy = suy + mvy, dux = sux + mvx;
    const int isuy = by4 * 4 + rsuy, isux = bx4 * 4 + rsux;

    for (int i = 0; i < np; i++) {
        const int dx = pts[i][1][0] - dux;
        const int dy = pts[i][1][1] - duy;
        const int sx = pts[i][0][0] - sux;
        const int sy = pts[i][0][1] - suy;
        const int adx = sx - dx < 0 ? dx - sx : sx - dx;
        const int ady = sy - dy < 0 ? dy - sy : sy - dy;
        if (adx < 256 && ady < 256) {
            a00 += ((sx * sx) >> 2) + sx * 2 + 8;
            a01 += ((sx * sy) >> 2) + sx + sy + 4;
            a11 += ((sy * sy) >> 2) + sy * 2 + 8;
            bx0 += ((sx * dx) >> 2) + sx + dx + 8;
            bx1 += ((sy * dx) >> 2) + sy + dx + 4;
            by0 += ((sx * dy) >> 2) + sx + dy + 4;
            by1 += ((sy * dy) >> 2) + sy + dy + 8;
        }
    }

    const int64_t det = a00 * a11 - a01 * a01;
    if (det == 0)
        return 1;
    int idiv, shift;
    resolve_divisor((uint64_t)(det < 0 ? -det : det), &idiv, &shift);
    int64_t idet = wapply_sign(idiv, det);
    shift -= 16;
    if (shift < 0) {
        idet <<= -shift;
        shift = 0;
    }

    mat[2] = (int32_t)get_mult_shift_diag(a11 * bx0 - a01 * bx1, idet,
                                          shift);
    mat[3] = (int32_t)get_mult_shift_ndiag(a00 * bx1 - a01 * bx0, idet,
                                           shift);
    mat[4] = (int32_t)get_mult_shift_ndiag(a11 * by0 - a01 * by1, idet,
                                           shift);
    mat[5] = (int32_t)get_mult_shift_diag(a00 * by1 - a01 * by0, idet,
                                          shift);
    mat[0] = dclip_(mvx * 0x2000
                    - (isux * (mat[2] - 0x10000) + isuy * mat[3]),
                    -0x800000, 0x7FFFFF);
    mat[1] = dclip_(mvy * 0x2000
                    - (isux * mat[4] + isuy * (mat[5] - 0x10000)),
                    -0x800000, 0x7FFFFF);
    return 0;
}

/* ---- capture emission --------------------------------------------------- */

static int64_t cap_cf_alloc(DtpuFrameCtx *f, int n)
{
    if (f->cf_used + n > f->cf_arena_cap) {
        f->error = 1;
        return -1;
    }
    const int64_t off = f->cf_used;
    f->cf_used += n;
    return off;
}

static void emit_coef(DtpuFrameCtx *f, int eob, int txtp, int pl, int tx,
                      int dst_y, int dst_x, int64_t cf_off)
{
    if (f->n_coef_meta >= f->cap_coef_cap) {
        f->error = 1;
        return;
    }
    int32_t *m = f->cap_coef_meta + f->n_coef_meta * CAP_COEF_WORDS;
    m[0] = eob;
    m[1] = txtp;
    m[2] = pl | (tx << 8);
    m[3] = dst_y;
    m[4] = dst_x;
    m[5] = (int32_t)cf_off;
    f->n_coef_meta++;
}

static inline int n_coef_of(const DtpuFrameCtx *f, int tx)
{
    const uint8_t *ti = f->txfm_info + 8 * tx;
    return (4 << dmin_(ti[2], 3)) * (4 << dmin_(ti[3], 3));
}

/* one decode_coefs call captured into the arenas; returns the coef-ctx
 * byte (res & 0xFFFF) and stores txtp via *out_txtp */
static int cap_coefs(DtpuFrameCtx *f, DtpuTileCtx *ts, const Blk *b,
                     uint8_t *a, int a_off, uint8_t *l, int l_off, int tx,
                     int intra, int plane, int ymn, int ytxtp, int dst_y,
                     int dst_x, int *out_txtp)
{
    const int nc = n_coef_of(f, tx);
    int64_t cf_off = cap_cf_alloc(f, nc);
    if (cf_off < 0)
        return 0x40;
    const DtpuSegData *sd = &f->seg_d[b->seg_id];
    int eob = 0;
    const int ret = dtpu_decode_coefs(
        ts->coef, ts->msac, a, a_off, l, l_off, tx, b->bs, intra, plane,
        ymn, b->uv_mode, ytxtp, sd->lossless, sd->qidx != 0,
        f->reduced_txtp_set, ts->dq[b->seg_id][plane][0],
        ts->dq[b->seg_id][plane][1],
        f->qm_tbl[tx][plane], f->cf_arena + cf_off, &eob);
    const int txtp = ret >> 16;
    if (eob < 0) {
        f->cf_used -= nc; /* all-skip: return the slot */
        cf_off = -1;
    }
    emit_coef(f, eob, txtp, plane, tx, dst_y, dst_x, cf_off);
    *out_txtp = txtp;
    return ret & 0xFFFF;
}

/* y_mode with FILTER_PRED resolved (decode_coefs ymn input) */
static inline int ymode_nofilt(const DtpuFrameCtx *f, const Blk *b)
{
    return (b->y_mode == M_FILTER_PRED && b->intra)
        ? f->filter_mode_to_y[b->y_angle] : b->y_mode;
}

/* ---- intra pass-1 coefficient walk (recon/intra.py recon_b_intra) ------ */

static void intra_coef_walk(DtpuFrameCtx *f, DtpuTileCtx *ts, DtpuTaskCtx *t,
                            Blk *b, int bx4, int by4, int w4, int h4,
                            int has_chroma)
{
    const int ss_ver = f->ss_ver, ss_hor = f->ss_hor;
    const int cbx4 = bx4 >> ss_hor, cby4 = by4 >> ss_ver;
    const int cw4 = (w4 + ss_hor) >> ss_hor;
    const int ch4 = (h4 + ss_ver) >> ss_ver;
    const uint8_t *ti = f->txfm_info;
    const int tw = ti[8 * b->tx], th = ti[8 * b->tx + 1];
    const int utw = ti[8 * b->uvtx], uth = ti[8 * b->uvtx + 1];
    const int ymn = b->intra ? ymode_nofilt(f, b) : 0;
    BlockCtx *a = t->a, *l = t->l;
    int txtp;

    for (int init_y = 0; init_y < h4; init_y += 16) {
        const int sub_h4 = dmin_(h4, 16 + init_y);
        const int sub_ch4 = dmin_(ch4, (init_y + 16) >> ss_ver);
        for (int init_x = 0; init_x < w4; init_x += 16) {
            const int sub_w4 = dmin_(w4, init_x + 16);
            const int sub_cw4 = dmin_(cw4, (init_x + 16) >> ss_hor);

            for (int y = init_y; y < sub_h4; y += th)
                for (int x = init_x; x < sub_w4; x += tw) {
                    if (b->skip) {
                        memset(a->lcoef + bx4 + x, 0x40, tw);
                        memset(l->lcoef + by4 + y, 0x40, th);
                        continue;
                    }
                    const int ctx = cap_coefs(
                        f, ts, b, a->lcoef, bx4 + x, l->lcoef, by4 + y,
                        b->tx, 1, 0, ymn, 0, 4 * (t->by + y),
                        4 * (t->bx + x), &txtp);
                    memset(a->lcoef + bx4 + x, ctx,
                           dmin_(tw, f->bw - (t->bx + x)));
                    memset(l->lcoef + by4 + y, ctx,
                           dmin_(th, f->bh - (t->by + y)));
                }

            if (!has_chroma)
                continue;
            const int icx = init_x >> ss_hor, icy = init_y >> ss_ver;
            for (int pl = 0; pl < 2; pl++) {
                uint8_t *ac = a->ccoef[pl], *lc = l->ccoef[pl];
                for (int y = icy; y < sub_ch4; y += uth)
                    for (int x = icx; x < sub_cw4; x += utw) {
                        if (b->skip) {
                            memset(ac + cbx4 + x, 0x40, utw);
                            memset(lc + cby4 + y, 0x40, uth);
                            continue;
                        }
                        const int ctx = cap_coefs(
                            f, ts, b, ac, cbx4 + x, lc, cby4 + y, b->uvtx,
                            1, 1 + pl, ymn, 0,
                            4 * (((t->by & ~ss_ver) >> ss_ver) + y),
                            4 * (((t->bx & ~ss_hor) >> ss_hor) + x), &txtp);
                        memset(ac + cbx4 + x, ctx,
                               dmin_(utw,
                                     (f->bw - (t->bx + (x << ss_hor))
                                      + ss_hor) >> ss_hor));
                        memset(lc + cby4 + y, ctx,
                               dmin_(uth,
                                     (f->bh - (t->by + (y << ss_ver))
                                      + ss_ver) >> ss_ver));
                    }
            }
        }
    }
}

/* ---- inter pass-1 coefficient walk (recon/inter.py read_coef_tree) ----- */

static void read_coef_tree_c(DtpuFrameCtx *f, DtpuTileCtx *ts,
                             DtpuTaskCtx *t, Blk *b, int ytx, int depth,
                             int x_off, int y_off)
{
    const uint8_t *ti = f->txfm_info + 8 * ytx;
    const int txw = ti[0], txh = ti[1];

    const uint32_t split = depth ? b->tx_split1 : b->tx_split0;
    if (depth < 2 && split && (split & (1u << (y_off * 4 + x_off)))) {
        const int sub = ti[6];
        const uint8_t *st = f->txfm_info + 8 * sub;
        const int txsw = st[0], txsh = st[1];
        read_coef_tree_c(f, ts, t, b, sub, depth + 1, x_off * 2, y_off * 2);
        t->bx += txsw;
        if (txw >= txh && t->bx < f->bw)
            read_coef_tree_c(f, ts, t, b, sub, depth + 1, x_off * 2 + 1,
                             y_off * 2);
        t->bx -= txsw;
        t->by += txsh;
        if (txh >= txw && t->by < f->bh) {
            read_coef_tree_c(f, ts, t, b, sub, depth + 1, x_off * 2,
                             y_off * 2 + 1);
            t->bx += txsw;
            if (txw >= txh && t->bx < f->bw)
                read_coef_tree_c(f, ts, t, b, sub, depth + 1, x_off * 2 + 1,
                                 y_off * 2 + 1);
            t->bx -= txsw;
        }
        t->by -= txsh;
    } else {
        const int bx4 = t->bx & 31, by4 = t->by & 31;
        int txtp;
        const int ctx = cap_coefs(f, ts, b, t->a->lcoef, bx4, t->l->lcoef,
                                  by4, ytx, 0, 0, 0, 0,
                                  4 * t->by, 4 * t->bx, &txtp);
        memset(t->a->lcoef + bx4, ctx, dmin_(txw, f->bw - t->bx));
        memset(t->l->lcoef + by4, ctx, dmin_(txh, f->bh - t->by));
        for (int y = 0; y < txh; y++)
            memset(&t->txtp_map[by4 + y][bx4], txtp, txw);
    }
}

static void inter_coef_walk(DtpuFrameCtx *f, DtpuTileCtx *ts, DtpuTaskCtx *t,
                            Blk *b, int bx4, int by4, int bw4, int bh4,
                            int w4, int h4, int has_chroma)
{
    const int ss_ver = f->ss_ver, ss_hor = f->ss_hor;
    const int cbx4 = bx4 >> ss_hor, cby4 = by4 >> ss_ver;
    const int cbw4 = (bw4 + ss_hor) >> ss_hor;
    const int cbh4 = (bh4 + ss_ver) >> ss_ver;
    const int cw4 = (w4 + ss_hor) >> ss_hor;
    const int ch4 = (h4 + ss_ver) >> ss_ver;
    BlockCtx *a = t->a, *l = t->l;

    if (b->skip) {
        memset(a->lcoef + bx4, 0x40, bw4);
        memset(l->lcoef + by4, 0x40, bh4);
        if (has_chroma)
            for (int pl = 0; pl < 2; pl++) {
                memset(a->ccoef[pl] + cbx4, 0x40, cbw4);
                memset(l->ccoef[pl] + cby4, 0x40, cbh4);
            }
        return;
    }

    const uint8_t *yti = f->txfm_info + 8 * b->max_ytx;
    const uint8_t *uti = f->txfm_info + 8 * b->uvtx;
    const int ytw = yti[0], yth = yti[1];
    const int utw = uti[0], uth = uti[1];
    int txtp;

    for (int init_y = 0; init_y < bh4; init_y += 16) {
        for (int init_x = 0; init_x < bw4; init_x += 16) {
            int y_off = init_y ? 1 : 0;
            int y = init_y;
            t->by += init_y;
            while (y < dmin_(h4, init_y + 16)) {
                int x = init_x;
                int x_off = init_x ? 1 : 0;
                t->bx += init_x;
                while (x < dmin_(w4, init_x + 16)) {
                    read_coef_tree_c(f, ts, t, b, b->max_ytx, 0, x_off,
                                     y_off);
                    t->bx += ytw;
                    x += ytw;
                    x_off++;
                }
                t->bx -= x;
                t->by += yth;
                y += yth;
                y_off++;
            }
            t->by -= y;

            if (!has_chroma)
                continue;
            const int ch_end = dmin_(ch4, (init_y + 16) >> ss_ver);
            const int cw_end = dmin_(cw4, (init_x + 16) >> ss_hor);
            for (int pl = 0; pl < 2; pl++)
                for (int y2 = init_y >> ss_ver; y2 < ch_end; y2 += uth)
                    for (int x2 = init_x >> ss_hor; x2 < cw_end;
                         x2 += utw) {
                        /* chroma tx position in luma 4x4 units */
                        const int lx = t->bx + (x2 << ss_hor);
                        const int ly = t->by + (y2 << ss_ver);
                        const int ytxtp =
                            t->txtp_map[by4 + (y2 << ss_ver)]
                                       [bx4 + (x2 << ss_hor)];
                        const int ctx = cap_coefs(
                            f, ts, b, a->ccoef[pl], cbx4 + x2,
                            l->ccoef[pl], cby4 + y2, b->uvtx, 0, 1 + pl,
                            0, ytxtp,
                            4 * ((t->by >> ss_ver) + y2),
                            4 * ((t->bx >> ss_hor) + x2), &txtp);
                        memset(a->ccoef[pl] + cbx4 + x2, ctx,
                               dmin_(utw, (f->bw - lx + ss_hor) >> ss_hor));
                        memset(l->ccoef[pl] + cby4 + y2, ctx,
                               dmin_(uth, (f->bh - ly + ss_ver) >> ss_ver));
                    }
        }
    }
}

/* ---- lf masks + level cache (recon/lf.py create_lf_mask_*) -------------- */

static void lf_fill_levels(DtpuFrameCtx *f, int by, int bx, int h4, int w4,
                           int pd, uint8_t lvl)
{
    uint8_t *base = f->lf_level + ((int64_t)by * f->b4_stride + bx) * 4 + pd;
    for (int y = 0; y < h4; y++, base += (int64_t)f->b4_stride * 4)
        for (int x = 0; x < w4; x++)
            base[4 * x] = lvl;
}

static void create_lf_mask_c(DtpuFrameCtx *f, DtpuTaskCtx *t, const Blk *b,
                             const uint8_t lvl[4], int has_chroma,
                             int is_inter)
{
    const uint8_t *bd = f->block_dim + 4 * b->bs;
    const int bw4 = dmin_(f->w4 - t->bx, bd[0]);
    const int bh4 = dmin_(f->h4 - t->by, bd[1]);
    const int stride = f->b4_stride;
    uint8_t *wd_v = f->lf_mask_buf; /* lf_wd_y[0] */
    uint8_t *wd_h = wd_v + (int64_t)f->lf_wd_y_plane;

    if (bw4 && bh4) {
        lf_fill_levels(f, t->by, t->bx, bh4, bw4, 0, lvl[0]);
        lf_fill_levels(f, t->by, t->bx, bh4, bw4, 1, lvl[1]);
        if (is_inter) {
            const uint8_t *ti = f->txfm_info + 8 * b->max_ytx;
            int ytx_lf = b->max_ytx;
            if (f->seg_d[b->seg_id].lossless)
                ytx_lf = TX_4X4;
            (void)ti;
            dtpu_mask_edges_inter(
                wd_v, wd_h, stride, t->by, t->bx, bw4, bh4, b->skip,
                ytx_lf, b->tx_split0, b->tx_split1, f->txfm_info,
                t->a->tx_lpf_y + (t->bx & 31), t->l->tx_lpf_y + (t->by & 31));
        } else {
            const uint8_t *ti = f->txfm_info + 8 * b->tx;
            dtpu_mask_edges_intra(
                wd_v, wd_h, stride, t->by, t->bx, bw4, bh4,
                dmin_(2, ti[2]), dmin_(2, ti[3]), ti[0], ti[1],
                t->a->tx_lpf_y + (t->bx & 31), t->l->tx_lpf_y + (t->by & 31));
        }
    }

    if (!has_chroma)
        return;
    const int ss_ver = f->ss_ver, ss_hor = f->ss_hor;
    const int cbw4 = dmin_(((f->w4 + ss_hor) >> ss_hor) - (t->bx >> ss_hor),
                           (bd[0] + ss_hor) >> ss_hor);
    const int cbh4 = dmin_(((f->h4 + ss_ver) >> ss_ver) - (t->by >> ss_ver),
                           (bd[1] + ss_ver) >> ss_ver);
    if (cbw4 <= 0 || cbh4 <= 0)
        return;
    const int cy = t->by >> ss_ver, cx = t->bx >> ss_hor;
    lf_fill_levels(f, cy, cx, cbh4, cbw4, 2, lvl[2]);
    lf_fill_levels(f, cy, cx, cbh4, cbw4, 3, lvl[3]);
    int uvtx_lf = b->uvtx;
    if (is_inter && f->seg_d[b->seg_id].lossless)
        uvtx_lf = TX_4X4;
    const uint8_t *uti = f->txfm_info + 8 * uvtx_lf;
    const int cstride = (stride + ss_hor) >> ss_hor;
    uint8_t *uv_v = f->lf_wd_uv;
    uint8_t *uv_h = uv_v + (int64_t)f->lf_wd_uv_plane;
    dtpu_mask_edges_chroma(
        uv_v, uv_h, cstride, cy, cx, cbw4, cbh4, is_inter ? b->skip : 0,
        uti[2] ? 1 : 0, uti[3] ? 1 : 0, uti[0], uti[1],
        t->a->tx_lpf_uv + ((t->bx & 31) >> ss_hor),
        t->l->tx_lpf_uv + ((t->by & 31) >> ss_ver));
}

/* ---- capture-record emission -------------------------------------------- */

static CapBlock *cap_block_begin(DtpuFrameCtx *f, DtpuTaskCtx *t,
                                 const Blk *b, int kind, int edge_flags)
{
    if (f->n_blocks >= f->cap_blocks_cap) {
        f->error = 1;
        return NULL;
    }
    CapBlock *c = &f->cap_blocks[f->n_blocks++];
    memset(c, 0, sizeof(*c));
    c->bx = (uint16_t)t->bx;
    c->by = (uint16_t)t->by;
    c->bs = U8(b->bs);
    c->bl = U8(b->bl);
    c->bp = U8(b->bp);
    c->kind = U8(kind);
    c->skip = U8(b->skip);
    c->skip_mode = U8(b->skip_mode);
    c->seg_id = U8(b->seg_id);
    c->edge_flags = U8(edge_flags);
    c->y_mode = U8(b->y_mode);
    c->uv_mode = U8(b->uv_mode);
    c->tx = U8(b->tx);
    c->uvtx = U8(b->uvtx);
    c->y_angle = (int8_t)b->y_angle;
    c->uv_angle = (int8_t)b->uv_angle;
    c->cfl_alpha[0] = (int8_t)b->cfl_alpha[0];
    c->cfl_alpha[1] = (int8_t)b->cfl_alpha[1];
    c->pal_sz[0] = U8(b->pal_sz[0]);
    c->pal_sz[1] = U8(b->pal_sz[1]);
    c->filter2d = U8(b->filter2d);
    c->max_ytx = U8(b->max_ytx);
    c->comp_type = U8(b->comp_type);
    c->inter_mode = U8(b->inter_mode);
    c->motion_mode = U8(b->motion_mode);
    c->drl_idx = U8(b->drl_idx);
    c->interintra_type = U8(b->interintra_type);
    c->interintra_mode = U8(b->interintra_mode);
    c->wedge_idx = U8(b->wedge_idx);
    c->mask_sign = U8(b->mask_sign);
    c->tx_split0 = U8(b->tx_split0);
    c->pad0 = U8(b->ref[0] + 1); /* refs, biased +1 */
    c->pad1 = U8(b->ref[1] + 1);
    c->tx_split1 = (uint16_t)b->tx_split1;
    c->mv[0][0] = (int16_t)b->mv[0][0];
    c->mv[0][1] = (int16_t)b->mv[0][1];
    c->mv[1][0] = (int16_t)b->mv[1][0];
    c->mv[1][1] = (int16_t)b->mv[1][1];
    c->warp_idx = -1;
    c->obmc_start = c->obmc_count = 0;
    c->sub8x8 = -1;
    c->coef_start = (int32_t)f->n_coef_meta;
    c->pal_idx = -1;
    c->pal_y_off = -1;
    c->pal_uv_off = -1;
    return c;
}

/* ---- refmvs glue --------------------------------------------------------- */

static void fix_mv_precision_f(const DtpuFrameCtx *f, int *y, int *x)
{
    if (f->force_integer_mv) {
        *x = (int16_t)((*x - (*x >> 15) + 3) & ~7);
        *y = (int16_t)((*y - (*y >> 15) + 3) & ~7);
    } else if (!f->hp) {
        *x = (int16_t)((*x - (*x >> 15)) & ~1);
        *y = (int16_t)((*y - (*y >> 15)) & ~1);
    }
}

static int refmvs_find_c(DtpuFrameCtx *f, DtpuTileCtx *ts, DtpuTaskCtx *t,
                         int ref0, int ref1, int bs, int edge_flags,
                         DtpuMvCand *stack, int *ctx)
{
    return dtpu_refmvs_find(f->rf, ts->col_start, ts->col_end,
                            ts->row_start, ts->row_end, ref0, ref1, bs,
                            edge_flags, t->by, t->bx, f->block_dim, stack,
                            ctx);
}

/* ---- shared post-parse state updates ------------------------------------ */

static void update_segmap_noskip(DtpuFrameCtx *f, DtpuTaskCtx *t,
                                 const Blk *b, int bw4, int bh4)
{
    if (!b->skip) {
        /* per-8x8-row "has coefficients" mask for cdef */
        const int r0 = t->by >> 1;
        const int nr = (bh4 + 1) >> 1;
        for (int y = 0; y < nr; y++)
            memset(f->noskip + (int64_t)(r0 + y) * f->noskip_stride + t->bx,
                   1, bw4);
    }
    if (f->seg_enabled && f->seg_update_map) {
        for (int y = 0; y < bh4; y++)
            memset(f->cur_segmap
                       + (int64_t)(t->by + y) * f->cur_segmap_stride + t->bx,
                   b->seg_id, bw4);
    }
}

/* ---- decode_b: intra path (tile.py _decode_b_intra) --------------------- */

static void decode_b_intra(DtpuFrameCtx *f, DtpuTileCtx *ts, DtpuTaskCtx *t,
                           Blk *b, int edge_flags, const uint8_t *bd,
                           int bx4, int by4, int cbx4, int cby4, int bw4,
                           int bh4, int w4, int h4, int cbw4, int cbh4,
                           int have_top, int have_left, int has_chroma,
                           int seg_pred)
{
    DtpuMsac *s = ts->msac;
    BlockCtx *a = t->a, *l = t->l;
    const int frame_is_inter = f->frame_is_inter;

    uint16_t *ymode_cdf;
    if (frame_is_inter)
        ymode_cdf = ts->y_mode + 16 * f->ymode_size_ctx[b->bs];
    else
        ymode_cdf = ts->kfym
            + (f->intra_mode_ctx[a->mode[bx4]] * 5
               + f->intra_mode_ctx[l->mode[by4]]) * 16;
    b->y_mode = dtpu_decode_symbol_adapt(s, ymode_cdf, 12);

    if (bd[2] + bd[3] >= 2 && b->y_mode >= M_VERT_PRED
        && b->y_mode <= M_VERT_LEFT_PRED) {
        uint16_t *acdf = ts->angle_delta + 8 * (b->y_mode - M_VERT_PRED);
        b->y_angle = dtpu_decode_symbol_adapt(s, acdf, 6) - 3;
    } else {
        b->y_angle = 0;
    }

    if (has_chroma) {
        const int cfl_allowed = f->seg_d[b->seg_id].lossless
            ? (cbw4 == 1 && cbh4 == 1)
            : !!(f->cfl_allowed_mask & (1u << b->bs));
        uint16_t *uvmode_cdf =
            ts->uv_mode + (cfl_allowed * 13 + b->y_mode) * 16;
        b->uv_mode =
            dtpu_decode_symbol_adapt(s, uvmode_cdf, 13 - !cfl_allowed);
        b->uv_angle = 0;
        if (b->uv_mode == M_CFL_PRED) {
            const int sign = dtpu_decode_symbol_adapt(s, ts->cfl_sign, 7)
                             + 1;
            const int sign_u = sign * 0x56 >> 8;
            const int sign_v = sign - sign_u * 3;
            if (sign_u) {
                const int ctx = (sign_u == 2) * 3 + sign_v;
                b->cfl_alpha[0] = dtpu_decode_symbol_adapt(
                    s, ts->cfl_alpha + 16 * ctx, 15) + 1;
                if (sign_u == 1)
                    b->cfl_alpha[0] = -b->cfl_alpha[0];
            } else {
                b->cfl_alpha[0] = 0;
            }
            if (sign_v) {
                const int ctx = (sign_v == 2) * 3 + sign_u;
                b->cfl_alpha[1] = dtpu_decode_symbol_adapt(
                    s, ts->cfl_alpha + 16 * ctx, 15) + 1;
                if (sign_v == 1)
                    b->cfl_alpha[1] = -b->cfl_alpha[1];
            } else {
                b->cfl_alpha[1] = 0;
            }
        } else if (bd[2] + bd[3] >= 2 && b->uv_mode >= M_VERT_PRED
                   && b->uv_mode <= M_VERT_LEFT_PRED) {
            uint16_t *acdf =
                ts->angle_delta + 8 * (b->uv_mode - M_VERT_PRED);
            b->uv_angle = dtpu_decode_symbol_adapt(s, acdf, 6) - 3;
        }
    }

    b->pal_sz[0] = b->pal_sz[1] = 0;
    if (f->allow_screen_content_tools && dmax_(bw4, bh4) <= 16
        && bw4 + bh4 >= 4) {
        const int sz_ctx = bd[2] + bd[3] - 2;
        if (b->y_mode == M_DC_PRED) {
            const int pal_ctx = (a->pal_sz[bx4] > 0) + (l->pal_sz[by4] > 0);
            if (dtpu_decode_bool_adapt(
                    s, ts->pal_y + (sz_ctx * 3 + pal_ctx) * 2))
                read_pal_plane(f, ts, t, b, 0, sz_ctx, bx4, by4);
        }
        if (has_chroma && b->uv_mode == M_DC_PRED) {
            const int pal_ctx = b->pal_sz[0] > 0;
            if (dtpu_decode_bool_adapt(s, ts->pal_uv + pal_ctx * 2))
                read_pal_uv(f, ts, t, b, sz_ctx, bx4, by4);
        }
    }

    if (b->y_mode == M_DC_PRED && !b->pal_sz[0]
        && dmax_(bd[2], bd[3]) <= 3 && f->seq_filter_intra) {
        if (dtpu_decode_bool_adapt(s, ts->use_filter_intra + 2 * b->bs)) {
            b->y_mode = M_FILTER_PRED;
            b->y_angle = dtpu_decode_symbol_adapt(s, ts->filter_intra, 4);
        }
    }

    t->pal_y_off = t->pal_uv_off = -1;
    if (b->pal_sz[0])
        t->pal_y_off = read_pal_indices(f, ts, t, b->pal_sz[0], 0, w4, h4,
                                        bw4, bh4);
    if (has_chroma && b->pal_sz[1]) {
        const int ss_ver = f->ss_ver, ss_hor = f->ss_hor;
        const int cw4 = (w4 + ss_hor) >> ss_hor;
        const int ch4 = (h4 + ss_ver) >> ss_ver;
        t->pal_uv_off = read_pal_indices(f, ts, t, b->pal_sz[1], 1, cw4,
                                         ch4, cbw4, cbh4);
    }

    /* tx size */
    const uint8_t *t_dim;
    if (f->seg_d[b->seg_id].lossless) {
        b->tx = b->uvtx = TX_4X4;
        t_dim = f->txfm_info + 8 * TX_4X4;
    } else {
        b->tx = f->max_tx_for_bs[4 * b->bs];
        b->uvtx = f->max_tx_for_bs[4 * b->bs + f->layout];
        t_dim = f->txfm_info + 8 * b->tx;
        if (f->txfm_mode == TXFM_MODE_SWITCHABLE && t_dim[5] > TX_4X4) {
            const int tctx = get_tx_ctx(a, l, t_dim[2], t_dim[3], by4, bx4);
            uint16_t *tx_cdf = ts->txsz + ((t_dim[5] - 1) * 3 + tctx) * 4;
            int depth =
                dtpu_decode_symbol_adapt(s, tx_cdf, dmin_(t_dim[5], 2));
            while (depth--) {
                b->tx = t_dim[6];
                t_dim = f->txfm_info + 8 * b->tx;
            }
        }
    }

    /* capture + pass-1 coefficient walk */
    CapBlock *c = cap_block_begin(f, t, b, 0, edge_flags);
    if (!c)
        return;
    /* neighbour smoothness flags (recon/intra.py _sm_flag) */
    int sm = 0;
    if (a->intra[bx4] && (a->mode[bx4] >= 9 && a->mode[bx4] <= 11))
        sm |= 1;
    if (l->intra[by4] && (l->mode[by4] >= 9 && l->mode[by4] <= 11))
        sm |= 1;
    int sm_uv = 0;
    if (has_chroma) {
        if (a->uvmode[cbx4] >= 9 && a->uvmode[cbx4] <= 11)
            sm_uv |= 1;
        if (l->uvmode[cby4] >= 9 && l->uvmode[cby4] <= 11)
            sm_uv |= 1;
    }
    c->sm_flags = U8(sm | (sm_uv << 1));
    if (b->pal_sz[0] || b->pal_sz[1]) {
        if (f->n_pal >= f->cap_pal_cap) {
            f->error = 1;
            return;
        }
        c->pal_idx = (int32_t)f->n_pal;
        memcpy(f->cap_pal + f->n_pal * 24, t->scratch_pal,
               3 * 8 * sizeof(uint16_t));
        f->n_pal++;
        c->pal_y_off = (int32_t)t->pal_y_off;
        c->pal_uv_off = (int32_t)t->pal_uv_off;
    }
    intra_coef_walk(f, ts, t, b, bx4, by4, w4, h4, has_chroma);
    c->coef_count = (int32_t)f->n_coef_meta - c->coef_start;

    if (f->loopfilter_any) {
        const uint8_t lvl[4] = {
            ts->lflvl[b->seg_id][0][0][0], ts->lflvl[b->seg_id][1][0][0],
            ts->lflvl[b->seg_id][2][0][0], ts->lflvl[b->seg_id][3][0][0],
        };
        create_lf_mask_c(f, t, b, lvl, has_chroma, 0);
    }

    /* context updates (tile.py:740-788) */
    const int ymn = b->y_mode == M_FILTER_PRED ? M_DC_PRED : b->y_mode;
    const int lw = t_dim[2], lh = t_dim[3];
    memset(a->tx_intra + bx4, lw, bw4);
    memset(a->tx + bx4, lw, bw4);
    memset(a->mode + bx4, ymn, bw4);
    memset(a->pal_sz + bx4, b->pal_sz[0], bw4);
    memset(a->seg_pred + bx4, seg_pred, bw4);
    memset(a->skip_mode + bx4, 0, bw4);
    memset(a->intra + bx4, 1, bw4);
    memset(a->skip + bx4, b->skip, bw4);
    memset(l->tx_intra + by4, lh, bh4);
    memset(l->tx + by4, lh, bh4);
    memset(l->mode + by4, ymn, bh4);
    memset(l->pal_sz + by4, b->pal_sz[0], bh4);
    memset(l->seg_pred + by4, seg_pred, bh4);
    memset(l->skip_mode + by4, 0, bh4);
    memset(l->intra + by4, 1, bh4);
    memset(l->skip + by4, b->skip, bh4);
    /* aomedia bug 2183: uv palette context uses luma coordinates */
    const int uv_pal = has_chroma ? b->pal_sz[1] : 0;
    memset(t->pal_sz_uv + bx4, uv_pal, bw4);
    memset(t->pal_sz_uv + 32 + by4, uv_pal, bh4);
    if (b->pal_sz[0])
        for (int i = 0; i < bw4 || i < bh4; i++) {
            if (i < bw4)
                memcpy(t->al_pal + ((0 * 32 + bx4 + i) * 3 + 0) * 8,
                       t->scratch_pal[0], 8 * sizeof(uint16_t));
            if (i < bh4)
                memcpy(t->al_pal + ((1 * 32 + by4 + i) * 3 + 0) * 8,
                       t->scratch_pal[0], 8 * sizeof(uint16_t));
        }
    if (has_chroma && b->pal_sz[1])
        for (int i = 0; i < bw4 || i < bh4; i++) {
            if (i < bw4)
                memcpy(t->al_pal + ((0 * 32 + bx4 + i) * 3 + 1) * 8,
                       t->scratch_pal[1], 2 * 8 * sizeof(uint16_t));
            if (i < bh4)
                memcpy(t->al_pal + ((1 * 32 + by4 + i) * 3 + 1) * 8,
                       t->scratch_pal[1], 2 * 8 * sizeof(uint16_t));
        }
    if (frame_is_inter) {
        memset(a->comp_type + bx4, 0, bw4);
        memset(a->ref[0] + bx4, 0xFF, bw4);
        memset(a->ref[1] + bx4, 0xFF, bw4);
        memset(a->filter[0] + bx4, 3, bw4);
        memset(a->filter[1] + bx4, 3, bw4);
        memset(l->comp_type + by4, 0, bh4);
        memset(l->ref[0] + by4, 0xFF, bh4);
        memset(l->ref[1] + by4, 0xFF, bh4);
        memset(l->filter[0] + by4, 3, bh4);
        memset(l->filter[1] + by4, 3, bh4);
    }
    if (has_chroma) {
        memset(a->uvmode + cbx4, b->uv_mode, cbw4);
        memset(l->uvmode + cby4, b->uv_mode, cbh4);
    }
    if ((frame_is_inter || f->allow_intrabc) && f->rf)
        dtpu_splat_mv(f->rf, t->by, t->bx, bw4, bh4, -32768, -32768, 0, 0,
                      0, -1, b->bs, 0);
    update_segmap_noskip(f, t, b, bw4, bh4);
}

/* ---- decode_b: intra block copy (tile.py _decode_b_intrabc) ------------- */

static void read_vartx_tree_c(DtpuFrameCtx *f, DtpuTileCtx *ts,
                              DtpuTaskCtx *t, Blk *b, int bx4, int by4);

static void decode_b_intrabc(DtpuFrameCtx *f, DtpuTileCtx *ts,
                             DtpuTaskCtx *t, Blk *b, int edge_flags,
                             const uint8_t *bd, int bx4, int by4, int cbx4,
                             int cby4, int bw4, int bh4, int w4, int h4,
                             int cbw4, int cbh4, int has_chroma,
                             int seg_pred)
{
    BlockCtx *a = t->a, *l = t->l;
    const int ss_ver = f->ss_ver, ss_hor = f->ss_hor;
    const int sb128 = f->sb128;

    DtpuMvCand stack[8];
    int ctx;
    refmvs_find_c(f, ts, t, 0, -1, b->bs, edge_flags, stack, &ctx);
    int mvy, mvx;
    if (stack[0].mv[0][0] || stack[0].mv[0][1]) {
        mvy = stack[0].mv[0][0];
        mvx = stack[0].mv[0][1];
    } else if (stack[1].mv[0][0] || stack[1].mv[0][1]) {
        mvy = stack[1].mv[0][0];
        mvx = stack[1].mv[0][1];
    } else if (t->by - (16 << sb128) < ts->row_start) {
        mvy = 0;
        mvx = -(512 << sb128) - 2048;
    } else {
        mvy = -(512 << sb128);
        mvx = 0;
    }
    read_mv_residual(ts, &mvy, &mvx, -1);

    /* clip to decoded parts of the current tile */
    int border_left = ts->col_start * 4;
    int border_top = ts->row_start * 4;
    if (has_chroma) {
        if (bw4 < 2 && ss_hor)
            border_left += 4;
        if (bh4 < 2 && ss_ver)
            border_top += 4;
    }
    int src_left = t->bx * 4 + (mvx >> 3);
    int src_top = t->by * 4 + (mvy >> 3);
    int src_right = src_left + bw4 * 4;
    int src_bottom = src_top + bh4 * 4;
    const int border_right = ((ts->col_end + (bw4 - 1)) & ~(bw4 - 1)) * 4;

    if (src_left < border_left) {
        src_right += border_left - src_left;
        src_left = border_left;
    } else if (src_right > border_right) {
        src_left -= src_right - border_right;
        src_right = border_right;
    }
    if (src_top < border_top) {
        src_bottom += border_top - src_top;
        src_top = border_top;
    }

    const int sbx = (t->bx >> (4 + sb128)) << (6 + sb128);
    const int sby_px = (t->by >> (4 + sb128)) << (6 + sb128);
    const int sb_size = 1 << (6 + sb128);
    if (src_bottom > sby_px && src_right > sbx) {
        if (src_top - border_top >= src_bottom - sby_px) {
            src_top -= src_bottom - sby_px;
            src_bottom = sby_px;
        } else if (src_left - border_left >= src_right - sbx) {
            src_left -= src_right - sbx;
            src_right = sbx;
        }
    }
    if (src_bottom > sby_px + sb_size) {
        src_top -= src_bottom - (sby_px + sb_size);
        src_bottom = sby_px + sb_size;
    }
    if (src_bottom > sby_px && src_right > sbx) {
        f->error = 2; /* intrabc mv overlaps current superblock */
        return;
    }

    b->mv[0][0] = (src_top - t->by * 4) * 8;
    b->mv[0][1] = (src_left - t->bx * 4) * 8;
    b->mv[1][0] = b->mv[1][1] = 0;
    b->comp_type = CT_NONE;
    b->motion_mode = MM_TRANSLATION;
    b->interintra_type = II_NONE;
    b->filter2d = 9; /* FILTER_2D_BILINEAR */
    b->ref[0] = b->ref[1] = -1;
    b->inter_mode = 0;
    b->drl_idx = 0;

    read_vartx_tree_c(f, ts, t, b, bx4, by4);

    CapBlock *c = cap_block_begin(f, t, b, 2, edge_flags);
    if (!c)
        return;
    inter_coef_walk(f, ts, t, b, bx4, by4, bw4, bh4, w4, h4, has_chroma);
    c->coef_count = (int32_t)f->n_coef_meta - c->coef_start;
    t->tl_4x4_filter = b->filter2d;

    dtpu_splat_mv(f->rf, t->by, t->bx, bw4, bh4, b->mv[0][0], b->mv[0][1],
                  0, 0, 0, -1, b->bs, 0);

    memset(a->tx_intra + bx4, bd[2], bw4);
    memset(a->mode + bx4, M_DC_PRED, bw4);
    memset(a->pal_sz + bx4, 0, bw4);
    memset(a->seg_pred + bx4, seg_pred, bw4);
    memset(a->skip_mode + bx4, 0, bw4);
    memset(a->intra + bx4, 0, bw4);
    memset(a->skip + bx4, b->skip, bw4);
    memset(l->tx_intra + by4, bd[3], bh4);
    memset(l->mode + by4, M_DC_PRED, bh4);
    memset(l->pal_sz + by4, 0, bh4);
    memset(l->seg_pred + by4, seg_pred, bh4);
    memset(l->skip_mode + by4, 0, bh4);
    memset(l->intra + by4, 0, bh4);
    memset(l->skip + by4, b->skip, bh4);
    memset(t->pal_sz_uv + bx4, 0, bw4);
    memset(t->pal_sz_uv + 32 + by4, 0, bh4);
    if (has_chroma) {
        memset(a->uvmode + cbx4, M_DC_PRED, cbw4);
        memset(l->uvmode + cby4, M_DC_PRED, cbh4);
    }
    /* no lf masks: allow_intrabc implies all in-loop filters disabled */
    if (f->seg_enabled && f->seg_update_map)
        for (int y = 0; y < bh4; y++)
            memset(f->cur_segmap
                       + (int64_t)(t->by + y) * f->cur_segmap_stride + t->bx,
                   b->seg_id, bw4);
    if (!b->skip) {
        const int r0 = t->by >> 1;
        const int nr = (bh4 + 1) >> 1;
        for (int y = 0; y < nr; y++)
            memset(f->noskip + (int64_t)(r0 + y) * f->noskip_stride + t->bx,
                   1, bw4);
    }
}

/* ---- var-tx tree (tile.py read_tx_tree / read_vartx_tree) --------------- */

static void read_tx_tree_c(DtpuFrameCtx *f, DtpuTileCtx *ts, DtpuTaskCtx *t,
                           int from_tx, int depth, uint32_t masks[2],
                           int x_off, int y_off)
{
    const int bx4 = t->bx & 31, by4 = t->by & 31;
    const uint8_t *ti = f->txfm_info + 8 * from_tx;
    const int txw = ti[2], txh = ti[3]; /* log2 */
    const int tw = ti[0], th = ti[1];
    int is_split = 0;
    if (depth < 2 && from_tx > TX_4X4) {
        const int cat = 2 * (TX_64X64 - ti[5]) - depth;
        const int a = (int8_t)t->a->tx[bx4] < txw;
        const int l = (int8_t)t->l->tx[by4] < txh;
        is_split = dtpu_decode_bool_adapt(
            ts->msac, ts->txpart + (cat * 3 + a + l) * 2);
        if (is_split)
            masks[depth] |= 1u << (y_off * 4 + x_off);
    }
    if (is_split && ti[5] > TX_8X8) {
        const int sub = ti[6];
        const uint8_t *st = f->txfm_info + 8 * sub;
        const int txsw = st[0], txsh = st[1];
        read_tx_tree_c(f, ts, t, sub, depth + 1, masks, x_off * 2,
                       y_off * 2);
        t->bx += txsw;
        if (tw >= th && t->bx < f->bw)
            read_tx_tree_c(f, ts, t, sub, depth + 1, masks, x_off * 2 + 1,
                           y_off * 2);
        t->bx -= txsw;
        t->by += txsh;
        if (th >= tw && t->by < f->bh) {
            read_tx_tree_c(f, ts, t, sub, depth + 1, masks, x_off * 2,
                           y_off * 2 + 1);
            t->bx += txsw;
            if (tw >= th && t->bx < f->bw)
                read_tx_tree_c(f, ts, t, sub, depth + 1, masks,
                               x_off * 2 + 1, y_off * 2 + 1);
            t->bx -= txsw;
        }
        t->by -= txsh;
    } else {
        memset(t->a->tx + bx4, is_split ? TX_4X4 : txw, tw);
        memset(t->l->tx + by4, is_split ? TX_4X4 : txh, th);
    }
}

static void read_vartx_tree_c(DtpuFrameCtx *f, DtpuTileCtx *ts,
                              DtpuTaskCtx *t, Blk *b, int bx4, int by4)
{
    const uint8_t *bd = f->block_dim + 4 * b->bs;
    const int bw4 = bd[0], bh4 = bd[1];
    uint32_t tx_split[2] = {0, 0};
    b->max_ytx = f->max_tx_for_bs[4 * b->bs];
    if (!b->skip
        && (f->seg_d[b->seg_id].lossless || b->max_ytx == TX_4X4)) {
        b->max_ytx = b->uvtx = TX_4X4;
        if (f->txfm_mode == TXFM_MODE_SWITCHABLE) {
            memset(t->a->tx + bx4, TX_4X4, bw4);
            memset(t->l->tx + by4, TX_4X4, bh4);
        }
    } else if (f->txfm_mode != TXFM_MODE_SWITCHABLE || b->skip) {
        if (f->txfm_mode == TXFM_MODE_SWITCHABLE) {
            memset(t->a->tx + bx4, bd[2], bw4);
            memset(t->l->tx + by4, bd[3], bh4);
        }
        b->uvtx = f->max_tx_for_bs[4 * b->bs + f->layout];
    } else {
        const uint8_t *yt = f->txfm_info + 8 * b->max_ytx;
        const int yw = yt[0], yh = yt[1];
        int y = 0, y_off = 0;
        while (y < bh4) {
            int x = 0, x_off = 0;
            while (x < bw4) {
                read_tx_tree_c(f, ts, t, b->max_ytx, 0, tx_split, x_off,
                               y_off);
                t->bx += yw;
                x += yw;
                x_off++;
            }
            t->bx -= x;
            t->by += yh;
            y += yh;
            y_off++;
        }
        t->by -= y;
        b->uvtx = f->max_tx_for_bs[4 * b->bs + f->layout];
    }
    b->tx_split0 = tx_split[0] & 0xFF;
    b->tx_split1 = tx_split[1];
}

/* ---- matching-ref masks + warp derivation (tile.py:1668-1828) ----------- */

static void find_matching_ref(const DtpuFrameCtx *f, const DtpuTileCtx *ts,
                              const DtpuTaskCtx *t, int edge_flags, int bw4,
                              int bh4, int w4, int h4, int have_left,
                              int have_top, int ref, uint64_t masks[2])
{
    const RefMvsBlock *r = f->rf->r;
    const int stride = f->rf->r_stride;
    masks[0] = masks[1] = 0;
    int count = 0;
    int have_topleft = have_top && have_left;
    int have_topright = dmax_(bw4, bh4) < 32 && have_top
        && t->bx + bw4 < ts->col_end && (edge_flags & EF_I444_TOP);

#define MATCHES(b_) ((b_)->ref[0] == ref + 1 && (b_)->ref[1] == -1)
    if (have_top) {
        const RefMvsBlock *row = r + (int64_t)(t->by - 1) * stride;
        const RefMvsBlock *b2 = &row[t->bx];
        if (MATCHES(b2)) {
            masks[0] |= 1;
            count = 1;
        }
        int aw4 = f->block_dim[4 * b2->bs];
        if (aw4 >= bw4) {
            const int off = t->bx & (aw4 - 1);
            if (off)
                have_topleft = 0;
            if (aw4 - off > bw4)
                have_topright = 0;
        } else {
            uint64_t mask = 1ull << aw4;
            for (int x = aw4; x < w4;) {
                b2 = &row[t->bx + x];
                if (MATCHES(b2)) {
                    masks[0] |= mask;
                    if (++count >= 8)
                        return;
                }
                aw4 = f->block_dim[4 * b2->bs];
                mask <<= aw4;
                x += aw4;
            }
        }
    }
    if (have_left) {
        const RefMvsBlock *b2 = &r[(int64_t)t->by * stride + t->bx - 1];
        if (MATCHES(b2)) {
            masks[1] |= 1;
            if (++count >= 8)
                return;
        }
        int lh4 = f->block_dim[4 * b2->bs + 1];
        if (lh4 >= bh4) {
            if (t->by & (lh4 - 1))
                have_topleft = 0;
        } else {
            uint64_t mask = 1ull << lh4;
            for (int y = lh4; y < h4;) {
                b2 = &r[(int64_t)(t->by + y) * stride + t->bx - 1];
                if (MATCHES(b2)) {
                    masks[1] |= mask;
                    if (++count >= 8)
                        return;
                }
                lh4 = f->block_dim[4 * b2->bs + 1];
                mask <<= lh4;
                y += lh4;
            }
        }
    }
    if (have_topleft
        && MATCHES(&r[(int64_t)(t->by - 1) * stride + t->bx - 1])) {
        masks[1] |= 1ull << 32;
        if (++count >= 8)
            return;
    }
    if (have_topright
        && MATCHES(&r[(int64_t)(t->by - 1) * stride + t->bx + bw4]))
        masks[0] |= 1ull << 32;
#undef MATCHES
}

static void derive_warpmv(const DtpuFrameCtx *f, const DtpuTaskCtx *t,
                          int bw4, int bh4, const uint64_t masks[2],
                          int mvy, int mvx, CapWarp *wmp)
{
    int pts[8][2][2];
    int np = 0;
    const RefMvsBlock *r = f->rf->r;
    const int stride = f->rf->r_stride;

#define ADD_SAMPLE(dx, dy, sx, sy, rp)                                      \
    do {                                                                    \
        const RefMvsBlock *rp_ = (rp);                                      \
        const uint8_t *bd_ = f->block_dim + 4 * rp_->bs;                    \
        pts[np][0][0] = 16 * (2 * (dx) + (sx) * bd_[0]) - 8;                \
        pts[np][0][1] = 16 * (2 * (dy) + (sy) * bd_[1]) - 8;                \
        pts[np][1][0] = pts[np][0][0] + rp_->mv[0][1];                      \
        pts[np][1][1] = pts[np][0][1] + rp_->mv[0][0];                      \
        np++;                                                               \
    } while (0)

    if ((masks[0] & 0xFFFFFFFFu) == 1 && !(masks[1] >> 32)) {
        const RefMvsBlock *rp = &r[(int64_t)(t->by - 1) * stride + t->bx];
        const int aw4 = f->block_dim[4 * rp->bs];
        const int off = t->bx & (aw4 - 1);
        ADD_SAMPLE(-off, 0, 1, -1, rp);
    } else {
        uint64_t xmask = masks[0] & 0xFFFFFFFFu;
        int off = 0;
        while (np < 8 && xmask) {
            int tz = 0;
            while (!((xmask >> tz) & 1))
                tz++;
            off += tz;
            xmask >>= tz;
            ADD_SAMPLE(off, 0, 1, -1,
                       &r[(int64_t)(t->by - 1) * stride + t->bx + off]);
            xmask &= ~1ull;
        }
    }
    if (np < 8 && masks[1] == 1) {
        const RefMvsBlock *rp = &r[(int64_t)t->by * stride + t->bx - 1];
        const int lh4 = f->block_dim[4 * rp->bs + 1];
        const int off = t->by & (lh4 - 1);
        ADD_SAMPLE(0, -off, -1, 1,
                   &r[(int64_t)(t->by - off) * stride + t->bx - 1]);
    } else {
        uint64_t ymask = masks[1] & 0xFFFFFFFFu;
        int off = 0;
        while (np < 8 && ymask) {
            int tz = 0;
            while (!((ymask >> tz) & 1))
                tz++;
            off += tz;
            ymask >>= tz;
            ADD_SAMPLE(0, off, -1, 1,
                       &r[(int64_t)(t->by + off) * stride + t->bx - 1]);
            ymask &= ~1ull;
        }
    }
    if (np < 8 && (masks[1] >> 32))
        ADD_SAMPLE(0, 0, -1, -1,
                   &r[(int64_t)(t->by - 1) * stride + t->bx - 1]);
    if (np < 8 && (masks[0] >> 32))
        ADD_SAMPLE(bw4, 0, 1, -1,
                   &r[(int64_t)(t->by - 1) * stride + t->bx + bw4]);
#undef ADD_SAMPLE

    /* select by motion-vector difference against a threshold */
    int mvd[8];
    int ret = 0;
    const int thresh = 4 * dmax_(4, dmin_(28, dmax_(bw4, bh4)));
    for (int i = 0; i < np; i++) {
        const int d = (pts[i][1][0] - pts[i][0][0] - mvx < 0
                           ? -(pts[i][1][0] - pts[i][0][0] - mvx)
                           : pts[i][1][0] - pts[i][0][0] - mvx)
                      + (pts[i][1][1] - pts[i][0][1] - mvy < 0
                             ? -(pts[i][1][1] - pts[i][0][1] - mvy)
                             : pts[i][1][1] - pts[i][0][1] - mvy);
        mvd[i] = d > thresh ? -1 : d;
        if (mvd[i] != -1)
            ret++;
    }
    if (!ret) {
        ret = 1;
    } else {
        int i = 0, j = np - 1;
        for (int k = 0; k < np - ret; k++) {
            while (mvd[i] != -1)
                i++;
            while (mvd[j] == -1)
                j--;
            if (i > j)
                break;
            mvd[i] = mvd[j];
            memcpy(pts[i], pts[j], sizeof(pts[i]));
            i++;
            j--;
        }
    }

    memset(wmp, 0, sizeof(*wmp));
    wmp->matrix[2] = wmp->matrix[5] = 0x10000;
    if (!find_affine_int(pts, ret, bw4, bh4, mvy, mvx, wmp, t->bx, t->by)
        && !get_shear_params(wmp))
        wmp->type = WM_AFFINE;
    else
        wmp->type = WM_IDENTITY;
}

/* ---- subpel filter read (tile.py _read_filter) -------------------------- */

static void read_filter(DtpuFrameCtx *f, DtpuTileCtx *ts, DtpuTaskCtx *t,
                        Blk *b, int has_subpel_filter, int comp, int by4,
                        int bx4, int filter_out[2])
{
    if (f->subpel_filter_mode == FILTER_SWITCHABLE) {
        if (has_subpel_filter) {
            const int ctx1 = get_filter_ctx(t->a, t->l, comp, 0, b->ref[0],
                                            by4, bx4);
            const int f0 = dtpu_decode_symbol_adapt(
                ts->msac, ts->filter + (0 * 8 + ctx1) * 4, 2);
            int f1 = f0;
            if (f->dual_filter) {
                const int ctx2 = get_filter_ctx(t->a, t->l, comp, 1,
                                                b->ref[0], by4, bx4);
                f1 = dtpu_decode_symbol_adapt(
                    ts->msac, ts->filter + (1 * 8 + ctx2) * 4, 2);
            }
            filter_out[0] = f0;
            filter_out[1] = f1;
        } else {
            filter_out[0] = filter_out[1] = 0;
        }
    } else {
        filter_out[0] = filter_out[1] = f->subpel_filter_mode;
    }
}

/* ---- OBMC / sub8x8 capture (tile.py _capture_obmc/_capture_sub8x8) ----- */

static void capture_obmc(DtpuFrameCtx *f, DtpuTileCtx *ts, DtpuTaskCtx *t,
                         CapBlock *c, const Blk *b, int bw4, int bh4,
                         int w4, int h4, int bx4, int by4)
{
    const RefMvsBlock *r = f->rf->r;
    const int stride = f->rf->r_stride;
    const uint8_t *bd = f->block_dim + 4 * b->bs;
    c->obmc_start = (int32_t)f->n_obmc;
    if (t->by > ts->row_start) {
        int i = 0, x = 0;
        while (x < w4 && i < dmin_(bd[2], 4)) {
            const RefMvsBlock *a_r =
                &r[(int64_t)(t->by - 1) * stride + t->bx + x + 1];
            const int step4 = dclip_(f->block_dim[4 * a_r->bs], 2, 16);
            if (a_r->ref[0] > 0) {
                if (f->n_obmc >= f->cap_obmc_cap) {
                    f->error = 1;
                    return;
                }
                CapObmc *o = &f->cap_obmc[f->n_obmc++];
                o->kind = 0;
                o->off = U8(x);
                o->mv[0] = a_r->mv[0][0];
                o->mv[1] = a_r->mv[0][1];
                o->refidx = (int8_t)(a_r->ref[0] - 1);
                o->f2d = f->filter_2d_tbl[t->a->filter[1][bx4 + x + 1] * 4
                                          + t->a->filter[0][bx4 + x + 1]];
                o->step4 = U8(step4);
                o->pad = 0;
                i++;
            }
            x += step4;
        }
    }
    if (t->bx > ts->col_start) {
        int i = 0, y = 0;
        while (y < h4 && i < dmin_(bd[3], 4)) {
            const RefMvsBlock *l_r =
                &r[(int64_t)(t->by + y + 1) * stride + t->bx - 1];
            const int step4 = dclip_(f->block_dim[4 * l_r->bs + 1], 2, 16);
            if (l_r->ref[0] > 0) {
                if (f->n_obmc >= f->cap_obmc_cap) {
                    f->error = 1;
                    return;
                }
                CapObmc *o = &f->cap_obmc[f->n_obmc++];
                o->kind = 1;
                o->off = U8(y);
                o->mv[0] = l_r->mv[0][0];
                o->mv[1] = l_r->mv[0][1];
                o->refidx = (int8_t)(l_r->ref[0] - 1);
                o->f2d = f->filter_2d_tbl[t->l->filter[1][by4 + y + 1] * 4
                                          + t->l->filter[0][by4 + y + 1]];
                o->step4 = U8(step4);
                o->pad = 0;
                i++;
            }
            y += step4;
        }
    }
    c->obmc_count = (int32_t)f->n_obmc - c->obmc_start;
}

/* ---- decode_b: inter path (tile.py _decode_b_inter) --------------------- */

static void decode_b_inter(DtpuFrameCtx *f, DtpuTileCtx *ts, DtpuTaskCtx *t,
                           Blk *b, int edge_flags, const uint8_t *bd,
                           int bx4, int by4, int cbx4, int cby4, int bw4,
                           int bh4, int w4, int h4, int cbw4, int cbh4,
                           int have_top, int have_left, int has_chroma,
                           int seg_pred, const DtpuSegData *sd)
{
    DtpuMsac *s = ts->msac;
    BlockCtx *a = t->a, *l = t->l;
    DtpuMvCand stack[8];
    int n_mvs, mctx;
    int is_comp;

    if (b->skip_mode) {
        is_comp = 1;
    } else if ((sd == NULL || (sd->ref == -1 && !sd->globalmv && !sd->skip))
               && f->switchable_comp_refs && dmin_(bw4, bh4) > 1) {
        const int ctx = get_comp_ctx(a, l, by4, bx4, have_top, have_left);
        is_comp = dtpu_decode_bool_adapt(s, ts->comp + 2 * ctx);
    } else {
        is_comp = 0;
    }

    int has_subpel_filter = 0;
    int filter_[2];
    t->cur_warp_valid = 0;

    if (b->skip_mode) {
        b->ref[0] = f->skip_mode_refs[0];
        b->ref[1] = f->skip_mode_refs[1];
        b->comp_type = CT_AVG;
        b->inter_mode = CIPM_NEARESTMV_NEARESTMV;
        b->drl_idx = 0;
        n_mvs = refmvs_find_c(f, ts, t, b->ref[0] + 1, b->ref[1] + 1,
                              b->bs, edge_flags, stack, &mctx);
        (void)n_mvs;
        b->mv[0][0] = stack[0].mv[0][0];
        b->mv[0][1] = stack[0].mv[0][1];
        b->mv[1][0] = stack[0].mv[1][0];
        b->mv[1][1] = stack[0].mv[1][1];
        fix_mv_precision_f(f, &b->mv[0][0], &b->mv[0][1]);
        fix_mv_precision_f(f, &b->mv[1][0], &b->mv[1][1]);
        b->motion_mode = MM_TRANSLATION;
        b->interintra_type = II_NONE;
        read_filter(f, ts, t, b, has_subpel_filter, 1, by4, bx4, filter_);
    } else if (is_comp) {
        const int dir_ctx =
            get_comp_dir_ctx(a, l, by4, bx4, have_top, have_left);
        if (dtpu_decode_bool_adapt(s, ts->comp_dir + 2 * dir_ctx)) {
            /* bidirectional */
            const int ctx1 = fwd_ref_ctx(a, l, by4, bx4, have_top,
                                         have_left);
            if (dtpu_decode_bool_adapt(s,
                                       ts->comp_fwd_ref + (0 * 3 + ctx1) * 2)) {
                const int ctx2 = fwd_ref_2_ctx(a, l, by4, bx4, have_top,
                                               have_left);
                b->ref[0] = 2 + dtpu_decode_bool_adapt(
                    s, ts->comp_fwd_ref + (2 * 3 + ctx2) * 2);
            } else {
                const int ctx2 = fwd_ref_1_ctx(a, l, by4, bx4, have_top,
                                               have_left);
                b->ref[0] = dtpu_decode_bool_adapt(
                    s, ts->comp_fwd_ref + (1 * 3 + ctx2) * 2);
            }
            const int ctx3 = bwd_ref_ctx(a, l, by4, bx4, have_top,
                                         have_left);
            if (dtpu_decode_bool_adapt(s,
                                       ts->comp_bwd_ref + (0 * 3 + ctx3) * 2)) {
                b->ref[1] = 6;
            } else {
                const int ctx4 = bwd_ref_1_ctx(a, l, by4, bx4, have_top,
                                               have_left);
                b->ref[1] = 4 + dtpu_decode_bool_adapt(
                    s, ts->comp_bwd_ref + (1 * 3 + ctx4) * 2);
            }
        } else {
            /* unidirectional */
            const int uctx_p = ref_ctx(a, l, by4, bx4, have_top, have_left);
            if (dtpu_decode_bool_adapt(s,
                                       ts->comp_uni_ref + (0 * 3 + uctx_p) * 2)) {
                b->ref[0] = 4;
                b->ref[1] = 6;
            } else {
                const int uctx_p1 = uni_p1_ctx(a, l, by4, bx4, have_top,
                                               have_left);
                b->ref[0] = 0;
                b->ref[1] = 1 + dtpu_decode_bool_adapt(
                    s, ts->comp_uni_ref + (1 * 3 + uctx_p1) * 2);
                if (b->ref[1] == 2) {
                    const int uctx_p2 = fwd_ref_2_ctx(a, l, by4, bx4,
                                                      have_top, have_left);
                    b->ref[1] += dtpu_decode_bool_adapt(
                        s, ts->comp_uni_ref + (2 * 3 + uctx_p2) * 2);
                }
            }
        }

        n_mvs = refmvs_find_c(f, ts, t, b->ref[0] + 1, b->ref[1] + 1,
                              b->bs, edge_flags, stack, &mctx);
        b->inter_mode = dtpu_decode_symbol_adapt(
            s, ts->comp_inter_mode + 8 * mctx, 7);

        const uint8_t *im = f->comp_inter_modes + 2 * b->inter_mode;
        b->drl_idx = 0;
        if (b->inter_mode == CIPM_NEWMV_NEWMV) {
            if (n_mvs > 1) {
                const int drl_ctx = get_drl_context(stack, 0);
                b->drl_idx += dtpu_decode_bool_adapt(
                    s, ts->drl_bit + 2 * drl_ctx);
                if (b->drl_idx == 1 && n_mvs > 2) {
                    const int drl_ctx2 = get_drl_context(stack, 1);
                    b->drl_idx += dtpu_decode_bool_adapt(
                        s, ts->drl_bit + 2 * drl_ctx2);
                }
            }
        } else if (im[0] == IPM_NEARMV || im[1] == IPM_NEARMV) {
            b->drl_idx = 1;
            if (n_mvs > 2) {
                const int drl_ctx = get_drl_context(stack, 1);
                b->drl_idx += dtpu_decode_bool_adapt(
                    s, ts->drl_bit + 2 * drl_ctx);
                if (b->drl_idx == 2 && n_mvs > 3) {
                    const int drl_ctx2 = get_drl_context(stack, 2);
                    b->drl_idx += dtpu_decode_bool_adapt(
                        s, ts->drl_bit + 2 * drl_ctx2);
                }
            }
        }

        has_subpel_filter = dmin_(bw4, bh4) == 1
            || b->inter_mode != CIPM_GLOBALMV_GLOBALMV;
        for (int idx = 0; idx < 2; idx++) {
            const int mode_i = im[idx];
            if (mode_i == IPM_NEARMV || mode_i == IPM_NEARESTMV) {
                b->mv[idx][0] = stack[b->drl_idx].mv[idx][0];
                b->mv[idx][1] = stack[b->drl_idx].mv[idx][1];
                fix_mv_precision_f(f, &b->mv[idx][0], &b->mv[idx][1]);
            } else if (mode_i == IPM_GLOBALMV) {
                has_subpel_filter |=
                    f->rf->gmv[b->ref[idx]].type == WM_TRANSLATION;
                dtpu_get_gmv_2d(&f->rf->gmv[b->ref[idx]], t->bx, t->by,
                                bw4, bh4, f->force_integer_mv, f->hp,
                                &b->mv[idx][0], &b->mv[idx][1]);
            } else { /* NEWMV */
                b->mv[idx][0] = stack[b->drl_idx].mv[idx][0];
                b->mv[idx][1] = stack[b->drl_idx].mv[idx][1];
                read_mv_residual(ts, &b->mv[idx][0], &b->mv[idx][1],
                                 f->hp - f->force_integer_mv);
            }
        }

        /* jnt_comp vs seg vs wedge */
        int is_segwedge = 0;
        if (f->seq_masked_compound) {
            const int mask_ctx = get_mask_comp_ctx(a, l, by4, bx4);
            is_segwedge = dtpu_decode_bool_adapt(
                s, ts->mask_comp + 2 * mask_ctx);
        }
        if (!is_segwedge) {
            if (f->seq_jnt_comp) {
                const int jnt_ctx = get_jnt_comp_ctx(
                    f, b->ref[0], b->ref[1], a, l, by4, bx4);
                b->comp_type = CT_WEIGHTED_AVG + dtpu_decode_bool_adapt(
                    s, ts->jnt_comp + 2 * jnt_ctx);
            } else {
                b->comp_type = CT_AVG;
            }
        } else {
            if (f->wedge_allowed_mask & (1u << b->bs)) {
                const int wctx = f->wedge_ctx_lut[b->bs];
                b->comp_type = CT_WEDGE - dtpu_decode_bool_adapt(
                    s, ts->wedge_comp + 2 * wctx);
                if (b->comp_type == CT_WEDGE)
                    b->wedge_idx = dtpu_decode_symbol_adapt(
                        s, ts->wedge_idx + 16 * wctx, 15);
            } else {
                b->comp_type = CT_SEG;
            }
            b->mask_sign = dtpu_decode_bool_equi(s);
        }

        b->motion_mode = MM_TRANSLATION;
        b->interintra_type = II_NONE;
        read_filter(f, ts, t, b, has_subpel_filter, 1, by4, bx4, filter_);
    } else {
        b->comp_type = CT_NONE;
        if (sd && sd->ref > 0) {
            b->ref[0] = sd->ref - 1;
        } else if (sd && (sd->globalmv || sd->skip)) {
            b->ref[0] = 0;
        } else {
            const int ctx1 = ref_ctx(a, l, by4, bx4, have_top, have_left);
            int ref0;
            if (dtpu_decode_bool_adapt(s, ts->ref + (0 * 3 + ctx1) * 2)) {
                const int ctx2 = bwd_ref_ctx(a, l, by4, bx4, have_top,
                                             have_left);
                if (dtpu_decode_bool_adapt(s,
                                           ts->ref + (1 * 3 + ctx2) * 2)) {
                    ref0 = 6;
                } else {
                    const int ctx3 = bwd_ref_1_ctx(a, l, by4, bx4,
                                                   have_top, have_left);
                    ref0 = 4 + dtpu_decode_bool_adapt(
                        s, ts->ref + (5 * 3 + ctx3) * 2);
                }
            } else {
                const int ctx2 = fwd_ref_ctx(a, l, by4, bx4, have_top,
                                             have_left);
                if (dtpu_decode_bool_adapt(s,
                                           ts->ref + (2 * 3 + ctx2) * 2)) {
                    const int ctx3 = fwd_ref_2_ctx(a, l, by4, bx4,
                                                   have_top, have_left);
                    ref0 = 2 + dtpu_decode_bool_adapt(
                        s, ts->ref + (4 * 3 + ctx3) * 2);
                } else {
                    const int ctx3 = fwd_ref_1_ctx(a, l, by4, bx4,
                                                   have_top, have_left);
                    ref0 = dtpu_decode_bool_adapt(
                        s, ts->ref + (3 * 3 + ctx3) * 2);
                }
            }
            b->ref[0] = ref0;
        }
        b->ref[1] = -1;

        n_mvs = refmvs_find_c(f, ts, t, b->ref[0] + 1, -1, b->bs,
                              edge_flags, stack, &mctx);

        if ((sd && (sd->skip || sd->globalmv))
            || dtpu_decode_bool_adapt(s,
                                      ts->newmv_mode + 2 * (mctx & 7))) {
            if ((sd && (sd->skip || sd->globalmv))
                || !dtpu_decode_bool_adapt(
                       s, ts->globalmv_mode + 2 * ((mctx >> 3) & 1))) {
                b->inter_mode = IPM_GLOBALMV;
                dtpu_get_gmv_2d(&f->rf->gmv[b->ref[0]], t->bx, t->by, bw4,
                                bh4, f->force_integer_mv, f->hp,
                                &b->mv[0][0], &b->mv[0][1]);
                has_subpel_filter = dmin_(bw4, bh4) == 1
                    || f->rf->gmv[b->ref[0]].type == WM_TRANSLATION;
            } else {
                has_subpel_filter = 1;
                if (dtpu_decode_bool_adapt(
                        s, ts->refmv_mode + 2 * ((mctx >> 4) & 15))) {
                    b->inter_mode = IPM_NEARMV;
                    b->drl_idx = 1;
                    if (n_mvs > 2) {
                        const int drl_ctx = get_drl_context(stack, 1);
                        b->drl_idx += dtpu_decode_bool_adapt(
                            s, ts->drl_bit + 2 * drl_ctx);
                        if (b->drl_idx == 2 && n_mvs > 3) {
                            const int drl_ctx2 = get_drl_context(stack, 2);
                            b->drl_idx += dtpu_decode_bool_adapt(
                                s, ts->drl_bit + 2 * drl_ctx2);
                        }
                    }
                } else {
                    b->inter_mode = IPM_NEARESTMV;
                    b->drl_idx = 0;
                }
                b->mv[0][0] = stack[b->drl_idx].mv[0][0];
                b->mv[0][1] = stack[b->drl_idx].mv[0][1];
                if (b->drl_idx < 2)
                    fix_mv_precision_f(f, &b->mv[0][0], &b->mv[0][1]);
            }
        } else {
            has_subpel_filter = 1;
            b->inter_mode = IPM_NEWMV;
            b->drl_idx = 0;
            if (n_mvs > 1) {
                const int drl_ctx = get_drl_context(stack, 0);
                b->drl_idx += dtpu_decode_bool_adapt(
                    s, ts->drl_bit + 2 * drl_ctx);
                if (b->drl_idx == 1 && n_mvs > 2) {
                    const int drl_ctx2 = get_drl_context(stack, 1);
                    b->drl_idx += dtpu_decode_bool_adapt(
                        s, ts->drl_bit + 2 * drl_ctx2);
                }
            }
            int mv0y, mv0x;
            if (n_mvs > 1) {
                mv0y = stack[b->drl_idx].mv[0][0];
                mv0x = stack[b->drl_idx].mv[0][1];
            } else {
                mv0y = stack[0].mv[0][0];
                mv0x = stack[0].mv[0][1];
                fix_mv_precision_f(f, &mv0y, &mv0x);
            }
            read_mv_residual(ts, &mv0y, &mv0x,
                             f->hp - f->force_integer_mv);
            b->mv[0][0] = mv0y;
            b->mv[0][1] = mv0x;
        }

        /* interintra */
        const int ii_sz_grp = f->ymode_size_ctx[b->bs];
        if (f->seq_inter_intra
            && (f->interintra_allowed_mask & (1u << b->bs))
            && dtpu_decode_bool_adapt(s, ts->interintra + 2 * ii_sz_grp)) {
            b->interintra_mode = dtpu_decode_symbol_adapt(
                s, ts->interintra_mode + 4 * ii_sz_grp, 3);
            const int wctx = f->wedge_ctx_lut[b->bs];
            b->interintra_type = II_BLEND + dtpu_decode_bool_adapt(
                s, ts->interintra_wedge + 2 * wctx);
            if (b->interintra_type == II_WEDGE)
                b->wedge_idx = dtpu_decode_symbol_adapt(
                    s, ts->wedge_idx + 16 * wctx, 15);
        } else {
            b->interintra_type = II_NONE;
        }

        /* motion variation */
        if (f->switchable_motion_mode && b->interintra_type == II_NONE
            && dmin_(bw4, bh4) >= 2
            && !(!f->force_integer_mv && b->inter_mode == IPM_GLOBALMV
                 && f->rf->gmv[b->ref[0]].type > WM_TRANSLATION)
            && ((have_left && findoddzero(l->intra, by4 + 1, h4 >> 1))
                || (have_top && findoddzero(a->intra, bx4 + 1, w4 >> 1)))) {
            uint64_t masks[2];
            find_matching_ref(f, ts, t, edge_flags, bw4, bh4, w4, h4,
                              have_left, have_top, b->ref[0], masks);
            const int allow_warp =
                !f->svc_scale[b->ref[0]] && !f->force_integer_mv
                && f->warp_motion && (masks[0] | masks[1]);
            if (allow_warp)
                b->motion_mode = dtpu_decode_symbol_adapt(
                    s, ts->motion_mode + 4 * b->bs, 2);
            else
                b->motion_mode = dtpu_decode_bool_adapt(
                    s, ts->obmc + 2 * b->bs) ? MM_OBMC : MM_TRANSLATION;
            if (b->motion_mode == MM_WARP) {
                has_subpel_filter = 0;
                derive_warpmv(f, t, bw4, bh4, masks, b->mv[0][0],
                              b->mv[0][1], &t->cur_warp);
                t->cur_warp_valid = 1;
            }
        } else {
            b->motion_mode = MM_TRANSLATION;
        }

        read_filter(f, ts, t, b, has_subpel_filter, 0, by4, bx4, filter_);
    }

    b->filter2d = f->filter_2d_tbl[filter_[1] * 4 + filter_[0]];

    read_vartx_tree_c(f, ts, t, b, bx4, by4);

    /* capture + coefficient walk */
    CapBlock *c = cap_block_begin(f, t, b, 1, edge_flags);
    if (!c)
        return;
    if (t->cur_warp_valid) {
        if (f->n_warp >= f->cap_warp_cap) {
            f->error = 1;
            return;
        }
        c->warp_idx = (int32_t)f->n_warp;
        f->cap_warp[f->n_warp++] = t->cur_warp;
    }
    if (b->motion_mode == MM_OBMC)
        capture_obmc(f, ts, t, c, b, bw4, bh4, w4, h4, bx4, by4);
    if (bw4 == 1 || bh4 == f->ss_ver) {
        const int left_f2d = f->filter_2d_tbl[l->filter[1][by4] * 4
                                              + l->filter[0][by4]];
        const int top_f2d = f->filter_2d_tbl[a->filter[1][bx4] * 4
                                             + a->filter[0][bx4]];
        c->sub8x8 = t->tl_4x4_filter | (left_f2d << 8) | (top_f2d << 16);
    }
    inter_coef_walk(f, ts, t, b, bx4, by4, bw4, bh4, w4, h4, has_chroma);
    c->coef_count = (int32_t)f->n_coef_meta - c->coef_start;
    t->tl_4x4_filter = b->filter2d;

    if (f->loopfilter_any) {
        const int is_globalmv =
            b->inter_mode == (is_comp ? CIPM_GLOBALMV_GLOBALMV
                                      : IPM_GLOBALMV);
        const uint8_t lvl[4] = {
            ts->lflvl[b->seg_id][0][b->ref[0] + 1][1 - is_globalmv],
            ts->lflvl[b->seg_id][1][b->ref[0] + 1][1 - is_globalmv],
            ts->lflvl[b->seg_id][2][b->ref[0] + 1][1 - is_globalmv],
            ts->lflvl[b->seg_id][3][b->ref[0] + 1][1 - is_globalmv],
        };
        create_lf_mask_c(f, t, b, lvl, has_chroma, 1);
    }

    /* splat mvs + context updates */
    if (is_comp) {
        const int mf =
            (b->inter_mode == CIPM_GLOBALMV_GLOBALMV)
            | (2 * !!((1 << b->inter_mode) & 0xBC));
        dtpu_splat_mv(f->rf, t->by, t->bx, bw4, bh4, b->mv[0][0],
                      b->mv[0][1], b->mv[1][0], b->mv[1][1], b->ref[0] + 1,
                      b->ref[1] + 1, b->bs, mf);
    } else {
        const int mf =
            (b->inter_mode == IPM_GLOBALMV && dmin_(bw4, bh4) >= 2)
            | (2 * (b->inter_mode == IPM_NEWMV));
        dtpu_splat_mv(f->rf, t->by, t->bx, bw4, bh4, b->mv[0][0],
                      b->mv[0][1], 0, 0, b->ref[0] + 1,
                      b->interintra_type ? 0 : -1, b->bs, mf);
    }

    memset(a->seg_pred + bx4, seg_pred, bw4);
    memset(a->skip_mode + bx4, b->skip_mode, bw4);
    memset(a->intra + bx4, 0, bw4);
    memset(a->skip + bx4, b->skip, bw4);
    memset(a->pal_sz + bx4, 0, bw4);
    memset(t->pal_sz_uv + bx4, 0, bw4);
    memset(t->pal_sz_uv + 32 + by4, 0, bh4);
    memset(a->tx_intra + bx4, bd[2], bw4);
    memset(a->comp_type + bx4, b->comp_type, bw4);
    memset(a->filter[0] + bx4, filter_[0], bw4);
    memset(a->filter[1] + bx4, filter_[1], bw4);
    memset(a->mode + bx4, b->inter_mode, bw4);
    memset(a->ref[0] + bx4, b->ref[0], bw4);
    memset(a->ref[1] + bx4, b->ref[1], bw4);
    memset(l->seg_pred + by4, seg_pred, bh4);
    memset(l->skip_mode + by4, b->skip_mode, bh4);
    memset(l->intra + by4, 0, bh4);
    memset(l->skip + by4, b->skip, bh4);
    memset(l->pal_sz + by4, 0, bh4);
    memset(l->tx_intra + by4, bd[3], bh4);
    memset(l->comp_type + by4, b->comp_type, bh4);
    memset(l->filter[0] + by4, filter_[0], bh4);
    memset(l->filter[1] + by4, filter_[1], bh4);
    memset(l->mode + by4, b->inter_mode, bh4);
    memset(l->ref[0] + by4, b->ref[0], bh4);
    memset(l->ref[1] + by4, b->ref[1], bh4);
    if (has_chroma) {
        memset(a->uvmode + cbx4, M_DC_PRED, cbw4);
        memset(l->uvmode + cby4, M_DC_PRED, cbh4);
    }
    update_segmap_noskip(f, t, b, bw4, bh4);
}

/* ---- decode_b common preamble (tile.py decode_b:393-599) ---------------- */

static void decode_b_c(DtpuFrameCtx *f, DtpuTileCtx *ts, DtpuTaskCtx *t,
                       int bl, int bs, int bp, int edge_flags)
{
    if (f->error)
        return;
    DtpuMsac *s = ts->msac;
    BlockCtx *a = t->a, *l = t->l;
    Blk blk;
    Blk *b = &blk;
    memset(b, 0, sizeof(*b));
    b->ref[0] = b->ref[1] = 0;
    const uint8_t *bd = f->block_dim + 4 * bs;
    const int bx4 = t->bx & 31, by4 = t->by & 31;
    const int ss_ver = f->ss_ver, ss_hor = f->ss_hor;
    const int cbx4 = bx4 >> ss_hor, cby4 = by4 >> ss_ver;
    const int bw4 = bd[0], bh4 = bd[1];
    const int w4 = dmin_(bw4, f->bw - t->bx);
    const int h4 = dmin_(bh4, f->bh - t->by);
    const int cbw4 = (bw4 + ss_hor) >> ss_hor;
    const int cbh4 = (bh4 + ss_ver) >> ss_ver;
    const int have_left = t->bx > ts->col_start;
    const int have_top = t->by > ts->row_start;
    const int has_chroma = f->layout != 0
        && (bw4 > ss_hor || (t->bx & 1)) && (bh4 > ss_ver || (t->by & 1));
    const int frame_is_inter = f->frame_is_inter;

    b->bl = bl;
    b->bp = bp;
    b->bs = bs;

    const DtpuSegData *sd = NULL;
    int seg_pred = 0;
    if (f->seg_enabled) {
        if (!f->seg_update_map) {
            if (f->have_prev_segmap) {
                const int sid = prev_segid(f, t->by, t->bx, w4, h4);
                if (sid >= 8) {
                    f->error = 2;
                    return;
                }
                b->seg_id = sid;
            } else {
                b->seg_id = 0;
            }
            sd = &f->seg_d[b->seg_id];
        } else if (f->seg_preskip) {
            if (f->seg_temporal)
                seg_pred = dtpu_decode_bool_adapt(
                    s, ts->seg_pred
                           + 2 * (a->seg_pred[bx4] + l->seg_pred[by4]));
            if (f->seg_temporal && seg_pred) {
                if (f->have_prev_segmap) {
                    const int sid = prev_segid(f, t->by, t->bx, w4, h4);
                    if (sid >= 8) {
                        f->error = 2;
                        return;
                    }
                    b->seg_id = sid;
                } else {
                    b->seg_id = 0;
                }
            } else {
                int seg_ctx;
                const int pred_seg_id = get_cur_frame_segid(
                    f, t->by, t->bx, have_top, have_left, &seg_ctx);
                const int diff = dtpu_decode_symbol_adapt(
                    s, ts->seg_id + 8 * seg_ctx, 7);
                const int last_active = f->seg_last_active;
                b->seg_id = neg_deinterleave(diff, pred_seg_id,
                                             last_active + 1);
                if (b->seg_id > last_active || b->seg_id >= 8)
                    b->seg_id = 0;
            }
            sd = &f->seg_d[b->seg_id];
        }
    } else {
        b->seg_id = 0;
    }

    /* skip_mode */
    if ((sd == NULL || (!sd->globalmv && sd->ref == -1 && !sd->skip))
        && f->skip_mode_enabled && dmin_(bw4, bh4) > 1) {
        const int smctx = a->skip_mode[bx4] + l->skip_mode[by4];
        b->skip_mode =
            dtpu_decode_bool_adapt(s, ts->skip_mode + 2 * smctx);
    } else {
        b->skip_mode = 0;
    }

    /* skip */
    if (b->skip_mode || (sd && sd->skip)) {
        b->skip = 1;
    } else {
        const int sctx = a->skip[bx4] + l->skip[by4];
        b->skip = dtpu_decode_bool_adapt(s, ts->skip + 2 * sctx);
    }

    /* post-skip segment id */
    if (f->seg_enabled && f->seg_update_map && !f->seg_preskip) {
        if (!b->skip && f->seg_temporal)
            seg_pred = dtpu_decode_bool_adapt(
                s, ts->seg_pred
                       + 2 * (a->seg_pred[bx4] + l->seg_pred[by4]));
        else
            seg_pred = 0;
        if (seg_pred) {
            if (f->have_prev_segmap) {
                const int sid = prev_segid(f, t->by, t->bx, w4, h4);
                if (sid >= 8) {
                    f->error = 2;
                    return;
                }
                b->seg_id = sid;
            } else {
                b->seg_id = 0;
            }
        } else {
            int seg_ctx;
            const int pred_seg_id = get_cur_frame_segid(
                f, t->by, t->bx, have_top, have_left, &seg_ctx);
            if (b->skip) {
                b->seg_id = pred_seg_id;
            } else {
                const int diff = dtpu_decode_symbol_adapt(
                    s, ts->seg_id + 8 * seg_ctx, 7);
                const int last_active = f->seg_last_active;
                b->seg_id = neg_deinterleave(diff, pred_seg_id,
                                             last_active + 1);
                if (b->seg_id > last_active)
                    b->seg_id = 0;
            }
            if (b->seg_id >= 8)
                b->seg_id = 0;
        }
        sd = &f->seg_d[b->seg_id];
    }

    /* cdef index */
    if (!b->skip) {
        const int idx = f->sb128
            ? (((t->bx & 16) >> 4) + ((t->by & 16) >> 3)) : 0;
        int32_t *cell = f->cdef_idx
            + (int64_t)(t->sb_cdef64_y + (idx >> 1)) * f->cdef_idx_stride
            + t->sb_cdef64_x + (idx & 1);
        if (*cell == -1) {
            const int v = (int)dtpu_decode_bools(s, f->cdef_n_bits);
            *cell = v;
            if (bw4 > 16)
                f->cdef_idx[(int64_t)(t->sb_cdef64_y + ((idx + 1) >> 1))
                                * f->cdef_idx_stride
                            + t->sb_cdef64_x + ((idx + 1) & 1)] = v;
            if (bh4 > 16)
                f->cdef_idx[(int64_t)(t->sb_cdef64_y + ((idx + 2) >> 1))
                                * f->cdef_idx_stride
                            + t->sb_cdef64_x + ((idx + 2) & 1)] = v;
            if (bw4 == 32 && bh4 == 32)
                f->cdef_idx[(int64_t)(t->sb_cdef64_y + ((idx + 3) >> 1))
                                * f->cdef_idx_stride
                            + t->sb_cdef64_x + ((idx + 3) & 1)] = v;
        }
    }

    /* delta q / lf at superblock origin */
    if (!((t->bx | t->by) & (31 >> !f->sb128))) {
        const int prev_qidx = ts->last_qidx;
        const int sb_bs = f->sb128 ? 0 /* BS_128x128 */ : 3 /* BS_64x64 */;
        const int have_delta_q =
            f->delta_q_present && (bs != sb_bs || !b->skip);
        int prev_delta_lf[4];
        memcpy(prev_delta_lf, ts->last_delta_lf, sizeof(prev_delta_lf));
        if (have_delta_q) {
            int delta_q = read_delta(s, ts->delta_q, f->delta_q_res_log2);
            ts->last_qidx = dclip_(ts->last_qidx + delta_q, 1, 255);
            if (f->delta_lf_present) {
                const int n_lfs =
                    f->delta_lf_multi ? (f->layout != 0 ? 4 : 2) : 1;
                for (int i = 0; i < n_lfs; i++) {
                    const int delta_lf = read_delta(
                        s, ts->delta_lf + 4 * (i + f->delta_lf_multi),
                        f->delta_lf_res_log2);
                    ts->last_delta_lf[i] =
                        dclip_(ts->last_delta_lf[i] + delta_lf, -63, 63);
                }
            }
        }
        if (ts->last_qidx == f->quant_yac) {
            /* frame-level dq (set at tile init) */
            if (ts->last_qidx != prev_qidx)
                recompute_dq(f, ts, ts->last_qidx);
        } else if (ts->last_qidx != prev_qidx) {
            recompute_dq(f, ts, ts->last_qidx);
        }
        if (memcmp(ts->last_delta_lf, prev_delta_lf,
                   sizeof(prev_delta_lf)))
            recompute_lflvl(f, ts, ts->last_delta_lf);
    }

    /* intra/inter flag */
    if (b->skip_mode) {
        b->intra = 0;
    } else if (frame_is_inter) {
        if (sd && (sd->ref >= 0 || sd->globalmv)) {
            b->intra = !sd->ref;
        } else {
            const int ictx =
                get_intra_ctx(a, l, by4, bx4, have_top, have_left);
            b->intra =
                1 - dtpu_decode_bool_adapt(s, ts->intra + 2 * ictx);
        }
    } else if (f->allow_intrabc) {
        b->intra = 1 - dtpu_decode_bool_adapt(s, ts->intrabc);
    } else {
        b->intra = 1;
    }

    if (b->intra)
        decode_b_intra(f, ts, t, b, edge_flags, bd, bx4, by4, cbx4, cby4,
                       bw4, bh4, w4, h4, cbw4, cbh4, have_top, have_left,
                       has_chroma, seg_pred);
    else if (frame_is_inter)
        decode_b_inter(f, ts, t, b, edge_flags, bd, bx4, by4, cbx4, cby4,
                       bw4, bh4, w4, h4, cbw4, cbh4, have_top, have_left,
                       has_chroma, seg_pred, sd);
    else
        decode_b_intrabc(f, ts, t, b, edge_flags, bd, bx4, by4, cbx4,
                         cby4, bw4, bh4, w4, h4, cbw4, cbh4, has_chroma,
                         seg_pred);
}

/* ---- decode_sb (tile.py decode_sb) -------------------------------------- */

static void decode_sb_c(DtpuFrameCtx *f, DtpuTileCtx *ts, DtpuTaskCtx *t,
                        int bl, int node)
{
    if (f->error)
        return;
    const int hsz = 16 >> bl;
    const int have_h_split = f->bw > t->bx + hsz;
    const int have_v_split = f->bh > t->by + hsz;
    const DtpuEdgeNode *n = &f->edge_tree[node];

    if (!have_h_split && !have_v_split)
        return decode_sb_c(f, ts, t, bl + 1, n->split[0]);

    const int bx8 = (t->bx & 31) >> 1;
    const int by8 = (t->by & 31) >> 1;
    const int ctx = get_partition_ctx(t->a, t->l, bl, by8, bx8);
    uint16_t *pc = ts->partition + (bl * 4 + ctx) * 16;
    int bp;

    if (have_h_split && have_v_split) {
        const int n_part = f->partition_count[bl];
        bp = dtpu_decode_symbol_adapt(ts->msac, pc, n_part);
        if (f->layout == 2 /* I422 */
            && (bp == BP_V || bp == BP_V4 || bp == BP_T_LEFT
                || bp == BP_T_RIGHT)) {
            f->error = 2;
            return;
        }
        const uint8_t *bsz = f->block_sizes + (bl * 10 + bp) * 2;

        switch (bp) {
        case BP_NONE:
            decode_b_c(f, ts, t, bl, bsz[0], bp, n->o);
            break;
        case BP_H:
            decode_b_c(f, ts, t, bl, bsz[0], bp, n->h[0]);
            t->by += hsz;
            decode_b_c(f, ts, t, bl, bsz[0], bp, n->h[1]);
            t->by -= hsz;
            break;
        case BP_V:
            decode_b_c(f, ts, t, bl, bsz[0], bp, n->v[0]);
            t->bx += hsz;
            decode_b_c(f, ts, t, bl, bsz[0], bp, n->v[1]);
            t->bx -= hsz;
            break;
        case BP_SPLIT:
            if (bl == BL_8X8) {
                decode_b_c(f, ts, t, bl, 21 /* BS_4x4 */, bp, EF_ALL);
                const int tl_filter = t->tl_4x4_filter;
                t->bx += 1;
                decode_b_c(f, ts, t, bl, 21, bp, n->split[0]);
                t->bx -= 1;
                t->by += 1;
                decode_b_c(f, ts, t, bl, 21, bp, n->split[1]);
                t->bx += 1;
                t->tl_4x4_filter = tl_filter;
                decode_b_c(f, ts, t, bl, 21, bp, n->split[2]);
                t->bx -= 1;
                t->by -= 1;
            } else {
                decode_sb_c(f, ts, t, bl + 1, n->split[0]);
                t->bx += hsz;
                decode_sb_c(f, ts, t, bl + 1, n->split[1]);
                t->bx -= hsz;
                t->by += hsz;
                decode_sb_c(f, ts, t, bl + 1, n->split[2]);
                t->bx += hsz;
                decode_sb_c(f, ts, t, bl + 1, n->split[3]);
                t->bx -= hsz;
                t->by -= hsz;
            }
            break;
        case BP_T_TOP:
            decode_b_c(f, ts, t, bl, bsz[0], bp, EF_ALL);
            t->bx += hsz;
            decode_b_c(f, ts, t, bl, bsz[0], bp, n->v[1]);
            t->bx -= hsz;
            t->by += hsz;
            decode_b_c(f, ts, t, bl, bsz[1], bp, n->h[1]);
            t->by -= hsz;
            break;
        case BP_T_BOTTOM:
            decode_b_c(f, ts, t, bl, bsz[0], bp, n->h[0]);
            t->by += hsz;
            decode_b_c(f, ts, t, bl, bsz[1], bp, n->v[0]);
            t->bx += hsz;
            decode_b_c(f, ts, t, bl, bsz[1], bp, 0);
            t->bx -= hsz;
            t->by -= hsz;
            break;
        case BP_T_LEFT:
            decode_b_c(f, ts, t, bl, bsz[0], bp, EF_ALL);
            t->by += hsz;
            decode_b_c(f, ts, t, bl, bsz[0], bp, n->h[1]);
            t->by -= hsz;
            t->bx += hsz;
            decode_b_c(f, ts, t, bl, bsz[1], bp, n->v[1]);
            t->bx -= hsz;
            break;
        case BP_T_RIGHT:
            decode_b_c(f, ts, t, bl, bsz[0], bp, n->v[0]);
            t->bx += hsz;
            decode_b_c(f, ts, t, bl, bsz[1], bp, n->h[0]);
            t->by += hsz;
            decode_b_c(f, ts, t, bl, bsz[1], bp, 0);
            t->by -= hsz;
            t->bx -= hsz;
            break;
        case BP_H4:
            decode_b_c(f, ts, t, bl, bsz[0], bp, n->h[0]);
            t->by += hsz >> 1;
            decode_b_c(f, ts, t, bl, bsz[0], bp, n->h4);
            t->by += hsz >> 1;
            decode_b_c(f, ts, t, bl, bsz[0], bp, EF_ALL_LEFT);
            t->by += hsz >> 1;
            if (t->by < f->bh)
                decode_b_c(f, ts, t, bl, bsz[0], bp, n->h[1]);
            t->by -= hsz * 3 >> 1;
            break;
        case BP_V4:
            decode_b_c(f, ts, t, bl, bsz[0], bp, n->v[0]);
            t->bx += hsz >> 1;
            decode_b_c(f, ts, t, bl, bsz[0], bp, n->v4);
            t->bx += hsz >> 1;
            decode_b_c(f, ts, t, bl, bsz[0], bp, EF_ALL_TOP);
            t->bx += hsz >> 1;
            if (t->bx < f->bw)
                decode_b_c(f, ts, t, bl, bsz[0], bp, n->v[1]);
            t->bx -= hsz * 3 >> 1;
            break;
        default:
            f->error = 2;
            return;
        }
    } else if (have_h_split) {
        const int is_split = dtpu_decode_bool(
            ts->msac, gather_top_partition_prob(pc, bl));
        if (is_split) {
            bp = BP_SPLIT;
            decode_sb_c(f, ts, t, bl + 1, n->split[0]);
            t->bx += hsz;
            decode_sb_c(f, ts, t, bl + 1, n->split[1]);
            t->bx -= hsz;
        } else {
            bp = BP_H;
            decode_b_c(f, ts, t, bl,
                       f->block_sizes[(bl * 10 + BP_H) * 2], BP_H,
                       n->h[0]);
        }
    } else {
        const int is_split = dtpu_decode_bool(
            ts->msac, gather_left_partition_prob(pc, bl));
        if (f->layout == 2 && !is_split) {
            f->error = 2;
            return;
        }
        if (is_split) {
            bp = BP_SPLIT;
            decode_sb_c(f, ts, t, bl + 1, n->split[0]);
            t->by += hsz;
            decode_sb_c(f, ts, t, bl + 1, n->split[2]);
            t->by -= hsz;
        } else {
            bp = BP_V;
            decode_b_c(f, ts, t, bl,
                       f->block_sizes[(bl * 10 + BP_V) * 2], BP_V,
                       n->v[0]);
        }
    }

    if (bp != BP_SPLIT || bl == BL_8X8) {
        memset(t->a->partition + bx8, f->al_part_ctx[(0 * 5 + bl) * 10 + bp],
               hsz);
        memset(t->l->partition + by8, f->al_part_ctx[(1 * 5 + bl) * 10 + bp],
               hsz);
    }
}

/* ---- tile sbrow driver (decode/frame.py decode_tile_sbrow, C part) ------ */

int dtpu_decode_tile_sbrow(DtpuFrameCtx *f, DtpuTileCtx *ts, DtpuTaskCtx *t)
{
    const int sb_step = f->sb_step;
    const int root_bl = f->root_bl;
    const int col_sb128_start = ts->col_start >> 5;

    int a_idx = t->a_base;
    t->bx = ts->col_start;
    while (t->bx < ts->col_end && !f->error) {
        t->a = t->a_list[a_idx];
        t->sb_cdef64_y = t->by >> 4;
        t->sb_cdef64_x = t->bx >> 4;
        if (root_bl == BL_128X128) {
            for (int i = 0; i < 4; i++)
                f->cdef_idx[(int64_t)(t->sb_cdef64_y + (i >> 1))
                                * f->cdef_idx_stride
                            + t->sb_cdef64_x + (i & 1)] = -1;
        } else {
            f->cdef_idx[(int64_t)t->sb_cdef64_y * f->cdef_idx_stride
                        + t->sb_cdef64_x] = -1;
        }
        read_lr_for_sb(f, ts, t);
        decode_sb_c(f, ts, t, root_bl, 0);
        if ((t->bx & 16) || f->sb128)
            a_idx++;
        t->bx += sb_step;
    }
    (void)col_sb128_start;
    if (ts->msac->cnt <= -15 && !f->error)
        f->error = 2; /* MSAC overread */
    return f->error;
}

void dtpu_abi_sizes(int64_t *sizes)
{
    sizes[0] = (int64_t)sizeof(CapBlock);
    sizes[1] = (int64_t)sizeof(CapObmc);
    sizes[2] = (int64_t)sizeof(CapWarp);
    sizes[3] = (int64_t)sizeof(DtpuFrameCtx);
    sizes[4] = (int64_t)sizeof(DtpuTileCtx);
    sizes[5] = (int64_t)sizeof(DtpuTaskCtx);
    sizes[6] = (int64_t)sizeof(BlockCtx);
    sizes[7] = (int64_t)sizeof(DtpuRefMvsFrame);
}
