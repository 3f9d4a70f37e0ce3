/* Native pass-2 intra replay: the ordered phase-B block walk
 * (prediction from reconstructed neighbours + cached-residual add) in
 * one C call per run of capture blocks.
 *
 * Port of the replay half of dav1d_tpu/recon/intra.py recon_b_intra
 * (reference dav1d_recon_b_intra, src/recon_tmpl.c:1176-1556) plus
 * dav1d_tpu/recon/ipred.py prepare_intra_edges (reference
 * dav1d_prepare_intra_edges, src/ipred_prepare_tmpl.c:76-204), cfl_ac /
 * cfl_pred (src/ipred_tmpl.c:658-703, 72-214) and pal_pred
 * (src/ipred_tmpl.c:717).  Bit-identical to the Python replay: the
 * conformance gauntlet (tests/test_e2e_aom.py) decodes every stream
 * through both paths.
 *
 * The driver walks the pass-1 capture arena directly (CapBlock + coef
 * meta + per-meta residual pointers from the batched itx stage), skips
 * plain inter blocks (already replayed order-free in phase A) and stops
 * at blocks it does not handle (intrabc, interintra) so the caller can
 * replay those in Python and resume. */

#include <string.h>

#include "dtpu.h"

#define EDGE_TR 1 /* EDGE_I444_TOP_HAS_RIGHT */
#define EDGE_BL 8 /* EDGE_I444_LEFT_HAS_BOTTOM */

/* implementation intra modes (dav1d_tpu.levels.IntraPredMode) */
enum {
    M_DC = 0, M_VERT = 1, M_HOR = 2, M_LEFT_DC = 3, M_TOP_DC = 4,
    M_DC128 = 5, M_Z1 = 6, M_Z2 = 7, M_Z3 = 8, M_SMOOTH = 9,
    M_SMOOTH_V = 10, M_SMOOTH_H = 11, M_PAETH = 12, M_FILTER = 13,
    M_CFL = 13, M_VERT_LEFT = 8,
};

/* mode -> base angle, VERT..VERT_LEFT (reference ipred_prepare_tmpl.c:46) */
static const int mode_to_angle[8] = {90, 180, 45, 135, 113, 157, 203, 67};

/* per impl mode: needs left, top, topleft, topright, bottomleft */
static const uint8_t edge_needs[14][5] = {
    [M_DC] = {1, 1, 0, 0, 0},      [M_VERT] = {0, 1, 0, 0, 0},
    [M_HOR] = {1, 0, 0, 0, 0},     [M_LEFT_DC] = {1, 0, 0, 0, 0},
    [M_TOP_DC] = {0, 1, 0, 0, 0},  [M_DC128] = {0, 0, 0, 0, 0},
    [M_Z1] = {0, 1, 1, 1, 0},      [M_Z2] = {1, 1, 1, 0, 0},
    [M_Z3] = {1, 0, 1, 0, 1},      [M_SMOOTH] = {1, 1, 0, 0, 0},
    [M_SMOOTH_V] = {1, 1, 0, 0, 0}, [M_SMOOTH_H] = {1, 1, 0, 0, 0},
    [M_PAETH] = {1, 1, 1, 0, 0},   [M_FILTER] = {1, 1, 1, 0, 0},
};

/* Build the edge vector (ofs = 128) and resolve the implementation
 * mode + angle.  dst is the plane; reads come straight from it — in
 * pass 2 the row above IS the reconstructed plane row (the Python
 * pass-1 path needs the saved pre-filter ipred_edge instead). */
static int prep_edges(int x, int have_left, int y, int have_top,
                      int w, int h, int edge_flags, const int32_t *dst,
                      int64_t stride, int dst_y, int dst_x, int mode,
                      int *angle_io, int tw, int th,
                      int filter_edge_enabled, int bitdepth,
                      int32_t *edge)
{
    const int ofs = 128;
    const int half = (1 << bitdepth) >> 1;
    int angle = *angle_io;
    const int32_t *above = dst + (int64_t)(dst_y - 1) * stride;

    if (mode >= M_VERT && mode <= M_VERT_LEFT) {
        angle = mode_to_angle[mode - M_VERT] + 3 * angle;
        if (angle <= 90)
            mode = angle < 90 && have_top ? M_Z1 : M_VERT;
        else if (angle < 180)
            mode = M_Z2;
        else
            mode = angle > 180 && have_left ? M_Z3 : M_HOR;
    } else if (mode == M_DC) {
        mode = have_left ? (have_top ? M_DC : M_LEFT_DC)
                         : (have_top ? M_TOP_DC : M_DC128);
    } else if (mode == M_PAETH) {
        mode = have_left ? (have_top ? M_PAETH : M_HOR)
                         : (have_top ? M_VERT : M_DC128);
    }
    *angle_io = angle;

    const uint8_t *need = edge_needs[mode];

    if (need[0]) { /* left */
        const int sz = th << 2;
        if (have_left) {
            int px_have = (h - y) << 2;
            if (px_have > sz)
                px_have = sz;
            for (int i = 0; i < px_have; i++)
                edge[ofs - 1 - i] = dst[(int64_t)(dst_y + i) * stride +
                                        dst_x - 1];
            for (int i = px_have; i < sz; i++)
                edge[ofs - 1 - i] = edge[ofs - px_have];
        } else {
            const int32_t fill = have_top ? above[dst_x] : half + 1;
            for (int i = 0; i < sz; i++)
                edge[ofs - 1 - i] = fill;
        }
        if (need[4]) { /* bottom-left */
            const int have_bl = (!have_left || y + th >= h)
                                    ? 0 : (edge_flags & EDGE_BL);
            if (have_bl) {
                int px_have = (h - y - th) << 2;
                if (px_have > sz)
                    px_have = sz;
                for (int i = 0; i < px_have; i++)
                    edge[ofs - sz - 1 - i] =
                        dst[(int64_t)(dst_y + sz + i) * stride + dst_x - 1];
                for (int i = px_have; i < sz; i++)
                    edge[ofs - sz - 1 - i] = edge[ofs - sz - px_have];
            } else {
                for (int i = 0; i < sz; i++)
                    edge[ofs - sz - 1 - i] = edge[ofs - sz];
            }
        }
    }

    if (need[1]) { /* top */
        const int sz = tw << 2;
        if (have_top) {
            int px_have = (w - x) << 2;
            if (px_have > sz)
                px_have = sz;
            for (int i = 0; i < px_have; i++)
                edge[ofs + 1 + i] = above[dst_x + i];
            for (int i = px_have; i < sz; i++)
                edge[ofs + 1 + i] = edge[ofs + px_have];
        } else {
            const int32_t fill =
                have_left ? dst[(int64_t)dst_y * stride + dst_x - 1]
                          : half - 1;
            for (int i = 0; i < sz; i++)
                edge[ofs + 1 + i] = fill;
        }
        if (need[3]) { /* top-right */
            const int have_tr = (!have_top || x + tw >= w)
                                    ? 0 : (edge_flags & EDGE_TR);
            if (have_tr) {
                int px_have = (w - x - tw) << 2;
                if (px_have > sz)
                    px_have = sz;
                for (int i = 0; i < px_have; i++)
                    edge[ofs + 1 + sz + i] = above[dst_x + sz + i];
                for (int i = px_have; i < sz; i++)
                    edge[ofs + 1 + sz + i] = edge[ofs + sz + px_have];
            } else {
                for (int i = 0; i < sz; i++)
                    edge[ofs + 1 + sz + i] = edge[ofs + sz];
            }
        }
    }

    if (need[2]) { /* top-left */
        if (have_left)
            edge[ofs] = have_top ? above[dst_x - 1]
                                 : dst[(int64_t)dst_y * stride + dst_x - 1];
        else
            edge[ofs] = have_top ? above[dst_x] : half;
        if (mode == M_Z2 && tw + th >= 6 && filter_edge_enabled)
            edge[ofs] = ((edge[ofs - 1] + edge[ofs + 1]) * 5 +
                         edge[ofs] * 6 + 8) >> 4;
    }

    return mode;
}

/* DC value per availability variant (reference ipred_tmpl.c:72-155). */
static int dc_gen_c(const int32_t *edge, int ofs, int width, int height,
                    int mode, int bitdepth)
{
    if (mode == M_DC128)
        return (1 << bitdepth) >> 1;
    if (mode == M_TOP_DC) {
        int64_t dc = width >> 1;
        for (int i = 0; i < width; i++)
            dc += edge[ofs + 1 + i];
        return (int)(dc >> (31 - __builtin_clz((unsigned)width)));
    }
    if (mode == M_LEFT_DC) {
        int64_t dc = height >> 1;
        for (int i = 0; i < height; i++)
            dc += edge[ofs - 1 - i];
        return (int)(dc >> (31 - __builtin_clz((unsigned)height)));
    }
    int64_t dc = (width + height) >> 1;
    for (int i = 0; i < width; i++)
        dc += edge[ofs + 1 + i];
    for (int i = 0; i < height; i++)
        dc += edge[ofs - 1 - i];
    const unsigned wh = (unsigned)(width + height);
    dc >>= __builtin_ctz(wh);
    if (width != height) {
        const int wide = width > height * 2 || height > width * 2;
        if (bitdepth == 8)
            dc = (dc * (wide ? 0x3334 : 0x5556)) >> 16;
        else
            dc = (dc * (wide ? 0x6667 : 0xAAAB)) >> 17;
    }
    return (int)dc;
}

/* Subsampled DC-subtracted luma (reference cfl_ac_c).  ac: (ch, cw). */
static void cfl_ac_c(int32_t *ac, const int32_t *y_plane, int64_t stride,
                     int y0, int x0, int w_pad, int h_pad, int cw, int ch,
                     int ss_hor, int ss_ver)
{
    const int shift = 1 + !ss_ver + !ss_hor;
    const int w_px = cw - 4 * w_pad, h_px = ch - 4 * h_pad;
    for (int y = 0; y < h_px; y++) {
        const int32_t *row = y_plane + (int64_t)(y0 + (y << ss_ver)) * stride;
        for (int x = 0; x < w_px; x++) {
            const int sx = x0 + (x << ss_hor);
            int s = row[sx];
            if (ss_hor)
                s += row[sx + 1];
            if (ss_ver) {
                s += row[sx + stride];
                if (ss_hor)
                    s += row[sx + stride + 1];
            }
            ac[y * cw + x] = s << shift;
        }
        for (int x = w_px; x < cw; x++)
            ac[y * cw + x] = ac[y * cw + w_px - 1];
    }
    for (int y = h_px; y < ch; y++)
        memcpy(ac + y * cw, ac + (y - 1) * cw, sizeof(int32_t) * cw);
    const int log2sz = (31 - __builtin_clz((unsigned)cw)) +
                       (31 - __builtin_clz((unsigned)ch));
    int64_t total = (1ll << log2sz) >> 1;
    for (int i = 0; i < cw * ch; i++)
        total += ac[i];
    const int32_t avg = (int32_t)(total >> log2sz);
    for (int i = 0; i < cw * ch; i++)
        ac[i] -= avg;
}

/* dc + alpha * ac, clipped (reference ipred_cfl_*_c). */
static void cfl_pred_c(int32_t *dst, int64_t stride, int width, int height,
                       const int32_t *ac, int ac_stride, int dc, int alpha,
                       int maxp)
{
    for (int y = 0; y < height; y++, dst += stride, ac += ac_stride)
        for (int x = 0; x < width; x++) {
            const int diff = alpha * ac[x];
            const int adiff = diff < 0 ? -diff : diff;
            const int adj = (adiff + 32) >> 6;
            int v = dc + (diff < 0 ? -adj : diff > 0 ? adj : 0);
            dst[x] = v < 0 ? 0 : v > maxp ? maxp : v;
        }
}

static void pal_pred_c(int32_t *dst, int64_t stride, const uint16_t *pal,
                       const uint8_t *idx, int w, int h)
{
    for (int y = 0; y < h; y++, dst += stride, idx += w)
        for (int x = 0; x < w; x++)
            dst[x] = pal[idx[x]];
}

static void add_resid_any(int32_t *plane, int64_t stride, int dy, int dx,
                          uint64_t r, int elsz, int h, int w, int maxp)
{
    if (elsz == 2)
        dtpu_add_residual16(plane, stride, dy, dx, (const int16_t *)r,
                            h, w, maxp);
    else
        dtpu_add_residual(plane, stride, dy, dx, (const int32_t *)r,
                          h, w, maxp);
}

/* One coefficient-meta consumption + residual add; returns 0 on a
 * mismatch the caller must fall back on. */
static int consume_coef(const DtpuReplayCtx *rc, int64_t *meta_pos,
                        int want_pl, int pl_plane, int maxp)
{
    const int32_t *mrow = rc->coef_meta + *meta_pos * 6;
    (*meta_pos)++;
    const int eob = mrow[0];
    const int pl = mrow[2] & 0xFF;
    if (pl != want_pl)
        return 0;
    if (eob < 0)
        return 1;
    const uint64_t rp = rc->resid_ptrs[*meta_pos - 1];
    if (!rp)
        return 0;
    const uint8_t *ti = rc->txfm_info + 8 * (mrow[2] >> 8);
    add_resid_any(rc->planes[pl_plane], rc->stride[pl_plane], mrow[3],
                  mrow[4], rp, rc->resid_elsz, 4 * ti[1], 4 * ti[0], maxp);
    return 1;
}

/* Replay capture blocks [start, end).  Plain inter blocks are skipped
 * (phase A already replayed them).  Returns the number of blocks
 * consumed from start; < (end - start) means the next block needs the
 * Python fallback (intrabc / interintra / consistency mismatch). */
int64_t dtpu_intra_replay(const DtpuReplayCtx *rc, int64_t start,
                          int64_t end)
{
    const int ss_hor = rc->ss_hor, ss_ver = rc->ss_ver;
    const int bitdepth = rc->bitdepth;
    const int maxp = (1 << bitdepth) - 1;
    const int ief_flag = rc->intra_edge_filter << 10;
    int32_t edge[257];
    int32_t ac[32 * 32];

    for (int64_t bi = start; bi < end; bi++) {
        const CapBlock *cb = &rc->cap_blocks[bi];
        if (cb->kind == 1) {
            if (cb->interintra_type)
                return bi - start;
            continue; /* phase A */
        }
        if (cb->kind != 0)
            return bi - start; /* intrabc -> Python */

        const int32_t tile = rc->tile_of_block[bi];
        const int32_t *tb = rc->tile_bounds + 4 * tile;
        const int col_start = tb[0], col_end = tb[1];
        const int row_start = tb[2], row_end = tb[3];

        const uint8_t *bd = rc->block_dim + 4 * cb->bs;
        const int bw4 = bd[0], bh4 = bd[1];
        const int bx = cb->bx, by = cb->by;
        int w4 = rc->bw - bx;
        if (w4 > bw4)
            w4 = bw4;
        int h4 = rc->bh - by;
        if (h4 > bh4)
            h4 = bh4;
        const int cw4 = (w4 + ss_hor) >> ss_hor;
        const int ch4 = (h4 + ss_ver) >> ss_ver;
        const int cbw4 = (bw4 + ss_hor) >> ss_hor;
        const int cbh4 = (bh4 + ss_ver) >> ss_ver;
        const int has_chroma = rc->layout != 0 &&
                               (bw4 > ss_hor || (bx & 1)) &&
                               (bh4 > ss_ver || (by & 1));
        const uint8_t *t_dim = rc->txfm_info + 8 * cb->tx;
        const uint8_t *uv_t_dim = rc->txfm_info + 8 * cb->uvtx;
        const int tw = t_dim[0], th = t_dim[1];
        const int utw = uv_t_dim[0], uth = uv_t_dim[1];
        const int sm_fl = (cb->sm_flags & 1) ? 512 : 0;
        const int sm_uv_fl = (cb->sm_flags & 2) ? 512 : 0;
        const int intra_flags = sm_fl | ief_flag;
        const uint16_t *pal =
            cb->pal_idx >= 0 ? rc->cap_pal + 24 * cb->pal_idx : 0;

        int64_t meta_pos = cb->coef_start;
        int t_bx = bx, t_by = by;

        if (cb->pal_sz[0]) /* idempotent in the Python loop; do once */
            pal_pred_c(rc->planes[0] + (int64_t)(4 * by) * rc->stride[0] +
                           4 * bx,
                       rc->stride[0], pal, rc->pal_arena + cb->pal_y_off,
                       bw4 * 4, bh4 * 4);

        for (int init_y = 0; init_y < h4; init_y += 16) {
            const int sub_h4 = h4 < init_y + 16 ? h4 : init_y + 16;
            const int sub_ch4g = (init_y + 16) >> ss_ver;
            const int sub_ch4 = ch4 < sub_ch4g ? ch4 : sub_ch4g;
            for (int init_x = 0; init_x < w4; init_x += 16) {
                const int sb_has_tr =
                    init_x + 16 < w4 ? 1
                    : init_y ? 0 : (cb->edge_flags & EDGE_TR);
                const int sb_has_bl =
                    init_x ? 0
                    : init_y + 16 < h4 ? 1 : (cb->edge_flags & EDGE_BL);
                const int sub_w4 = w4 < init_x + 16 ? w4 : init_x + 16;

                int y = init_y;
                t_by += init_y;
                while (y < sub_h4) {
                    int x = init_x;
                    t_bx += init_x;
                    while (x < sub_w4) {
                        const int dst_x = 4 * t_bx, dst_y = 4 * t_by;
                        if (!cb->pal_sz[0]) {
                            int angle = cb->y_angle;
                            const int ef =
                                (((y > init_y || !sb_has_tr) &&
                                  x + tw >= sub_w4) ? 0 : EDGE_TR) |
                                ((x > init_x ||
                                  (!sb_has_bl && y + th >= sub_h4))
                                     ? 0 : EDGE_BL);
                            const int m = prep_edges(
                                t_bx, t_bx > col_start, t_by,
                                t_by > row_start, col_end, row_end, ef,
                                rc->planes[0], rc->stride[0], dst_y, dst_x,
                                cb->y_mode, &angle, tw, th,
                                rc->intra_edge_filter, bitdepth, edge);
                            dtpu_ipred(m, edge, 128, tw * 4, th * 4,
                                       angle | intra_flags,
                                       4 * rc->bw - 4 * t_bx,
                                       4 * rc->bh - 4 * t_by, bitdepth,
                                       rc->sm_weights, rc->dr_deriv,
                                       rc->filter_taps,
                                       rc->planes[0] +
                                           (int64_t)dst_y * rc->stride[0] +
                                           dst_x,
                                       rc->stride[0]);
                        }
                        if (!cb->skip &&
                            !consume_coef(rc, &meta_pos, 0, 0, maxp))
                            return bi - start;
                        x += tw;
                        t_bx += tw;
                    }
                    t_bx -= x;
                    y += th;
                    t_by += th;
                }
                t_by -= y;

                if (!has_chroma)
                    continue;

                const int is_cfl = cb->uv_mode == M_CFL;
                if (is_cfl) {
                    /* CFL: luma AC + per-plane DC prediction (only at
                     * init 0,0 — asserted by the Python model) */
                    const int y0 = 4 * (t_by & ~ss_ver);
                    const int x0 = 4 * (t_bx & ~ss_hor);
                    const int fur_r =
                        (((cw4 << ss_hor) + utw - 1) & ~(utw - 1));
                    const int fur_b =
                        (((ch4 << ss_ver) + uth - 1) & ~(uth - 1));
                    cfl_ac_c(ac, rc->planes[0], rc->stride[0], y0, x0,
                             cbw4 - (fur_r >> ss_hor),
                             cbh4 - (fur_b >> ss_ver), cbw4 * 4, cbh4 * 4,
                             ss_hor, ss_ver);
                    for (int pl = 0; pl < 2; pl++) {
                        if (!cb->cfl_alpha[pl])
                            continue;
                        const int xpos = t_bx >> ss_hor;
                        const int ypos = t_by >> ss_ver;
                        const int dst_x = 4 * xpos, dst_y = 4 * ypos;
                        int angle0 = 0;
                        const int m = prep_edges(
                            xpos, xpos > (col_start >> ss_hor), ypos,
                            ypos > (row_start >> ss_ver),
                            col_end >> ss_hor, row_end >> ss_ver, 0,
                            rc->planes[1 + pl], rc->stride[1 + pl], dst_y,
                            dst_x, M_DC, &angle0, utw, uth, 0, bitdepth,
                            edge);
                        const int dc =
                            dc_gen_c(edge, 128, utw * 4, uth * 4, m,
                                     bitdepth);
                        cfl_pred_c(rc->planes[1 + pl] +
                                       (int64_t)dst_y * rc->stride[1 + pl] +
                                       dst_x,
                                   rc->stride[1 + pl], utw * 4, uth * 4,
                                   ac, cbw4 * 4, dc, cb->cfl_alpha[pl],
                                   maxp);
                    }
                } else if (cb->pal_sz[1]) {
                    const int dst_x = 4 * (t_bx >> ss_hor);
                    const int dst_y = 4 * (t_by >> ss_ver);
                    for (int pl = 0; pl < 2; pl++)
                        pal_pred_c(rc->planes[1 + pl] +
                                       (int64_t)dst_y * rc->stride[1 + pl] +
                                       dst_x,
                                   rc->stride[1 + pl], pal + 8 * (1 + pl),
                                   rc->pal_arena + cb->pal_uv_off,
                                   cbw4 * 4, cbh4 * 4);
                }

                const int uv_sb_has_tr =
                    ((init_x + 16) >> ss_hor) < cw4 ? 1
                    : init_y ? 0
                    : (cb->edge_flags & ((1 << 2) >> (rc->layout - 1)));
                const int uv_sb_has_bl =
                    init_x ? 0
                    : ((init_y + 16) >> ss_ver) < ch4
                        ? 1
                        : (cb->edge_flags & ((1 << 5) >> (rc->layout - 1)));
                const int sub_cw4g = (init_x + 16) >> ss_hor;
                const int sub_cw4 = cw4 < sub_cw4g ? cw4 : sub_cw4g;

                for (int pl = 0; pl < 2; pl++) {
                    int yc = init_y >> ss_ver;
                    t_by += init_y;
                    while (yc < sub_ch4) {
                        int xc = init_x >> ss_hor;
                        t_bx += init_x;
                        while (xc < sub_cw4) {
                            const int dst_x = 4 * (t_bx >> ss_hor);
                            const int dst_y = 4 * (t_by >> ss_ver);
                            const int pred_done =
                                (is_cfl && cb->cfl_alpha[pl]) ||
                                cb->pal_sz[1];
                            if (!pred_done) {
                                int angle = cb->uv_angle;
                                const int ef =
                                    (((yc > (init_y >> ss_ver) ||
                                       !uv_sb_has_tr) &&
                                      xc + utw >= sub_cw4) ? 0 : EDGE_TR) |
                                    ((xc > (init_x >> ss_hor) ||
                                      (!uv_sb_has_bl &&
                                       yc + uth >= sub_ch4))
                                         ? 0 : EDGE_BL);
                                const int uv_mode =
                                    is_cfl ? M_DC : cb->uv_mode;
                                const int xpos = t_bx >> ss_hor;
                                const int ypos = t_by >> ss_ver;
                                const int m = prep_edges(
                                    xpos, xpos > (col_start >> ss_hor),
                                    ypos, ypos > (row_start >> ss_ver),
                                    col_end >> ss_hor, row_end >> ss_ver,
                                    ef, rc->planes[1 + pl],
                                    rc->stride[1 + pl], dst_y, dst_x,
                                    uv_mode, &angle, utw, uth,
                                    rc->intra_edge_filter, bitdepth, edge);
                                dtpu_ipred(
                                    m, edge, 128, utw * 4, uth * 4,
                                    (angle | ief_flag) | sm_uv_fl,
                                    (4 * rc->bw + ss_hor -
                                     4 * (t_bx & ~ss_hor)) >> ss_hor,
                                    (4 * rc->bh + ss_ver -
                                     4 * (t_by & ~ss_ver)) >> ss_ver,
                                    bitdepth, rc->sm_weights, rc->dr_deriv,
                                    rc->filter_taps,
                                    rc->planes[1 + pl] +
                                        (int64_t)dst_y *
                                            rc->stride[1 + pl] +
                                        dst_x,
                                    rc->stride[1 + pl]);
                            }
                            if (!cb->skip &&
                                !consume_coef(rc, &meta_pos, 1 + pl,
                                              1 + pl, maxp))
                                return bi - start;
                            xc += utw;
                            t_bx += utw << ss_hor;
                        }
                        t_bx -= xc << ss_hor;
                        yc += uth;
                        t_by += uth << ss_ver;
                    }
                    t_by -= yc << ss_ver;
                }
            }
        }
        if (meta_pos != cb->coef_start + cb->coef_count)
            return bi - start; /* consumption mismatch: fall back */
    }
    return end - start;
}
