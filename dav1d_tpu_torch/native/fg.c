/* Film grain synthesis + application (host tier).
 *
 * Bit-exact port of the Python reference dav1d_tpu/recon/filmgrain.py
 * (itself oracle-parity-tested; reference src/filmgrain_tmpl.c
 * generate_grain_y:50, generate_grain_uv:89, fgy/fguv_32x32xn:170-404
 * and src/fg_apply_tmpl.c generate_scaling:41, apply:100-241; AV1 spec
 * 7.18.3).  The Python module remains the fallback/reference.
 *
 * Plane application is in place; the caller applies chroma planes FIRST
 * (they scale off pristine luma) and the luma plane last, which removes
 * the grain-free luma copy the Python path keeps. */

#include <stdint.h>
#include <stddef.h>
#include <stdlib.h>

#include "dtpu.h"

#define GRAIN_W 82
#define GRAIN_H 73
#define SUB_GRAIN_W 44
#define SUB_GRAIN_H 38
#define FG_BLOCK 32

static inline int fg_rand(uint32_t *state, int bits)
{
    const uint32_t r = *state;
    const uint32_t bit = ((r >> 0) ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1;
    *state = (r >> 1) | (bit << 15);
    return (int)((*state >> (16 - bits)) & ((1u << bits) - 1));
}

static inline int round2(int x, int shift)
{
    return (x + ((1 << shift) >> 1)) >> shift;
}

static inline int fg_clip(int v, int lo, int hi)
{
    return v < lo ? lo : v > hi ? hi : v;
}

void dtpu_fg_gen_y(const DtpuFgData *d, const int16_t *gauss, int bitdepth,
                   int32_t *buf /* (GRAIN_H+1) x GRAIN_W */)
{
    const int bdm8 = bitdepth - 8;
    uint32_t state = (uint32_t)d->seed;
    const int shift = 4 - bdm8 + d->grain_scale_shift;
    const int grain_ctr = 128 << bdm8;
    const int gmin = -grain_ctr, gmax = grain_ctr - 1;

    for (int i = 0; i < (GRAIN_H + 1) * GRAIN_W; i++)
        buf[i] = 0;
    for (int y = 0; y < GRAIN_H; y++)
        for (int x = 0; x < GRAIN_W; x++)
            buf[y * GRAIN_W + x] =
                round2(gauss[fg_rand(&state, 11)], shift);

    const int lag = d->ar_coeff_lag;
    if (!lag)
        return;
    for (int y = 3; y < GRAIN_H; y++)
        for (int x = 3; x < GRAIN_W - 3; x++) {
            int s = 0, ci = 0;
            for (int dy = -lag; dy <= 0; dy++)
                for (int dx = -lag; dx <= lag; dx++) {
                    if (!dx && !dy)
                        goto done;
                    s += d->ar_coeffs_y[ci++] *
                         buf[(y + dy) * GRAIN_W + (x + dx)];
                }
        done:;
            const int g = buf[y * GRAIN_W + x] +
                          round2(s, d->ar_coeff_shift);
            buf[y * GRAIN_W + x] = fg_clip(g, gmin, gmax);
        }
}

void dtpu_fg_gen_uv(const DtpuFgData *d, const int16_t *gauss,
                    const int32_t *buf_y, int uv, int subx, int suby,
                    int bitdepth, int32_t *buf)
{
    const int bdm8 = bitdepth - 8;
    uint32_t state = (uint32_t)d->seed ^ (uv ? 0x49D8u : 0xB524u);
    const int shift = 4 - bdm8 + d->grain_scale_shift;
    const int grain_ctr = 128 << bdm8;
    const int gmin = -grain_ctr, gmax = grain_ctr - 1;
    const int ch_w = subx ? SUB_GRAIN_W : GRAIN_W;
    const int ch_h = suby ? SUB_GRAIN_H : GRAIN_H;

    for (int i = 0; i < (GRAIN_H + 1) * GRAIN_W; i++)
        buf[i] = 0;
    for (int y = 0; y < ch_h; y++)
        for (int x = 0; x < ch_w; x++)
            buf[y * GRAIN_W + x] =
                round2(gauss[fg_rand(&state, 11)], shift);

    const int lag = d->ar_coeff_lag;
    const int32_t *coeffs = d->ar_coeffs_uv[uv];
    for (int y = 3; y < ch_h; y++)
        for (int x = 3; x < ch_w - 3; x++) {
            int s = 0, ci = 0;
            for (int dy = -lag; dy <= 0; dy++)
                for (int dx = -lag; dx <= lag; dx++) {
                    if (!dx && !dy) {
                        if (d->num_y_points) {
                            int luma = 0;
                            const int lx = ((x - 3) << subx) + 3;
                            const int ly = ((y - 3) << suby) + 3;
                            for (int i = 0; i <= suby; i++)
                                for (int j = 0; j <= subx; j++)
                                    luma += buf_y[(ly + i) * GRAIN_W +
                                                  (lx + j)];
                            luma = round2(luma, subx + suby);
                            s += luma * coeffs[ci];
                        }
                        goto done;
                    }
                    s += coeffs[ci++] * buf[(y + dy) * GRAIN_W + (x + dx)];
                }
        done:;
            const int g = buf[y * GRAIN_W + x] +
                          round2(s, d->ar_coeff_shift);
            buf[y * GRAIN_W + x] = fg_clip(g, gmin, gmax);
        }
}

void dtpu_fg_scaling(int bitdepth, const uint8_t *points /* n x 2 */,
                     int num, int32_t *out /* 1 << bitdepth */)
{
    const int shift_x = bitdepth - 8;
    const int size = 1 << bitdepth;
    for (int i = 0; i < size; i++)
        out[i] = 0;
    if (!num)
        return;
    for (int i = 0; i < points[0] << shift_x; i++)
        out[i] = points[1];
    for (int i = 0; i < num - 1; i++) {
        const int bx = points[i * 2], by = points[i * 2 + 1];
        const int ex = points[i * 2 + 2], ey = points[i * 2 + 3];
        const int dx = ex - bx, dy = ey - by;
        const int delta = dy * ((0x10000 + (dx >> 1)) / dx);
        int dd = 0x8000;
        for (int x = 0; x < dx; x++) {
            out[(bx + x) << shift_x] = by + (dd >> 16);
            dd += delta;
        }
    }
    for (int i = points[(num - 1) * 2] << shift_x; i < size; i++)
        out[i] = points[(num - 1) * 2 + 1];
    if (shift_x) {
        const int pad = 1 << shift_x, rnd = pad >> 1;
        for (int i = 0; i < num - 1; i++) {
            const int bx = points[i * 2] << shift_x;
            const int ex = points[(i + 1) * 2] << shift_x;
            for (int x = 0; x < ex - bx; x += pad) {
                const int rng = out[bx + x + pad] - out[bx + x];
                int r = rnd;
                for (int k = 1; k < pad; k++) {
                    r += rng;
                    out[bx + x + k] = out[bx + x] + (r >> shift_x);
                }
            }
        }
    }
}

/* per-block-row grain offsets (reference seed/offsets shifting) */
static void fg_row_offsets(const DtpuFgData *d, int row_num, int n_blocks,
                           int rows, uint8_t offs[][2])
{
    uint32_t states[2];
    for (int i = 0; i < rows; i++) {
        uint32_t s = (uint32_t)d->seed;
        s ^= (uint32_t)((((row_num - i) * 37 + 178) & 0xFF) << 8);
        s ^= (uint32_t)(((row_num - i) * 173 + 105) & 0xFF);
        states[i] = s;
    }
    for (int b = 0; b < n_blocks; b++)
        for (int i = 0; i < rows; i++)
            offs[b][i] = (uint8_t)fg_rand(&states[i], 8);
}

static const int fg_w_sub[2][2][2] = {
    {{27, 17}, {17, 27}},  /* subx/suby = 0 */
    {{23, 22}, {0, 0}},    /* subx/suby = 1 */
};

static inline const int32_t *fg_lut_at(const int32_t *lut, int randval,
                                       int subx, int suby, int bx_sel,
                                       int by_sel)
{
    int offx = 3 + (2 >> subx) * (3 + (randval >> 4));
    int offy = 3 + (2 >> suby) * (3 + (randval & 0xF));
    offx += (FG_BLOCK >> subx) * bx_sel;
    offy += (FG_BLOCK >> suby) * by_sel;
    return lut + offy * GRAIN_W + offx;
}

/* assemble one block's blended grain slab (reference sample_lut +
 * overlap blending) into g[bh][FG_BLOCK] */
static void fg_block_grain(const DtpuFgData *d, const int32_t *lut,
                           const uint8_t offs[][2], int bi, int bw, int bh,
                           int subx, int suby, int xstart, int ystart,
                           int gmin, int gmax, int32_t g[][FG_BLOCK])
{
    const int32_t *src = fg_lut_at(lut, offs[bi][0], subx, suby, 0, 0);
    for (int y = 0; y < bh; y++)
        for (int x = 0; x < bw; x++)
            g[y][x] = src[y * GRAIN_W + x];
    if (xstart) {
        const int32_t *old =
            fg_lut_at(lut, offs[bi - 1][0], subx, suby, 1, 0);
        for (int x = 0; x < xstart; x++) {
            const int w0 = fg_w_sub[subx][x][0], w1 = fg_w_sub[subx][x][1];
            for (int y = 0; y < bh; y++)
                g[y][x] = fg_clip(
                    round2(old[y * GRAIN_W + x] * w0 + g[y][x] * w1, 5),
                    gmin, gmax);
        }
    }
    if (ystart) {
        const int32_t *top = fg_lut_at(lut, offs[bi][1], subx, suby, 0, 1);
        int32_t t[2][FG_BLOCK];
        for (int y = 0; y < ystart; y++)
            for (int x = 0; x < bw; x++)
                t[y][x] = top[y * GRAIN_W + x];
        if (xstart) {
            const int32_t *told =
                fg_lut_at(lut, offs[bi - 1][1], subx, suby, 1, 1);
            for (int x = 0; x < xstart; x++) {
                const int w0 = fg_w_sub[subx][x][0],
                          w1 = fg_w_sub[subx][x][1];
                for (int y = 0; y < ystart; y++)
                    t[y][x] = fg_clip(
                        round2(told[y * GRAIN_W + x] * w0 + t[y][x] * w1,
                               5), gmin, gmax);
            }
        }
        for (int y = 0; y < ystart; y++) {
            const int w0 = fg_w_sub[suby][y][0], w1 = fg_w_sub[suby][y][1];
            for (int x = 0; x < bw; x++)
                g[y][x] = fg_clip(round2(t[y][x] * w0 + g[y][x] * w1, 5),
                                  gmin, gmax);
        }
    }
}

/* Apply grain to one plane in place.  pl 0: luma (lumap unused); pl 1/2:
 * chroma, lumap/lstride give the still-pristine luma plane and lw its
 * width (odd-width edge clamp).  w/h are THIS plane's cropped dims. */
int dtpu_fg_apply_plane(int32_t *plane, int64_t stride,
                         const int32_t *lumap, int64_t lstride, int lw,
                         int pl, int w, int h, int subx, int suby,
                         const int32_t *lut, const int32_t *sc,
                         const DtpuFgData *d, int bitdepth, int is_id)
{
    const int bdm8 = bitdepth - 8;
    const int grain_ctr = 128 << bdm8;
    const int gmin = -grain_ctr, gmax = grain_ctr - 1;
    const int maxbd = (1 << bitdepth) - 1;
    int min_v, max_v;
    if (d->clip_to_restricted_range) {
        min_v = 16 << bdm8;
        max_v = pl == 0 ? 235 << bdm8 : (is_id ? 235 : 240) << bdm8;
    } else {
        min_v = 0;
        max_v = maxbd;
    }
    const int csfl = pl > 0 && d->chroma_scaling_from_luma;
    const int bsz = FG_BLOCK >> subx;
    const int bszy = FG_BLOCK >> suby;
    const int n_blocks = (w + bsz - 1) / bsz;
    const int n_rows = ((h << suby) + FG_BLOCK - 1) / FG_BLOCK;
    const int uv = pl - 1;

    uint8_t (*offs)[2] = malloc(sizeof(*offs) * (size_t)n_blocks);
    if (!offs)
        return 0;  /* caller falls back to the Python path */
    for (int row = 0; row < n_rows; row++) {
        const int y0 = row * bszy;
        const int bh = h - y0 < bszy ? h - y0 : bszy;
        const int rows = 1 + (d->overlap_flag && row > 0);
        fg_row_offsets(d, row, n_blocks, rows, offs);
        const int ystart =
            (d->overlap_flag && row) ? ((2 >> suby) < bh ? (2 >> suby) : bh)
                                     : 0;
        for (int bi = 0; bi < n_blocks; bi++) {
            const int bx = bi * bsz;
            const int bw = w - bx < bsz ? w - bx : bsz;
            const int xstart =
                (d->overlap_flag && bx)
                    ? ((2 >> subx) < bw ? (2 >> subx) : bw)
                    : 0;
            int32_t g[FG_BLOCK][FG_BLOCK];
            fg_block_grain(d, lut, offs, bi, bw, bh, subx, suby, xstart,
                           ystart, gmin, gmax, g);
            for (int y = 0; y < bh; y++) {
                int32_t *prow = plane + (int64_t)(y0 + y) * stride + bx;
                if (pl == 0) {
                    for (int x = 0; x < bw; x++) {
                        const int src = prow[x];
                        const int noise =
                            round2(sc[src] * g[y][x], d->scaling_shift);
                        prow[x] = fg_clip(src + noise, min_v, max_v);
                    }
                } else {
                    const int32_t *l0 = lumap +
                        (int64_t)((y0 + y) << suby) * lstride;
                    for (int x = 0; x < bw; x++) {
                        const int cx = bx + x;
                        int avg;
                        if (subx) {
                            const int lx0 = cx * 2;
                            const int lx1 =
                                lx0 + 1 < lw ? lx0 + 1 : lw - 1;
                            avg = (l0[lx0] + l0[lx1] + 1) >> 1;
                        } else {
                            avg = l0[cx];
                        }
                        const int src = prow[x];
                        int val;
                        if (csfl) {
                            val = avg;
                        } else {
                            const int comb = avg * d->uv_luma_mult[uv] +
                                             src * d->uv_mult[uv];
                            val = fg_clip((comb >> 6) +
                                          d->uv_offset[uv] * (1 << bdm8),
                                          0, maxbd);
                        }
                        const int noise =
                            round2(sc[val] * g[y][x], d->scaling_shift);
                        prow[x] = fg_clip(src + noise, min_v, max_v);
                    }
                }
            }
        }
    }
    free(offs);
    return 1;
}
