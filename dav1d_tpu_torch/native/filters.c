/* Native host filter kernels.
 *
 * Batched CDEF unit filtering, bit-identical to the golden numpy model
 * (dav1d_tpu/recon/cdef.py cdef_filter_batch, itself oracle-verified
 * against reference src/cdef_tmpl.c:106 cdef_filter_block_c). The host
 * runs this when the device batch would be dispatch/transfer-bound; the
 * TPU path is dav1d_tpu/ops/cdef.py.
 */

#include <stdint.h>
#include <stddef.h>
#include <stdlib.h>
#include <string.h>

#ifdef __AVX512F__
#include <immintrin.h>
#endif

void dtpu_cdef_filter_plane(int32_t *plane, int64_t stride, int pw, int ph,
                            int32_t *canvas, const int64_t *ys,
                            const int64_t *xs, int64_t n, int w, int h,
                            const int64_t *pri, const int64_t *sec,
                            const int64_t *dirs, int damping, int bitdepth);

#define CDEF_SENTINEL (-32768) /* INT16_MIN marker outside available edges */

/* (dy, dx) per [2 + dir + off][pass] (decomposition of the reference's
 * dav1d_cdef_directions offsets, src/tables.c:400) */
static const int cdef_dirs[12][2][2] = {
    {{ 1, 0}, { 2,  0}},
    {{ 1, 0}, { 2, -1}},
    {{-1, 1}, {-2,  2}},
    {{ 0, 1}, {-1,  2}},
    {{ 0, 1}, { 0,  2}},
    {{ 0, 1}, { 1,  2}},
    {{ 1, 1}, { 2,  2}},
    {{ 1, 0}, { 2,  1}},
    {{ 1, 0}, { 2,  0}},
    {{ 1, 0}, { 2, -1}},
    {{-1, 1}, {-2,  2}},
    {{ 0, 1}, {-1,  2}},
};

static inline int ulog2i(int v) { return 31 - __builtin_clz((unsigned)v); }
static inline int imini(int a, int b) { return a < b ? a : b; }

static inline int constrain(int diff, int thr, int shift)
{
    int adiff = diff < 0 ? -diff : diff;
    int clamp = thr - (adiff >> shift);
    int v = adiff < clamp ? adiff : clamp;
    if (v < 0)
        v = 0;
    return diff < 0 ? -v : v;
}

static inline int clampi(int v, int lo, int hi)
{
    return v < lo ? lo : v > hi ? hi : v;
}

/* ---- intra prediction ---------------------------------------------------
 * Port of the golden model dav1d_tpu/recon/ipred.py (reference DSP family
 * src/ipred_tmpl.c:40-744). The edge buffer is laid out as there: edge[ofs]
 * is the top-left pixel, top row at ofs+1.., left column mirrored below
 * (left[i] = edge[ofs-1-i]). Implementation-mode numbering matches
 * dav1d_tpu.levels (DC=0 V=1 H=2 LEFT_DC=3 TOP_DC=4 DC128=5 Z1=6 Z2=7 Z3=8
 * SMOOTH=9 SM_V=10 SM_H=11 PAETH=12 FILTER=13). */

static int get_filter_strength(int wh, int angle, int is_sm)
{
    if (is_sm) {
        if (wh <= 8) {
            if (angle >= 64) return 2;
            if (angle >= 40) return 1;
        } else if (wh <= 16) {
            if (angle >= 48) return 2;
            if (angle >= 20) return 1;
        } else if (wh <= 24) {
            if (angle >= 4) return 3;
        } else {
            return 3;
        }
    } else {
        if (wh <= 8) {
            if (angle >= 56) return 1;
        } else if (wh <= 16) {
            if (angle >= 40) return 1;
        } else if (wh <= 24) {
            if (angle >= 32) return 3;
            if (angle >= 16) return 2;
            if (angle >= 8) return 1;
        } else if (wh <= 32) {
            if (angle >= 32) return 3;
            if (angle >= 4) return 2;
            return 1;
        } else {
            return 3;
        }
    }
    return 0;
}

static const int edge_kernels[3][5] = {
    {0, 4, 8, 4, 0}, {0, 5, 6, 5, 0}, {2, 4, 4, 4, 2}};

/* out[i] for i in [0, sz): filtered edge (reference filter_edge). inp is
 * indexed inp[base + clamp(i, frm, to-1)]. */
static void filter_edge_c(int64_t *out, int sz, int lim_from, int lim_to,
                          const int64_t *inp, int base, int frm, int to,
                          int strength)
{
    const int *k = edge_kernels[strength - 1];
    for (int i = 0; i < sz; i++) {
        if (i < (sz < lim_from ? sz : lim_from) ||
            i >= (lim_to < sz ? lim_to : sz)) {
            out[i] = inp[base + clampi(i, frm, to - 1)];
        } else {
            int64_t s = 0;
            for (int j = 0; j < 5; j++)
                s += inp[base + clampi(i - 2 + j, frm, to - 1)] * k[j];
            out[i] = (s + 8) >> 4;
        }
    }
}

static int get_upsample(int wh, int angle, int is_sm)
{
    return angle < 40 && wh <= (16 >> is_sm);
}

/* out[0 .. 2*hsz-2]: upsampled edge (reference upsample_edge). */
static void upsample_edge_c(int64_t *out, int hsz, const int64_t *inp,
                            int base, int frm, int to, int maxp)
{
    for (int i = 0; i < hsz - 1; i++) {
        out[i * 2] = inp[base + clampi(i, frm, to - 1)];
        int64_t s = -inp[base + clampi(i - 1, frm, to - 1)] +
                    9 * inp[base + clampi(i, frm, to - 1)] +
                    9 * inp[base + clampi(i + 1, frm, to - 1)] -
                    inp[base + clampi(i + 2, frm, to - 1)];
        out[i * 2 + 1] = clampi((int)((s + 8) >> 4), 0, maxp);
    }
    out[(hsz - 1) * 2] = inp[base + clampi(hsz - 1, frm, to - 1)];
}

void dtpu_ipred(int mode, const int32_t *edge, int ofs, int width,
                int height, int angle_in, int max_w, int max_h,
                int bitdepth, const uint8_t *sm_weights,
                const uint16_t *dr_deriv, const int8_t *filter_taps,
                int32_t *out, int64_t ostride)
{
    const int half = (1 << bitdepth) >> 1;
    const int maxp = (1 << bitdepth) - 1;
    const int32_t *top = edge + ofs + 1;
    /* left[i] = edge[ofs - 1 - i] */

    switch (mode) {
    case 0: case 3: case 4: case 5: { /* DC family */
        int64_t dc;
        if (mode == 5) {
            dc = half;
        } else if (mode == 4) { /* TOP_DC */
            dc = width >> 1;
            for (int i = 0; i < width; i++)
                dc += top[i];
            dc >>= 31 - __builtin_clz((unsigned)width);
        } else if (mode == 3) { /* LEFT_DC */
            dc = height >> 1;
            for (int i = 0; i < height; i++)
                dc += edge[ofs - 1 - i];
            dc >>= 31 - __builtin_clz((unsigned)height);
        } else {
            dc = (width + height) >> 1;
            for (int i = 0; i < width; i++)
                dc += top[i];
            for (int i = 0; i < height; i++)
                dc += edge[ofs - 1 - i];
            dc >>= __builtin_ctz((unsigned)(width + height));
            if (width != height) {
                if (width > height * 2 || height > width * 2)
                    dc = bitdepth == 8 ? (dc * 0x3334) >> 16
                                       : (dc * 0x6667) >> 17;
                else
                    dc = bitdepth == 8 ? (dc * 0x5556) >> 16
                                       : (dc * 0xAAAB) >> 17;
            }
        }
        for (int y = 0; y < height; y++)
            for (int x = 0; x < width; x++)
                out[(size_t)y * ostride + x] = (int32_t)dc;
        return;
    }
    case 1: /* VERT */
        for (int y = 0; y < height; y++)
            for (int x = 0; x < width; x++)
                out[(size_t)y * ostride + x] = top[x];
        return;
    case 2: /* HOR */
        for (int y = 0; y < height; y++) {
            const int32_t l = edge[ofs - 1 - y];
            for (int x = 0; x < width; x++)
                out[(size_t)y * ostride + x] = l;
        }
        return;
    case 12: { /* PAETH */
        const int tl = edge[ofs];
        for (int y = 0; y < height; y++) {
            const int l = edge[ofs - 1 - y];
            for (int x = 0; x < width; x++) {
                const int t = top[x];
                const int base = l + t - tl;
                const int ld = base > l ? base - l : l - base;
                const int td = base > t ? base - t : t - base;
                const int tld = base > tl ? base - tl : tl - base;
                out[(size_t)y * ostride + x] =
                    (ld <= td && ld <= tld) ? l : (td <= tld ? t : tl);
            }
        }
        return;
    }
    case 9: { /* SMOOTH */
        const uint8_t *wh_ = sm_weights + width;
        const uint8_t *wv = sm_weights + height;
        const int right = top[width - 1] /* edge[ofs+width] */;
        const int bottom = edge[ofs - height];
        /* int32 is exact: each term <= 256 * 4095, sum < 2^23 —
         * and lets the auto-vectorizer take the inner loop */
        for (int y = 0; y < height; y++) {
            const int32_t vt = wv[y], vb = 256 - wv[y];
            const int32_t l = edge[ofs - 1 - y];
            for (int x = 0; x < width; x++) {
                const int32_t p = vt * top[x] + vb * bottom +
                                  (int32_t)wh_[x] * l +
                                  (256 - (int32_t)wh_[x]) * right;
                out[(size_t)y * ostride + x] = (p + 256) >> 9;
            }
        }
        return;
    }
    case 10: { /* SMOOTH_V */
        const uint8_t *wv = sm_weights + height;
        const int bottom = edge[ofs - height];
        for (int y = 0; y < height; y++) {
            const int32_t vt = wv[y], vb = (256 - wv[y]) * bottom + 128;
            for (int x = 0; x < width; x++)
                out[(size_t)y * ostride + x] =
                    (vt * top[x] + vb) >> 8;
        }
        return;
    }
    case 11: { /* SMOOTH_H */
        const uint8_t *wh_ = sm_weights + width;
        const int right = top[width - 1];
        for (int y = 0; y < height; y++) {
            const int32_t l = edge[ofs - 1 - y];
            for (int x = 0; x < width; x++)
                out[(size_t)y * ostride + x] =
                    ((int32_t)wh_[x] * l +
                     (256 - (int32_t)wh_[x]) * right + 128) >> 8;
        }
        return;
    }
    case 6: { /* Z1 */
        const int is_sm = (angle_in >> 9) & 1;
        const int en_filter = angle_in >> 10;
        const int angle = angle_in & 511;
        int dx = dr_deriv[angle >> 1];
        int64_t top_in[129], filt[258];
        const int64_t *t;
        int max_base_x;
        for (int i = 0; i <= width + height; i++)
            top_in[i] = edge[ofs + i]; /* [0] = topleft */
        const int upsample_above =
            en_filter ? get_upsample(width + height, 90 - angle, is_sm) : 0;
        if (upsample_above) {
            upsample_edge_c(filt, width + height, top_in, 1, -1,
                            width + (width < height ? width : height),
                            maxp);
            t = filt;
            max_base_x = 2 * (width + height) - 2;
            dx <<= 1;
        } else {
            const int strength =
                en_filter
                    ? get_filter_strength(width + height, 90 - angle, is_sm)
                    : 0;
            if (strength) {
                filter_edge_c(filt, width + height, 0, width + height,
                              top_in, 1, -1,
                              width + (width < height ? width : height),
                              strength);
                t = filt;
                max_base_x = width + height - 1;
            } else {
                t = top_in + 1;
                max_base_x =
                    width + (width < height ? width : height) - 1;
            }
        }
        const int base_inc = 1 + upsample_above;
        for (int y = 0; y < height; y++) {
            const int xpos = dx * (y + 1);
            const int frac = xpos & 0x3E;
            for (int x = 0; x < width; x++) {
                const int base = (xpos >> 6) + base_inc * x;
                if (base < max_base_x) {
                    int64_t v = t[base] * (64 - frac) + t[base + 1] * frac;
                    out[(size_t)y * ostride + x] = (int32_t)((v + 32) >> 6);
                } else {
                    for (int xx = x; xx < width; xx++)
                        out[(size_t)y * ostride + xx] = (int32_t)t[max_base_x];
                    break;
                }
            }
        }
        return;
    }
    case 7: { /* Z2 */
        const int is_sm = (angle_in >> 9) & 1;
        const int en_filter = angle_in >> 10;
        const int angle = angle_in & 511;
        int dy = dr_deriv[(angle - 90) >> 1];
        int dx = dr_deriv[(180 - angle) >> 1];
        const int upsample_left =
            en_filter ? get_upsample(width + height, 180 - angle, is_sm)
                      : 0;
        const int upsample_above =
            en_filter ? get_upsample(width + height, angle - 90, is_sm) : 0;
        int64_t buf[129];
        const int tl = 64;
        int64_t top_in[65], left_in[65];
        for (int i = 0; i <= width; i++)
            top_in[i] = edge[ofs + i]; /* [0] = topleft */
        for (int i = 0; i <= height; i++)
            left_in[i] = edge[ofs - height + i]; /* [height] = topleft */
        for (int i = 0; i < 129; i++)
            buf[i] = 0;
        if (upsample_above) {
            upsample_edge_c(buf + tl, width + 1, top_in, 0, 0, width + 1,
                            maxp);
            dx <<= 1;
        } else {
            const int strength =
                en_filter
                    ? get_filter_strength(width + height, angle - 90, is_sm)
                    : 0;
            if (strength)
                filter_edge_c(buf + tl + 1, width, 0, max_w, top_in, 1, -1,
                              width, strength);
            else
                for (int i = 0; i < width; i++)
                    buf[tl + 1 + i] = top_in[1 + i];
        }
        if (upsample_left) {
            upsample_edge_c(buf + tl - height * 2, height + 1, left_in, 0,
                            0, height + 1, maxp);
            dy <<= 1;
        } else {
            const int strength =
                en_filter ? get_filter_strength(width + height, 180 - angle,
                                                is_sm)
                          : 0;
            if (strength)
                filter_edge_c(buf + tl - height, height, height - max_h,
                              height, left_in, 0, 0, height + 1, strength);
            else
                for (int i = 0; i < height; i++)
                    buf[tl - height + i] = left_in[i];
        }
        buf[tl] = edge[ofs];
        const int base_inc_x = 1 + upsample_above;
        const int left_base = tl - (1 + upsample_left);
        for (int y = 0; y < height; y++) {
            const int xpos = ((1 + upsample_above) << 6) - dx * (y + 1);
            const int base_x0 = xpos >> 6;
            const int frac_x = xpos & 0x3E;
            int ypos = (y << (6 + upsample_left)) - dy;
            for (int x = 0; x < width; x++) {
                const int base_x = base_x0 + base_inc_x * x;
                int64_t v;
                if (base_x >= 0) {
                    v = buf[tl + base_x] * (64 - frac_x) +
                        buf[tl + base_x + 1] * frac_x;
                } else {
                    const int base_y = ypos >> 6;
                    const int frac_y = ypos & 0x3E;
                    v = buf[left_base - base_y] * (64 - frac_y) +
                        buf[left_base - (base_y + 1)] * frac_y;
                }
                out[(size_t)y * ostride + x] = (int32_t)((v + 32) >> 6);
                ypos -= dy;
            }
        }
        return;
    }
    case 8: { /* Z3 */
        const int is_sm = (angle_in >> 9) & 1;
        const int en_filter = angle_in >> 10;
        const int angle = angle_in & 511;
        int dy = dr_deriv[(270 - angle) >> 1];
        const int n = width + height;
        const int upsample_left =
            en_filter ? get_upsample(n, angle - 180, is_sm) : 0;
        int64_t lo[129], filt[258];
        const int64_t *left_vec;
        int left_top, max_base_y;
        for (int i = 0; i <= n; i++)
            lo[i] = edge[ofs - n + i]; /* lo[n] = topleft */
        const int frm = width - height > 0 ? width - height : 0;
        if (upsample_left) {
            upsample_edge_c(filt, n, lo, 0, frm, n + 1, maxp);
            left_vec = filt;
            left_top = 2 * n - 2;
            max_base_y = 2 * n - 2;
            dy <<= 1;
        } else {
            const int strength =
                en_filter ? get_filter_strength(n, angle - 180, is_sm) : 0;
            if (strength) {
                filter_edge_c(filt, n, 0, n, lo, 0, frm, n + 1, strength);
                left_vec = filt;
                left_top = n - 1;
                max_base_y = n - 1;
            } else {
                left_vec = lo;
                left_top = n - 1; /* lo[n-1] = topleft_in[-1] */
                max_base_y =
                    height + (width < height ? width : height) - 1;
            }
        }
        const int base_inc = 1 + upsample_left;
        for (int x = 0; x < width; x++) {
            const int ypos = dy * (x + 1);
            const int frac = ypos & 0x3E;
            int base = ypos >> 6;
            for (int y = 0; y < height; y++) {
                if (base < max_base_y) {
                    int64_t v = left_vec[left_top - base] * (64 - frac) +
                                left_vec[left_top - (base + 1)] * frac;
                    out[(size_t)y * ostride + x] = (int32_t)((v + 32) >> 6);
                } else {
                    for (int yy = y; yy < height; yy++)
                        out[(size_t)yy * ostride + x] =
                            (int32_t)left_vec[left_top - max_base_y];
                    break;
                }
                base += base_inc;
            }
        }
        return;
    }
    case 13: { /* FILTER (up to 32x32) */
        const int filt_idx = angle_in & 511;
        const int8_t *flt = filter_taps + filt_idx * 64;
        int32_t canvas[33][33];
        canvas[0][0] = edge[ofs];
        for (int i = 0; i < width; i++)
            canvas[0][1 + i] = top[i];
        for (int i = 0; i < height; i++)
            canvas[1 + i][0] = edge[ofs - 1 - i];
        for (int y = 0; y < height; y += 2)
            for (int x = 0; x < width; x += 4) {
                const int p0 = canvas[y][x];
                const int p1 = canvas[y][x + 1], p2 = canvas[y][x + 2];
                const int p3 = canvas[y][x + 3], p4 = canvas[y][x + 4];
                const int p5 = canvas[y + 1][x];
                const int p6 = canvas[y + 2][x];
                for (int yy = 0; yy < 2; yy++)
                    for (int xx = 0; xx < 4; xx++) {
                        const int fi = xx + yy * 4;
                        const int acc =
                            flt[fi] * p0 + flt[fi + 8] * p1 +
                            flt[fi + 16] * p2 + flt[fi + 24] * p3 +
                            flt[fi + 32] * p4 + flt[fi + 40] * p5 +
                            flt[fi + 48] * p6;
                        canvas[y + 1 + yy][x + 1 + xx] =
                            clampi((acc + 8) >> 4, 0, maxp);
                    }
            }
        for (int y = 0; y < height; y++)
            for (int x = 0; x < width; x++)
                out[(size_t)y * ostride + x] = canvas[1 + y][1 + x];
        return;
    }
    }
}

/* 8-tap subpel MC for one block, put (clipped pixels) or prep
 * (intermediates minus prep_bias) — semantics of the golden model
 * dav1d_tpu/recon/mc_np.py put_8tap/prep_8tap (reference put_8tap_c,
 * src/mc_tmpl.c:130). Edge replication via clamped gather (emu_edge).
 * fh/fv: 8-tap int64 rows or NULL. */
#if defined(__AVX512BW__) && defined(__AVX512VL__)
/* Interior 2-D 8-tap via int16 pair-madd (the dav1d asm formulation,
 * re-derived for AVX-512VL intrinsics; reference src/x86/mc16_avx2.asm
 * idea only — code written from the arithmetic):
 *   - the int32 source window converts once into a padded int16 copy
 *   - H pass: 4 pmaddwd tap-pairs per 16 mids, unpack(src[x+k],
 *     src[x+k+1]) producing pair lanes; packs_epi32 of the lo/hi
 *     accumulators restores column order exactly
 *   - V pass: same pair trick over mid rows, permute2x128 re-orders
 *   - masked tail stores; over-compute runs into own scratch padding
 * Mids fit int16 for every bitdepth: |acc_h| <= maxp * sum|f| with the
 * (6-ib) shift scaling it back to ~2^13.5 (ib=4/2/0 at 8/10/12-bit).
 * Single-threaded scratch: pass 2 runs on one host thread (see s_tmp0
 * in replay_inter.c). */
static int16_t mc_src16[135 * 152];
static int16_t mc_mid16[135 * 144];

static void put_8tap_hv_madd(const int32_t *restrict plane, int64_t stride,
                             int dy, int dx, int w, int h,
                             const int64_t *fh, const int64_t *fv,
                             int ib, int maxp, int prep, int prep_bias,
                             int32_t *restrict out, int64_t ostride)
{
    const int sstride = 152, mstride = 144;
    const int win = w + 7;

    /* stage 1: int32 window -> int16 copy (masked tail load: lanes
     * beyond the interior guarantee never touch memory) */
    const int full = win >> 4, rem = win & 15;
    const __mmask16 tmask = (__mmask16)((1u << rem) - 1);
    for (int y = 0; y < h + 7; y++) {
        const int32_t *row = plane + (int64_t)(dy - 3 + y) * stride + (dx - 3);
        int16_t *srow = mc_src16 + y * sstride;
        int x = 0;
        for (; x < full * 16; x += 16)
            _mm256_storeu_si256((__m256i *)(srow + x),
                _mm512_cvtepi32_epi16(_mm512_loadu_si512(row + x)));
        if (rem)
            _mm256_storeu_si256((__m256i *)(srow + x),
                _mm512_cvtepi32_epi16(
                    _mm512_maskz_loadu_epi32(tmask, row + x)));
    }

    /* broadcast tap pairs (f[k], f[k+1]) as packed int16x2 */
    __m256i hp[4], vp[4];
    for (int k = 0; k < 4; k++) {
        hp[k] = _mm256_set1_epi32((int32_t)(
            (uint32_t)(uint16_t)(int16_t)fh[2 * k] |
            ((uint32_t)(uint16_t)(int16_t)fh[2 * k + 1] << 16)));
        vp[k] = _mm256_set1_epi32((int32_t)(
            (uint32_t)(uint16_t)(int16_t)fv[2 * k] |
            ((uint32_t)(uint16_t)(int16_t)fv[2 * k + 1] << 16)));
    }

    /* stage 2: H pass, 16 mids per iteration */
    const __m256i rnd_h = _mm256_set1_epi32((1 << (6 - ib)) >> 1);
    const int sh_h = 6 - ib;
    for (int y = 0; y < h + 7; y++) {
        const int16_t *srow = mc_src16 + y * sstride;
        int16_t *mrow = mc_mid16 + y * mstride;
        for (int x = 0; x < w; x += 16) {
            __m256i alo = _mm256_setzero_si256(), ahi = alo;
            for (int k = 0; k < 4; k++) {
                const __m256i a = _mm256_loadu_si256(
                    (const __m256i *)(srow + x + 2 * k));
                const __m256i b = _mm256_loadu_si256(
                    (const __m256i *)(srow + x + 2 * k + 1));
                alo = _mm256_add_epi32(alo, _mm256_madd_epi16(
                    _mm256_unpacklo_epi16(a, b), hp[k]));
                ahi = _mm256_add_epi32(ahi, _mm256_madd_epi16(
                    _mm256_unpackhi_epi16(a, b), hp[k]));
            }
            alo = _mm256_srai_epi32(_mm256_add_epi32(alo, rnd_h), sh_h);
            ahi = _mm256_srai_epi32(_mm256_add_epi32(ahi, rnd_h), sh_h);
            /* packs per 128-lane = (lo0..3, hi0..3 | lo4..7, hi4..7)
             * = columns x..x+15 in order */
            _mm256_storeu_si256((__m256i *)(mrow + x),
                                _mm256_packs_epi32(alo, ahi));
        }
    }

    /* stage 3: V pass */
    const __m256i rnd_v =
        _mm256_set1_epi32(prep ? 32 : ((1 << (6 + ib)) >> 1));
    const int sh_v = prep ? 6 : (6 + ib);
    const __m256i bias = _mm256_set1_epi32(prep ? prep_bias : 0);
    const __m256i vmax = _mm256_set1_epi32(maxp);
    const __m256i vzero = _mm256_setzero_si256();
    for (int y = 0; y < h; y++) {
        const int16_t *m0 = mc_mid16 + y * mstride;
        int32_t *orow = out + (int64_t)y * ostride;
        for (int x = 0; x < w; x += 16) {
            __m256i alo = _mm256_setzero_si256(), ahi = alo;
            for (int k = 0; k < 4; k++) {
                const __m256i a = _mm256_loadu_si256(
                    (const __m256i *)(m0 + (2 * k) * mstride + x));
                const __m256i b = _mm256_loadu_si256(
                    (const __m256i *)(m0 + (2 * k + 1) * mstride + x));
                alo = _mm256_add_epi32(alo, _mm256_madd_epi16(
                    _mm256_unpacklo_epi16(a, b), vp[k]));
                ahi = _mm256_add_epi32(ahi, _mm256_madd_epi16(
                    _mm256_unpackhi_epi16(a, b), vp[k]));
            }
            alo = _mm256_srai_epi32(_mm256_add_epi32(alo, rnd_v), sh_v);
            ahi = _mm256_srai_epi32(_mm256_add_epi32(ahi, rnd_v), sh_v);
            if (prep) {
                alo = _mm256_sub_epi32(alo, bias);
                ahi = _mm256_sub_epi32(ahi, bias);
            } else {
                alo = _mm256_min_epi32(_mm256_max_epi32(alo, vzero), vmax);
                ahi = _mm256_min_epi32(_mm256_max_epi32(ahi, vzero), vmax);
            }
            /* lo holds columns (0..3, 8..11), hi (4..7, 12..15) */
            const __m256i o0 = _mm256_permute2x128_si256(alo, ahi, 0x20);
            const __m256i o1 = _mm256_permute2x128_si256(alo, ahi, 0x31);
            const int left = w - x;
            if (left >= 16) {
                _mm256_storeu_si256((__m256i *)(orow + x), o0);
                _mm256_storeu_si256((__m256i *)(orow + x + 8), o1);
            } else if (left >= 8) {
                _mm256_storeu_si256((__m256i *)(orow + x), o0);
                _mm256_mask_storeu_epi32(orow + x + 8,
                    (__mmask8)((1u << (left - 8)) - 1), o1);
            } else {
                _mm256_mask_storeu_epi32(orow + x,
                    (__mmask8)((1u << left) - 1), o0);
            }
        }
    }
}
#endif /* __AVX512BW__ && __AVX512VL__ */

static void put_8tap_core(const int32_t *restrict plane, int64_t stride,
                          int vw, int vh, int dy, int dx, int w, int h,
                          const int64_t *fh, const int64_t *fv, int ib,
                          int maxp, int prep, int prep_bias,
                          int32_t *restrict out, int64_t ostride)
{
    if (fh && fv) {
        /* int32 is ample: |px| <= 2^12, sum|f| <= ~2^8 -> horizontal
         * accs <= ~2^21, mids <= ~2^17, vertical accs <= ~2^26 */
        int32_t f_h[8], f_v[8];
        for (int t = 0; t < 8; t++) {
            f_h[t] = (int32_t)fh[t];
            f_v[t] = (int32_t)fv[t];
        }
        int32_t mid[135][128]; /* max h+7=135, max w=128 */
        const int rnd_h = (1 << (6 - ib)) >> 1;
        const int sh_h = 6 - ib;
        if (dy - 3 >= 0 && dy + h + 4 <= vh &&
            dx - 3 >= 0 && dx + w + 4 <= vw) {
#if defined(__AVX512BW__) && defined(__AVX512VL__)
            put_8tap_hv_madd(plane, stride, dy, dx, w, h, fh, fv, ib,
                             maxp, prep, prep_bias, out, ostride);
            return;
#endif
            /* interior fast path: no edge clamping, stride-1 reads */
            for (int y = 0; y < h + 7; y++) {
                const int32_t *restrict row =
                    plane + (int64_t)(dy - 3 + y) * stride + (dx - 3);
                int32_t *restrict m = mid[y];
                for (int x = 0; x < w; x++) {
                    int32_t acc = f_h[0] * row[x] + f_h[1] * row[x + 1] +
                                  f_h[2] * row[x + 2] +
                                  f_h[3] * row[x + 3] +
                                  f_h[4] * row[x + 4] +
                                  f_h[5] * row[x + 5] +
                                  f_h[6] * row[x + 6] +
                                  f_h[7] * row[x + 7];
                    m[x] = (acc + rnd_h) >> sh_h;
                }
            }
        } else {
            for (int y = 0; y < h + 7; y++) {
                const int32_t *row =
                    plane +
                    (int64_t)clampi(dy - 3 + y, 0, vh - 1) * stride;
                for (int x = 0; x < w; x++) {
                    int32_t acc = 0;
                    for (int t = 0; t < 8; t++)
                        acc += f_h[t] *
                               row[clampi(dx - 3 + x + t, 0, vw - 1)];
                    mid[y][x] = (acc + rnd_h) >> sh_h;
                }
            }
        }
        const int rnd_v = prep ? 32 : ((1 << (6 + ib)) >> 1);
        const int sh_v = prep ? 6 : (6 + ib);
        for (int y = 0; y < h; y++) {
            int32_t *restrict orow = out + (int64_t)y * ostride;
            const int32_t *restrict m0 = mid[y];
            const int32_t *restrict m1 = mid[y + 1];
            const int32_t *restrict m2 = mid[y + 2];
            const int32_t *restrict m3 = mid[y + 3];
            const int32_t *restrict m4 = mid[y + 4];
            const int32_t *restrict m5 = mid[y + 5];
            const int32_t *restrict m6 = mid[y + 6];
            const int32_t *restrict m7 = mid[y + 7];
            for (int x = 0; x < w; x++) {
                int32_t acc = f_v[0] * m0[x] + f_v[1] * m1[x] +
                              f_v[2] * m2[x] + f_v[3] * m3[x] +
                              f_v[4] * m4[x] + f_v[5] * m5[x] +
                              f_v[6] * m6[x] + f_v[7] * m7[x];
                const int v = (acc + rnd_v) >> sh_v;
                orow[x] = prep ? v - prep_bias : clampi(v, 0, maxp);
            }
        }
    } else if (fh) {
        int32_t f_h[8];
        for (int t = 0; t < 8; t++)
            f_h[t] = (int32_t)fh[t];
        const int rnd = prep ? ((1 << (6 - ib)) >> 1)
                             : 32 + ((1 << (6 - ib)) >> 1);
        const int sh = prep ? (6 - ib) : 6;
        const int inner = dx - 3 >= 0 && dx + w + 4 <= vw;
        for (int y = 0; y < h; y++) {
            const int32_t *row =
                plane + (int64_t)clampi(dy + y, 0, vh - 1) * stride;
            int32_t *restrict orow = out + (int64_t)y * ostride;
            if (inner) {
                const int32_t *restrict r = row + dx - 3;
                for (int x = 0; x < w; x++) {
                    int32_t acc = f_h[0] * r[x] + f_h[1] * r[x + 1] +
                                  f_h[2] * r[x + 2] + f_h[3] * r[x + 3] +
                                  f_h[4] * r[x + 4] + f_h[5] * r[x + 5] +
                                  f_h[6] * r[x + 6] + f_h[7] * r[x + 7];
                    const int v = (acc + rnd) >> sh;
                    orow[x] = prep ? v - prep_bias : clampi(v, 0, maxp);
                }
            } else {
                for (int x = 0; x < w; x++) {
                    int32_t acc = 0;
                    for (int t = 0; t < 8; t++)
                        acc += f_h[t] *
                               row[clampi(dx - 3 + x + t, 0, vw - 1)];
                    const int v = (acc + rnd) >> sh;
                    orow[x] = prep ? v - prep_bias : clampi(v, 0, maxp);
                }
            }
        }
    } else if (fv) {
        int32_t f_v[8];
        for (int t = 0; t < 8; t++)
            f_v[t] = (int32_t)fv[t];
        const int rnd = prep ? ((1 << (6 - ib)) >> 1) : 32;
        const int sh = prep ? (6 - ib) : 6;
        const int inner_x = dx >= 0 && dx + w <= vw;
        for (int y = 0; y < h; y++) {
            const int32_t *r[8];
            for (int t = 0; t < 8; t++)
                r[t] = plane +
                       (int64_t)clampi(dy - 3 + y + t, 0, vh - 1) * stride;
            int32_t *restrict orow = out + (int64_t)y * ostride;
            if (inner_x) {
                const int32_t *restrict r0 = r[0] + dx, *restrict r1 =
                    r[1] + dx, *restrict r2 = r[2] + dx, *restrict r3 =
                    r[3] + dx, *restrict r4 = r[4] + dx, *restrict r5 =
                    r[5] + dx, *restrict r6 = r[6] + dx, *restrict r7 =
                    r[7] + dx;
                for (int x = 0; x < w; x++) {
                    int32_t acc = f_v[0] * r0[x] + f_v[1] * r1[x] +
                                  f_v[2] * r2[x] + f_v[3] * r3[x] +
                                  f_v[4] * r4[x] + f_v[5] * r5[x] +
                                  f_v[6] * r6[x] + f_v[7] * r7[x];
                    const int v = (acc + rnd) >> sh;
                    orow[x] = prep ? v - prep_bias : clampi(v, 0, maxp);
                }
            } else {
                for (int x = 0; x < w; x++) {
                    const int ix = clampi(dx + x, 0, vw - 1);
                    int32_t acc = 0;
                    for (int t = 0; t < 8; t++)
                        acc += f_v[t] * r[t][ix];
                    const int v = (acc + rnd) >> sh;
                    orow[x] = prep ? v - prep_bias : clampi(v, 0, maxp);
                }
            }
        }
    } else {
        for (int y = 0; y < h; y++) {
            const int32_t *row =
                plane + (int64_t)clampi(dy + y, 0, vh - 1) * stride;
            for (int x = 0; x < w; x++) {
                const int v = row[clampi(dx + x, 0, vw - 1)];
                out[y * ostride + x] = prep ? (v << ib) - prep_bias : v;
            }
        }
    }
}

void dtpu_put_8tap(const int32_t *plane, int64_t stride, int vw, int vh,
                   int dy, int dx, int w, int h, const int64_t *fh,
                   const int64_t *fv, int ib, int maxp, int prep,
                   int prep_bias, int32_t *out)
{
    put_8tap_core(plane, stride, vw, vh, dy, dx, w, h, fh, fv, ib, maxp,
                  prep, prep_bias, out, w);
}

/* put straight into the destination plane (replay fast path: no
 * temporary block, no Python-side copy) */
void dtpu_put_8tap_into(const int32_t *plane, int64_t stride, int vw,
                        int vh, int dy, int dx, int w, int h,
                        const int64_t *fh, const int64_t *fv, int ib,
                        int maxp, int32_t *dst, int64_t dst_stride)
{
    put_8tap_core(plane, stride, vw, vh, dy, dx, w, h, fh, fv, ib, maxp,
                  0, 0, dst, dst_stride);
}

/* One warped 8x8 tile (golden model mc_np.warp8x8; reference
 * warp_affine_8x8_c / _8x8t_c, src/mc_tmpl.c). wf: (193, 8) int64. */
void dtpu_warp8x8(const int32_t *plane, int64_t stride, int vw, int vh,
                  int dy, int dx, const int32_t *abcd, int mx, int my,
                  int ib, int maxp, int prep, int prep_bias,
                  const int64_t *wf, int32_t *out)
{
    int32_t win[15][15];
    for (int y = 0; y < 15; y++) {
        const int32_t *row =
            plane + (int64_t)clampi(dy - 3 + y, 0, vh - 1) * stride;
        for (int x = 0; x < 15; x++)
            win[y][x] = row[clampi(dx - 3 + x, 0, vw - 1)];
    }
    int32_t mid[15][8];
    const int rnd_h = (1 << (7 - ib)) >> 1;
    for (int y = 0; y < 15; y++) {
        int tmx = mx + y * abcd[1];
        for (int x = 0; x < 8; x++) {
            const int64_t *fil = wf + 8 * (64 + ((tmx + 512) >> 10));
            int64_t acc = 0;
            for (int t = 0; t < 8; t++)
                acc += fil[t] * win[y][x + t];
            mid[y][x] = (int32_t)((acc + rnd_h) >> (7 - ib));
            tmx += abcd[0];
        }
    }
    const int rnd_v = prep ? 64 : ((1 << (7 + ib)) >> 1);
    const int sh_v = prep ? 7 : (7 + ib);
    for (int y = 0; y < 8; y++) {
        int tmy = my + y * abcd[3];
        for (int x = 0; x < 8; x++) {
            const int64_t *fil = wf + 8 * (64 + ((tmy + 512) >> 10));
            int64_t acc = 0;
            for (int t = 0; t < 8; t++)
                acc += fil[t] * mid[y + t][x];
            const int v = (int)((acc + rnd_v) >> sh_v);
            out[y * 8 + x] = prep ? v - prep_bias : clampi(v, 0, maxp);
            tmy += abcd[2];
        }
    }
}

/* 8x8 direction search per unit (semantics of the golden model
 * dav1d_tpu/recon/cdef.py cdef_find_dir, reference cdef_find_dir_c
 * src/cdef_tmpl.c:239): 8 directional projections, squared-sum costs
 * normalized by line length, variance vs the orthogonal direction. */
void dtpu_cdef_find_dir_batch(const int32_t *blocks, int64_t n,
                              int bitdepth, int64_t *dirs,
                              int64_t *variances)
{
    static const int div_table[7] = {840, 420, 280, 210, 168, 140, 120};
    const int shift = bitdepth - 8;
    for (int64_t u = 0; u < n; u++) {
        const int32_t *b = blocks + u * 64;
        int64_t psum_hv[2][8] = {{0}}, psum_diag[2][15] = {{0}};
        int64_t psum_alt[4][11] = {{0}};
        for (int y = 0; y < 8; y++)
            for (int x = 0; x < 8; x++) {
                const int v = (b[y * 8 + x] >> shift) - 128;
                psum_diag[0][y + x] += v;
                psum_alt[0][y + (x >> 1)] += v;
                psum_hv[0][y] += v;
                psum_alt[1][3 + y - (x >> 1)] += v;
                psum_diag[1][7 + y - x] += v;
                psum_alt[2][3 - (y >> 1) + x] += v;
                psum_hv[1][x] += v;
                psum_alt[3][(y >> 1) + x] += v;
            }
        int64_t cost[8] = {0};
        for (int i = 0; i < 8; i++) {
            cost[2] += psum_hv[0][i] * psum_hv[0][i];
            cost[6] += psum_hv[1][i] * psum_hv[1][i];
        }
        cost[2] *= 105;
        cost[6] *= 105;
        for (int i = 0; i < 7; i++) {
            const int d = div_table[i];
            cost[0] += (psum_diag[0][i] * psum_diag[0][i] +
                        psum_diag[0][14 - i] * psum_diag[0][14 - i]) * d;
            cost[4] += (psum_diag[1][i] * psum_diag[1][i] +
                        psum_diag[1][14 - i] * psum_diag[1][14 - i]) * d;
        }
        cost[0] += psum_diag[0][7] * psum_diag[0][7] * 105;
        cost[4] += psum_diag[1][7] * psum_diag[1][7] * 105;
        for (int i = 0; i < 4; i++) {
            int64_t c = 0;
            for (int m = 0; m < 5; m++)
                c += psum_alt[i][3 + m] * psum_alt[i][3 + m];
            c *= 105;
            for (int m = 0; m < 3; m++)
                c += (psum_alt[i][m] * psum_alt[i][m] +
                      psum_alt[i][10 - m] * psum_alt[i][10 - m]) *
                     div_table[2 * m + 1];
            cost[i * 2 + 1] = c;
        }
        int best = 0;
        int64_t best_cost = cost[0];
        for (int i = 1; i < 8; i++)
            if (cost[i] > best_cost) {
                best_cost = cost[i];
                best = i;
            }
        dirs[u] = best;
        variances[u] = (best_cost - cost[best ^ 4]) >> 10;
    }
}

/* Direction search reading 8x8 blocks straight from the plane (removes
 * the caller's (N, 8, 8) gather).  Units are processed 8 at a time with
 * the unit index in an int64 SIMD lane (GCC vector extensions): the
 * projection accumulators and squared-sum costs become 8-wide vector
 * ops; only the final per-lane argmax is scalar.  Tail lanes load a
 * repeat of the last unit (results simply overwritten). */
typedef int64_t cdef_v8 __attribute__((vector_size(64)));

void dtpu_cdef_find_dir_pos(const int32_t *plane, int64_t stride,
                            const int64_t *ys, const int64_t *xs,
                            int64_t n, int bitdepth, int64_t *dirs,
                            int64_t *variances)
{
    /* 16 int32 lanes (lane = unit): |px-128| <= 128, |psum| <= 1024,
     * and div_table[i] ~ 840/(i+1) bounds the total cost by
     * 128^2 * 840 * 64 < 2^31, so int32 never overflows. */
    typedef int32_t cdef_v16d __attribute__((vector_size(64)));
    static const int div_table[7] = {840, 420, 280, 210, 168, 140, 120};
    const int shift = bitdepth - 8;
    for (int64_t g = 0; g < n; g += 16) {
        const int lanes = n - g < 16 ? (int)(n - g) : 16;
        cdef_v16d b[64];
#ifdef __AVX512F__
        /* lane-transposed load via gathers: one 16-lane gather per
         * pixel position replaces 16 scalar strided walks (plane
         * offsets fit int32: <2^24 even at 8K) */
        {
            int32_t boff[16];
            for (int l = 0; l < 16; l++) {
                const int64_t u = g + (l < lanes ? l : lanes - 1);
                boff[l] = (int32_t)(ys[u] * stride + xs[u]);
            }
            const __m512i vbase = _mm512_loadu_si512(boff);
            const __m512i v128 = _mm512_set1_epi32(128);
            const __m512i vsh = _mm512_set1_epi32(shift);
            for (int y = 0; y < 8; y++)
                for (int x = 0; x < 8; x++) {
                    const __m512i idx = _mm512_add_epi32(
                        vbase, _mm512_set1_epi32((int)(y * stride + x)));
                    __m512i v = _mm512_i32gather_epi32(idx, plane, 4);
                    v = _mm512_sub_epi32(_mm512_srav_epi32(v, vsh),
                                         v128);
                    _mm512_store_si512(&b[y * 8 + x], v);
                }
        }
#else
        for (int l = 0; l < 16; l++) {
            const int64_t u = g + (l < lanes ? l : lanes - 1);
            const int32_t *src = plane + ys[u] * stride + xs[u];
            int32_t *bl = (int32_t *)b + l;
            for (int y = 0; y < 8; y++, src += stride)
                for (int x = 0; x < 8; x++)
                    bl[(y * 8 + x) * 16] = (src[x] >> shift) - 128;
        }
#endif
        cdef_v16d psum_hv[2][8], psum_diag[2][15], psum_alt[4][11];
        memset(psum_hv, 0, sizeof(psum_hv));
        memset(psum_diag, 0, sizeof(psum_diag));
        memset(psum_alt, 0, sizeof(psum_alt));
        for (int y = 0; y < 8; y++)
            for (int x = 0; x < 8; x++) {
                const cdef_v16d v = b[y * 8 + x];
                psum_diag[0][y + x] += v;
                psum_alt[0][y + (x >> 1)] += v;
                psum_hv[0][y] += v;
                psum_alt[1][3 + y - (x >> 1)] += v;
                psum_diag[1][7 + y - x] += v;
                psum_alt[2][3 - (y >> 1) + x] += v;
                psum_hv[1][x] += v;
                psum_alt[3][(y >> 1) + x] += v;
            }
        cdef_v16d cost[8];
        memset(cost, 0, sizeof(cost));
        for (int i = 0; i < 8; i++) {
            cost[2] += psum_hv[0][i] * psum_hv[0][i];
            cost[6] += psum_hv[1][i] * psum_hv[1][i];
        }
        cost[2] *= 105;
        cost[6] *= 105;
        for (int i = 0; i < 7; i++) {
            const int d = div_table[i];
            cost[0] += (psum_diag[0][i] * psum_diag[0][i] +
                        psum_diag[0][14 - i] * psum_diag[0][14 - i]) * d;
            cost[4] += (psum_diag[1][i] * psum_diag[1][i] +
                        psum_diag[1][14 - i] * psum_diag[1][14 - i]) * d;
        }
        cost[0] += psum_diag[0][7] * psum_diag[0][7] * 105;
        cost[4] += psum_diag[1][7] * psum_diag[1][7] * 105;
        for (int i = 0; i < 4; i++) {
            cdef_v16d c;
            memset(&c, 0, sizeof(c));
            for (int m = 0; m < 5; m++)
                c += psum_alt[i][3 + m] * psum_alt[i][3 + m];
            c *= 105;
            for (int m = 0; m < 3; m++)
                c += (psum_alt[i][m] * psum_alt[i][m] +
                      psum_alt[i][10 - m] * psum_alt[i][10 - m]) *
                     div_table[2 * m + 1];
            cost[i * 2 + 1] = c;
        }
        for (int l = 0; l < lanes; l++) {
            int best = 0;
            int32_t best_cost = cost[0][l];
            for (int i = 1; i < 8; i++)
                if (cost[i][l] > best_cost) {
                    best_cost = cost[i][l];
                    best = i;
                }
            dirs[g + l] = best;
            variances[g + l] = (best_cost - cost[best ^ 4][l]) >> 10;
        }
    }
}

/* Explicit-SIMD x-row path: a CDEF unit row is always exactly 4
 * (subsampled chroma) or 8 pixels wide, i.e. one whole SIMD vector, so
 * the row filter is written directly over GCC vector types with mask
 * blends replacing the branchy scalar constrain/min-max (the
 * auto-vectorizer refuses this loop: 13 differently-offset input
 * streams).  Bit-identical to the scalar form below, which remains the
 * fallback for any other width. */
typedef int32_t cdef_v8si
    __attribute__((vector_size(32), aligned(4), may_alias));
typedef int32_t cdef_v4si
    __attribute__((vector_size(16), aligned(4), may_alias));

#define CDEF_VEC_IMPL(NAME, VT)                                         \
static void NAME(const int32_t *restrict base, int64_t stride, int h,   \
                 int p, int s, int pri_shift, int sec_shift,            \
                 int pri_tap0, int pri_tap1, const int64_t *poff,       \
                 const int64_t *soff, int32_t *restrict o,              \
                 int64_t ostride)                                       \
{                                                                       \
    typedef uint32_t UVT                                                \
        __attribute__((vector_size(sizeof(VT)), aligned(4), may_alias));\
    const VT zero = {0};                                                \
    const VT vp = zero + p, vs = zero + s;                              \
    const int track = p && s;                                           \
    for (int y = 0; y < h; y++) {                                       \
        const int32_t *row = base + y * stride;                         \
        int32_t *orow = o + y * ostride;                                \
        const VT px = *(const VT *)row;                                 \
        VT sum = zero, mx = px;                                         \
        /* unsigned tap-min: the sentinel (INT16_MIN) reads as a huge   \
         * unsigned value and so never wins against a real pixel OR     \
         * against the 0x7FFF0000 init (the scalar ACC's sentinel       \
         * remap value, which an all-sentinel lane must yield); px      \
         * joins by a final SIGNED min so a sentinel centre pixel       \
         * stays most-negative exactly as in the scalar path.  For the  \
         * max the sentinel is most-negative and never wins signed. */  \
        UVT umn = (UVT)(zero + 0x7FFF0000);                             \
        VT d, m, ad, cl, sl, v;                                         \
        UVT usl;                                                        \
        if (p)                                                          \
            for (int k = 0; k < 4; k++) {                               \
                const VT t = *(const VT *)(row + poff[k]);              \
                d = t - px; m = d < zero; ad = (d ^ m) - m;             \
                cl = vp - (ad >> pri_shift); sl = ad < cl;              \
                v = (ad & sl) | (cl & ~sl); v &= ~(v < zero);           \
                v = (v ^ m) - m;                                        \
                sum += (k < 2 ? pri_tap0 : pri_tap1) * v;               \
                if (track) {                                            \
                    usl = (UVT)t < umn;                                 \
                    umn = ((UVT)t & usl) | (umn & ~usl);                \
                    sl = t > mx; mx = (t & sl) | (mx & ~sl);            \
                }                                                       \
            }                                                           \
        if (s)                                                          \
            for (int k = 0; k < 8; k++) {                               \
                const VT t = *(const VT *)(row + soff[k]);              \
                d = t - px; m = d < zero; ad = (d ^ m) - m;             \
                cl = vs - (ad >> sec_shift); sl = ad < cl;              \
                v = (ad & sl) | (cl & ~sl); v &= ~(v < zero);           \
                v = (v ^ m) - m;                                        \
                sum += (k < 4 ? 2 : 1) * v;                             \
                if (track) {                                            \
                    usl = (UVT)t < umn;                                 \
                    umn = ((UVT)t & usl) | (umn & ~usl);                \
                    sl = t > mx; mx = (t & sl) | (mx & ~sl);            \
                }                                                       \
            }                                                           \
        m = sum < zero; /* mask adds -1: the scalar's sum - (sum<0) */  \
        VT r = px + ((sum + m + (zero + 8)) >> 4);                      \
        if (track) {                                                    \
            VT mn = (VT)umn;                                            \
            sl = px < mn; mn = (px & sl) | (mn & ~sl);                  \
            sl = r < mn; r = (mn & sl) | (r & ~sl);                     \
            sl = r > mx; r = (mx & sl) | (r & ~sl);                     \
        }                                                               \
        *(VT *)orow = r;                                                \
    }                                                                   \
}

CDEF_VEC_IMPL(cdef_filter_unit_v8, cdef_v8si)
CDEF_VEC_IMPL(cdef_filter_unit_v4, cdef_v4si)

/* int16 unit filter for 8-bit frames: two unit rows ride in one vector
 * (16 or 8 int16 lanes), halving the op count per pixel vs the int32
 * path.  Sound at every bitdepth: a sentinel-tap diff wraps in int16
 * arithmetic, but every wrapped value still constrains to a zero
 * contribution there — |wrapped| >= 28673 and shift = damping -
 * ulog2(thr) ties the shifted magnitude to > thr (proof at
 * cdef_filter_unit_perm), or ad = INT16_MIN which the v<0 zeroing
 * kills; pixels <= 4095 and |sum| <= ~15k keep all lanes in range. */
typedef int16_t cdef_v16hi
    __attribute__((vector_size(32), aligned(2), may_alias));
typedef int16_t cdef_v8hi
    __attribute__((vector_size(16), aligned(2), may_alias));
typedef int16_t cdef_v4hi
    __attribute__((vector_size(8), aligned(2), may_alias));
typedef int32_t cdef_v4si_st
    __attribute__((vector_size(16), aligned(4), may_alias));

#define CDEF_VEC16_IMPL(NAME, VT, HVT, SVT, CAT, W)                     \
static void NAME(const int16_t *restrict base, int64_t stride, int h,   \
                 int p, int s, int pri_shift, int sec_shift,            \
                 int pri_tap0, int pri_tap1, const int64_t *poff,       \
                 const int64_t *soff, int32_t *restrict o,              \
                 int64_t ostride)                                       \
{                                                                       \
    typedef uint16_t UVT                                                \
        __attribute__((vector_size(sizeof(VT)), aligned(2), may_alias));\
    const VT zero = {0};                                                \
    const VT vp = zero + (int16_t)p, vs = zero + (int16_t)s;            \
    const int track = p && s;                                           \
    for (int y = 0; y < h; y += 2) {                                    \
        const int16_t *r0 = base + y * stride, *r1 = r0 + stride;       \
        int32_t *o0 = o + y * ostride, *o1 = o0 + ostride;              \
        const VT px = CAT(*(const HVT *)r0, *(const HVT *)r1);          \
        VT sum = zero, mx = px;                                         \
        UVT umn = (UVT)(zero + 0x7FFF);                                 \
        VT d, m, ad, cl, sl, v;                                         \
        UVT usl;                                                        \
        if (p)                                                          \
            for (int k = 0; k < 4; k++) {                               \
                const VT t = CAT(*(const HVT *)(r0 + poff[k]),          \
                                 *(const HVT *)(r1 + poff[k]));         \
                d = t - px; m = d < zero; ad = (d ^ m) - m;             \
                cl = vp - (ad >> pri_shift); sl = ad < cl;              \
                v = (ad & sl) | (cl & ~sl); v &= ~(v < zero);           \
                v = (v ^ m) - m;                                        \
                sum += (int16_t)(k < 2 ? pri_tap0 : pri_tap1) * v;      \
                if (track) {                                            \
                    usl = (UVT)t < umn;                                 \
                    umn = ((UVT)t & usl) | (umn & ~usl);                \
                    sl = t > mx; mx = (t & sl) | (mx & ~sl);            \
                }                                                       \
            }                                                           \
        if (s)                                                          \
            for (int k = 0; k < 8; k++) {                               \
                const VT t = CAT(*(const HVT *)(r0 + soff[k]),          \
                                 *(const HVT *)(r1 + soff[k]));         \
                d = t - px; m = d < zero; ad = (d ^ m) - m;             \
                cl = vs - (ad >> sec_shift); sl = ad < cl;              \
                v = (ad & sl) | (cl & ~sl); v &= ~(v < zero);           \
                v = (v ^ m) - m;                                        \
                sum += (int16_t)(k < 4 ? 2 : 1) * v;                    \
                if (track) {                                            \
                    usl = (UVT)t < umn;                                 \
                    umn = ((UVT)t & usl) | (umn & ~usl);                \
                    sl = t > mx; mx = (t & sl) | (mx & ~sl);            \
                }                                                       \
            }                                                           \
        m = sum < zero;                                                 \
        VT r = px + ((sum + m + (zero + 8)) >> 4);                      \
        if (track) {                                                    \
            VT mn = (VT)umn;                                            \
            sl = px < mn; mn = (px & sl) | (mn & ~sl);                  \
            sl = r < mn; r = (mn & sl) | (r & ~sl);                     \
            sl = r > mx; r = (mx & sl) | (r & ~sl);                     \
        }                                                               \
        const HVT lo = __builtin_shufflevector(r, r, CDEF_LO##W);       \
        const HVT hi = __builtin_shufflevector(r, r, CDEF_HI##W);       \
        *(SVT *)o0 = __builtin_convertvector(lo, SVT);                  \
        *(SVT *)o1 = __builtin_convertvector(hi, SVT);                  \
    }                                                                   \
}

#define CDEF_LO8 0, 1, 2, 3, 4, 5, 6, 7
#define CDEF_HI8 8, 9, 10, 11, 12, 13, 14, 15
#define CDEF_LO4 0, 1, 2, 3
#define CDEF_HI4 4, 5, 6, 7
#define CDEF_CAT8(a, b) __builtin_shufflevector((a), (b), 0, 1, 2, 3, \
        4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
#define CDEF_CAT4(a, b) __builtin_shufflevector((a), (b), 0, 1, 2, 3, \
        4, 5, 6, 7)
#define CDEF_CAT16(a, b) __builtin_shufflevector((a), (b), 0, 1, 2, 3, \
        4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, \
        21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31)

CDEF_VEC16_IMPL(cdef_filter_unit_i16w8, cdef_v16hi, cdef_v8hi,
                cdef_v8si, CDEF_CAT8, 8)
CDEF_VEC16_IMPL(cdef_filter_unit_i16w4, cdef_v8hi, cdef_v4hi,
                cdef_v4si_st, CDEF_CAT4, 4)

/* 4-row variant: four unit rows ride in one 32- (w=8) or 16-lane (w=4)
 * int16 vector — one 512-bit op per tap on AVX-512 hosts, halving the
 * iteration count of the 2-row kernels (h is always 4 or 8 here, so a
 * unit is 1 or 2 iterations).  Same int16 sentinel-wrap soundness
 * argument as CDEF_VEC16_IMPL (lanes are independent). */
typedef int16_t cdef_v32hi
    __attribute__((vector_size(64), aligned(2), may_alias));

#define CDEF_Q8_0 0, 1, 2, 3, 4, 5, 6, 7
#define CDEF_Q8_1 8, 9, 10, 11, 12, 13, 14, 15
#define CDEF_Q8_2 16, 17, 18, 19, 20, 21, 22, 23
#define CDEF_Q8_3 24, 25, 26, 27, 28, 29, 30, 31
#define CDEF_Q4_0 0, 1, 2, 3
#define CDEF_Q4_1 4, 5, 6, 7
#define CDEF_Q4_2 8, 9, 10, 11
#define CDEF_Q4_3 12, 13, 14, 15

#define CDEF_LD4(CATH, CATF, QVT, off)                                  \
    CATF(CATH(*(const QVT *)(r0 + (off)), *(const QVT *)(r1 + (off))), \
         CATH(*(const QVT *)(r2 + (off)), *(const QVT *)(r3 + (off))))

#define CDEF_VEC32_IMPL(NAME, VT, QVT, SVT, CATH, CATF, W)              \
static void NAME(const int16_t *restrict base, int64_t stride, int h,   \
                 int p, int s, int pri_shift, int sec_shift,            \
                 int pri_tap0, int pri_tap1, const int64_t *poff,       \
                 const int64_t *soff, int32_t *restrict o,              \
                 int64_t ostride)                                       \
{                                                                       \
    typedef uint16_t UVT                                                \
        __attribute__((vector_size(sizeof(VT)), aligned(2), may_alias));\
    const VT zero = {0};                                                \
    const VT vp = zero + (int16_t)p, vs = zero + (int16_t)s;            \
    const int track = p && s;                                           \
    for (int y = 0; y < h; y += 4) {                                    \
        const int16_t *r0 = base + y * stride, *r1 = r0 + stride,       \
                      *r2 = r1 + stride, *r3 = r2 + stride;             \
        int32_t *o0 = o + y * ostride, *o1 = o0 + ostride,              \
                *o2 = o1 + ostride, *o3 = o2 + ostride;                 \
        const VT px = CDEF_LD4(CATH, CATF, QVT, 0);                     \
        VT sum = zero, mx = px;                                         \
        UVT umn = (UVT)(zero + 0x7FFF);                                 \
        VT d, m, ad, cl, sl, v;                                         \
        UVT usl;                                                        \
        if (p)                                                          \
            for (int k = 0; k < 4; k++) {                               \
                const VT t = CDEF_LD4(CATH, CATF, QVT, poff[k]);        \
                d = t - px; m = d < zero; ad = (d ^ m) - m;             \
                cl = vp - (ad >> pri_shift); sl = ad < cl;              \
                v = (ad & sl) | (cl & ~sl); v &= ~(v < zero);           \
                v = (v ^ m) - m;                                        \
                sum += (int16_t)(k < 2 ? pri_tap0 : pri_tap1) * v;      \
                if (track) {                                            \
                    usl = (UVT)t < umn;                                 \
                    umn = ((UVT)t & usl) | (umn & ~usl);                \
                    sl = t > mx; mx = (t & sl) | (mx & ~sl);            \
                }                                                       \
            }                                                           \
        if (s)                                                          \
            for (int k = 0; k < 8; k++) {                               \
                const VT t = CDEF_LD4(CATH, CATF, QVT, soff[k]);        \
                d = t - px; m = d < zero; ad = (d ^ m) - m;             \
                cl = vs - (ad >> sec_shift); sl = ad < cl;              \
                v = (ad & sl) | (cl & ~sl); v &= ~(v < zero);           \
                v = (v ^ m) - m;                                        \
                sum += (int16_t)(k < 4 ? 2 : 1) * v;                    \
                if (track) {                                            \
                    usl = (UVT)t < umn;                                 \
                    umn = ((UVT)t & usl) | (umn & ~usl);                \
                    sl = t > mx; mx = (t & sl) | (mx & ~sl);            \
                }                                                       \
            }                                                           \
        m = sum < zero;                                                 \
        VT r = px + ((sum + m + (zero + 8)) >> 4);                      \
        if (track) {                                                    \
            VT mn = (VT)umn;                                            \
            sl = px < mn; mn = (px & sl) | (mn & ~sl);                  \
            sl = r < mn; r = (mn & sl) | (r & ~sl);                     \
            sl = r > mx; r = (mx & sl) | (r & ~sl);                     \
        }                                                               \
        const QVT q0 = __builtin_shufflevector(r, r, CDEF_Q##W##_0);    \
        const QVT q1 = __builtin_shufflevector(r, r, CDEF_Q##W##_1);    \
        const QVT q2 = __builtin_shufflevector(r, r, CDEF_Q##W##_2);    \
        const QVT q3 = __builtin_shufflevector(r, r, CDEF_Q##W##_3);    \
        *(SVT *)o0 = __builtin_convertvector(q0, SVT);                  \
        *(SVT *)o1 = __builtin_convertvector(q1, SVT);                  \
        *(SVT *)o2 = __builtin_convertvector(q2, SVT);                  \
        *(SVT *)o3 = __builtin_convertvector(q3, SVT);                  \
    }                                                                   \
}

CDEF_VEC32_IMPL(cdef_filter_unit_i16w8x4, cdef_v32hi, cdef_v8hi,
                cdef_v8si, CDEF_CAT8, CDEF_CAT16, 8)
CDEF_VEC32_IMPL(cdef_filter_unit_i16w4x4, cdef_v16hi, cdef_v4hi,
                cdef_v4si_st, CDEF_CAT4, CDEF_CAT8, 4)

/* 2-row int32 variant (the 10/12-bit canvas path): two unit rows per
 * 16- (w=8) or 8-lane (w=4) int32 vector — same math as CDEF_VEC_IMPL
 * including its sentinel min/max handling, at half the iterations. */
typedef int32_t cdef_v16si
    __attribute__((vector_size(64), aligned(4), may_alias));

#define CDEF_VEC2RI_IMPL(NAME, VT, HVT, CAT, W)                         \
static void NAME(const int32_t *restrict base, int64_t stride, int h,   \
                 int p, int s, int pri_shift, int sec_shift,            \
                 int pri_tap0, int pri_tap1, const int64_t *poff,       \
                 const int64_t *soff, int32_t *restrict o,              \
                 int64_t ostride)                                       \
{                                                                       \
    typedef uint32_t UVT                                                \
        __attribute__((vector_size(sizeof(VT)), aligned(4), may_alias));\
    const VT zero = {0};                                                \
    const VT vp = zero + p, vs = zero + s;                              \
    const int track = p && s;                                           \
    for (int y = 0; y < h; y += 2) {                                    \
        const int32_t *r0 = base + y * stride, *r1 = r0 + stride;       \
        int32_t *o0 = o + y * ostride, *o1 = o0 + ostride;              \
        const VT px = CAT(*(const HVT *)r0, *(const HVT *)r1);          \
        VT sum = zero, mx = px;                                         \
        UVT umn = (UVT)(zero + 0x7FFF0000);                             \
        VT d, m, ad, cl, sl, v;                                         \
        UVT usl;                                                        \
        if (p)                                                          \
            for (int k = 0; k < 4; k++) {                               \
                const VT t = CAT(*(const HVT *)(r0 + poff[k]),          \
                                 *(const HVT *)(r1 + poff[k]));         \
                d = t - px; m = d < zero; ad = (d ^ m) - m;             \
                cl = vp - (ad >> pri_shift); sl = ad < cl;              \
                v = (ad & sl) | (cl & ~sl); v &= ~(v < zero);           \
                v = (v ^ m) - m;                                        \
                sum += (k < 2 ? pri_tap0 : pri_tap1) * v;               \
                if (track) {                                            \
                    usl = (UVT)t < umn;                                 \
                    umn = ((UVT)t & usl) | (umn & ~usl);                \
                    sl = t > mx; mx = (t & sl) | (mx & ~sl);            \
                }                                                       \
            }                                                           \
        if (s)                                                          \
            for (int k = 0; k < 8; k++) {                               \
                const VT t = CAT(*(const HVT *)(r0 + soff[k]),          \
                                 *(const HVT *)(r1 + soff[k]));         \
                d = t - px; m = d < zero; ad = (d ^ m) - m;             \
                cl = vs - (ad >> sec_shift); sl = ad < cl;              \
                v = (ad & sl) | (cl & ~sl); v &= ~(v < zero);           \
                v = (v ^ m) - m;                                        \
                sum += (k < 4 ? 2 : 1) * v;                             \
                if (track) {                                            \
                    usl = (UVT)t < umn;                                 \
                    umn = ((UVT)t & usl) | (umn & ~usl);                \
                    sl = t > mx; mx = (t & sl) | (mx & ~sl);            \
                }                                                       \
            }                                                           \
        m = sum < zero;                                                 \
        VT r = px + ((sum + m + (zero + 8)) >> 4);                      \
        if (track) {                                                    \
            VT mn = (VT)umn;                                            \
            sl = px < mn; mn = (px & sl) | (mn & ~sl);                  \
            sl = r < mn; r = (mn & sl) | (r & ~sl);                     \
            sl = r > mx; r = (mx & sl) | (r & ~sl);                     \
        }                                                               \
        *(HVT *)o0 = __builtin_shufflevector(r, r, CDEF_LO##W);         \
        *(HVT *)o1 = __builtin_shufflevector(r, r, CDEF_HI##W);         \
    }                                                                   \
}

CDEF_VEC2RI_IMPL(cdef_filter_unit_v8x2, cdef_v16si, cdef_v8si,
                 CDEF_CAT8, 8)
CDEF_VEC2RI_IMPL(cdef_filter_unit_v4x2, cdef_v8si, cdef_v4si,
                 CDEF_CAT4, 4)

/* One unit read from `base` (the sentinel-bordered pre-CDEF canvas),
 * written to `o` with stride `ostride` (packed batch output, or
 * straight into the picture plane). */
/* base (the pre-CDEF canvas) and o (batch output or the picture plane)
 * never alias — restrict lets the x loops vectorize without runtime
 * alias checks. */
static void cdef_filter_unit(const int32_t *restrict base, int64_t stride,
                             int w, int h, int p, int s, int dir,
                             int damping, int bitdepth,
                             int32_t *restrict o, int64_t ostride)
{
    const int bdmin8 = bitdepth - 8;
    const int pri_shift_raw = p ? damping - ulog2i(p) : 0;
    const int pri_shift = pri_shift_raw < 0 ? 0 : pri_shift_raw;
    const int sec_shift = s ? damping - ulog2i(s) : 0;
    const int pri_tap0 = 4 - ((p >> bdmin8) & 1);
    const int pri_tap1 = (pri_tap0 & 3) | 2;

    /* per-unit tap offsets: the direction is constant over the
     * unit, so the 4 primary / 8 secondary neighbour offsets are
     * hoisted out of the pixel loop (same hoist the reference asm
     * does by specializing per direction) */
    int64_t poff[4], soff[8];
    for (int k = 0; k < 2; k++) {
        poff[k * 2] = cdef_dirs[2 + dir][k][0] * stride +
                      cdef_dirs[2 + dir][k][1];
        poff[k * 2 + 1] = -poff[k * 2];
        soff[k * 4] = cdef_dirs[4 + dir][k][0] * stride +
                      cdef_dirs[4 + dir][k][1];
        soff[k * 4 + 1] = -soff[k * 4];
        soff[k * 4 + 2] = cdef_dirs[dir][k][0] * stride +
                          cdef_dirs[dir][k][1];
        soff[k * 4 + 3] = -soff[k * 4 + 2];
    }

    if (w == 8) {
        (!(h & 1) ? cdef_filter_unit_v8x2 : cdef_filter_unit_v8)(
            base, stride, h, p, s, pri_shift, sec_shift, pri_tap0,
            pri_tap1, poff, soff, o, ostride);
        return;
    }
    if (w == 4) {
        (!(h & 1) ? cdef_filter_unit_v4x2 : cdef_filter_unit_v4)(
            base, stride, h, p, s, pri_shift, sec_shift, pri_tap0,
            pri_tap1, poff, soff, o, ostride);
        return;
    }

    /* Row-pointer hoist + branchless min/max (the unsigned-min trick of
     * the golden model: CDEF_SENTINEL reads as a huge unsigned value)
     * keeps the x loop stride-1 and branch-free for the vectorizer. */
    if (p && s) {
        for (int y = 0; y < h; y++) {
            const int32_t *row = base + y * stride;
            int32_t *orow = o + y * ostride;
            const int32_t *t0 = row + poff[0], *t1 = row + poff[1];
            const int32_t *t2 = row + poff[2], *t3 = row + poff[3];
            const int32_t *s0 = row + soff[0], *s1 = row + soff[1];
            const int32_t *s2 = row + soff[2], *s3 = row + soff[3];
            const int32_t *s4 = row + soff[4], *s5 = row + soff[5];
            const int32_t *s6 = row + soff[6], *s7 = row + soff[7];
            for (int x = 0; x < w; x++) {
                const int px = row[x];
                const int p0 = t0[x], p1 = t1[x], p2 = t2[x], p3 = t3[x];
                const int v0 = s0[x], v1 = s1[x], v2 = s2[x], v3 = s3[x];
                const int v4 = s4[x], v5 = s5[x], v6 = s6[x], v7 = s7[x];
                int sum =
                    pri_tap0 * (constrain(p0 - px, p, pri_shift) +
                                constrain(p1 - px, p, pri_shift)) +
                    pri_tap1 * (constrain(p2 - px, p, pri_shift) +
                                constrain(p3 - px, p, pri_shift)) +
                    2 * (constrain(v0 - px, s, sec_shift) +
                         constrain(v1 - px, s, sec_shift) +
                         constrain(v2 - px, s, sec_shift) +
                         constrain(v3 - px, s, sec_shift)) +
                    (constrain(v4 - px, s, sec_shift) +
                     constrain(v5 - px, s, sec_shift) +
                     constrain(v6 - px, s, sec_shift) +
                     constrain(v7 - px, s, sec_shift));
                int mn = px, mx = px;
                /* sentinel taps are excluded from the min by remapping
                 * to a huge positive value (golden model's trick) and
                 * from the max by the sentinel being most-negative */
#define ACC(v) do { \
                    const int rv_ = (v) == CDEF_SENTINEL ? 0x7FFF0000 \
                                                         : (v); \
                    if (rv_ < mn) mn = rv_; \
                    if ((v) > mx) mx = (v); } while (0)
                ACC(p0); ACC(p1); ACC(p2); ACC(p3);
                ACC(v0); ACC(v1); ACC(v2); ACC(v3);
                ACC(v4); ACC(v5); ACC(v6); ACC(v7);
#undef ACC
                int res = px + ((sum - (sum < 0) + 8) >> 4);
                if (res < mn) res = mn;
                if (res > mx) res = mx;
                orow[x] = res;
            }
        }
    } else if (p) {
        for (int y = 0; y < h; y++) {
            const int32_t *row = base + y * stride;
            int32_t *orow = o + y * ostride;
            const int32_t *t0 = row + poff[0], *t1 = row + poff[1];
            const int32_t *t2 = row + poff[2], *t3 = row + poff[3];
            for (int x = 0; x < w; x++) {
                const int px = row[x];
                int sum =
                    pri_tap0 * (constrain(t0[x] - px, p, pri_shift) +
                                constrain(t1[x] - px, p, pri_shift)) +
                    pri_tap1 * (constrain(t2[x] - px, p, pri_shift) +
                                constrain(t3[x] - px, p, pri_shift));
                orow[x] = px + ((sum - (sum < 0) + 8) >> 4);
            }
        }
    } else {
        for (int y = 0; y < h; y++) {
            const int32_t *row = base + y * stride;
            int32_t *orow = o + y * ostride;
            const int32_t *s0 = row + soff[0], *s1 = row + soff[1];
            const int32_t *s2 = row + soff[2], *s3 = row + soff[3];
            const int32_t *s4 = row + soff[4], *s5 = row + soff[5];
            const int32_t *s6 = row + soff[6], *s7 = row + soff[7];
            for (int x = 0; x < w; x++) {
                const int px = row[x];
                int sum =
                    2 * (constrain(s0[x] - px, s, sec_shift) +
                         constrain(s1[x] - px, s, sec_shift) +
                         constrain(s2[x] - px, s, sec_shift) +
                         constrain(s3[x] - px, s, sec_shift)) +
                    (constrain(s4[x] - px, s, sec_shift) +
                     constrain(s5[x] - px, s, sec_shift) +
                     constrain(s6[x] - px, s, sec_shift) +
                     constrain(s7[x] - px, s, sec_shift));
                orow[x] = px + ((sum - (sum < 0) + 8) >> 4);
            }
        }
    }
}

void dtpu_cdef_filter_batch(const int32_t *canvas, int64_t stride,
                            const int64_t *ys, const int64_t *xs, int64_t n,
                            int w, int h, const int64_t *pri,
                            const int64_t *sec, const int64_t *dirs,
                            int damping, int bitdepth, int32_t *out)
{
    for (int64_t u = 0; u < n; u++) {
        const int32_t *base = canvas + ys[u] * stride + xs[u];
        int32_t *o = out + u * (int64_t)(w * h);
        const int p = (int)pri[u], s = (int)sec[u];
        if (!p && !s) {
            for (int y = 0; y < h; y++)
                for (int x = 0; x < w; x++)
                    o[y * w + x] = base[y * stride + x];
            continue;
        }
        cdef_filter_unit(base, stride, w, h, p, s, (int)dirs[u],
                         damping, bitdepth, o, w);
    }
}

#if defined(__AVX512BW__) && defined(__AVX512VL__)
/* Permuted-tap unit filter: a 4-output-row iteration preloads the
 * 8 source rows x 16 cols it can touch into four zmm (2 rows each),
 * then every tap materializes with two vpermt2w + one blend off
 * per-direction index tables built once at load — replacing the four
 * loads + three shuffles per tap of the generic kernels.  Constrain
 * uses the saturating form  v = min_u(|d|, thr -sat (|d| >> shift)):
 *   - normal taps: |d| <= 4095 so unsigned min == signed min;
 *   - sentinel taps (-32768): d wraps to |wrapped| >= 28673 (px >= 1),
 *     and (ad >> shift) >= ad >> (damping - ulog2(thr)) >=
 *     thr * 28673 / 2^(damping+1) > thr for damping <= 10, so the
 *     saturating subtract floors at 0 and min_u picks 0; px = 0 gives
 *     ad = INT16_MIN whose arithmetic shift reads as epu16 >= 32768,
 *     flooring the subtract the same way.
 * The shift-threshold linkage makes this sound at EVERY bitdepth
 * (pixels <= 4095 and |sum| <= 14*1008 + 12*64 fit int16), unlike the
 * fixed-bound argument of CDEF_VEC16_IMPL above. */
static __m512i cdef_pidx[8][13];
static __mmask32 cdef_phi[8][13];

__attribute__((constructor)) static void cdef_perm_init(void)
{
    for (int dir = 0; dir < 8; dir++) {
        int off[13][2]; /* taps 0-3 pri, 4-11 sec, 12 centre; the order
                         * mirrors the dpoff/dsoff construction below */
        for (int k = 0; k < 2; k++) {
            off[2 * k][0] = cdef_dirs[2 + dir][k][0];
            off[2 * k][1] = cdef_dirs[2 + dir][k][1];
            off[2 * k + 1][0] = -off[2 * k][0];
            off[2 * k + 1][1] = -off[2 * k][1];
            off[4 + 4 * k][0] = cdef_dirs[4 + dir][k][0];
            off[4 + 4 * k][1] = cdef_dirs[4 + dir][k][1];
            off[4 + 4 * k + 1][0] = -off[4 + 4 * k][0];
            off[4 + 4 * k + 1][1] = -off[4 + 4 * k][1];
            off[4 + 4 * k + 2][0] = cdef_dirs[dir][k][0];
            off[4 + 4 * k + 2][1] = cdef_dirs[dir][k][1];
            off[4 + 4 * k + 3][0] = -off[4 + 4 * k + 2][0];
            off[4 + 4 * k + 3][1] = -off[4 + 4 * k + 2][1];
        }
        off[12][0] = off[12][1] = 0;
        for (int t = 0; t < 13; t++) {
            uint16_t idx[32];
            uint32_t hi = 0;
            for (int l = 0; l < 32; l++) {
                /* output lane l = (row r, col c); source lane in the
                 * 8x16 preloaded window (rows -2..5, cols -2..13) */
                const int r = l >> 3, c = l & 7;
                int g = (r + off[t][0] + 2) * 16 + (c + off[t][1] + 2);
                if (g >= 64) {
                    hi |= 1u << l;
                    g -= 64;
                }
                idx[l] = (uint16_t)g;
            }
            cdef_pidx[dir][t] = _mm512_loadu_si512(idx);
            cdef_phi[dir][t] = (__mmask32)hi;
        }
    }
}

static void cdef_filter_unit_perm(const int16_t *restrict base,
                                  int64_t cstride, int w, int h, int p,
                                  int s, int pri_shift, int sec_shift,
                                  int pri_tap0, int pri_tap1, int dir,
                                  int32_t *restrict o, int64_t ostride)
{
    const __m512i *idx = cdef_pidx[dir];
    const __mmask32 *phi = cdef_phi[dir];
    const __m512i vp = _mm512_set1_epi16((short)p);
    const __m512i vs = _mm512_set1_epi16((short)s);
    const __m128i shp = _mm_cvtsi32_si128(pri_shift);
    const __m128i shs = _mm_cvtsi32_si128(sec_shift);
    const __m512i v8v = _mm512_set1_epi16(8);
    const __m512i tp0 = _mm512_set1_epi16((short)pri_tap0);
    const __m512i tp1 = _mm512_set1_epi16((short)pri_tap1);
    const int track = p && s;
    const __mmask8 smask = w == 8 ? 0xFF : 0x0F;

    __m512i Z0, Z1, Z2, Z3;
    for (int y = 0; y < h; y += 4) {
        const int16_t *r = base + (int64_t)(y - 2) * cstride - 2;
        if (y == 0) {
            Z0 = _mm512_inserti64x4(_mm512_castsi256_si512(
                     _mm256_loadu_si256((const __m256i *)r)),
                 _mm256_loadu_si256((const __m256i *)(r + cstride)), 1);
            Z1 = _mm512_inserti64x4(_mm512_castsi256_si512(
                     _mm256_loadu_si256((const __m256i *)(r + 2 * cstride))),
                 _mm256_loadu_si256((const __m256i *)(r + 3 * cstride)), 1);
        } else {
            /* rows y-2..y+1 were the previous iteration's y+2..y+5 */
            Z0 = Z2;
            Z1 = Z3;
        }
        Z2 = _mm512_inserti64x4(_mm512_castsi256_si512(
                 _mm256_loadu_si256((const __m256i *)(r + 4 * cstride))),
             _mm256_loadu_si256((const __m256i *)(r + 5 * cstride)), 1);
        Z3 = _mm512_inserti64x4(_mm512_castsi256_si512(
                 _mm256_loadu_si256((const __m256i *)(r + 6 * cstride))),
             _mm256_loadu_si256((const __m256i *)(r + 7 * cstride)), 1);
#define CDEF_PTAP(t)                                                   \
    _mm512_mask_blend_epi16(phi[t],                                    \
        _mm512_permutex2var_epi16(Z0, idx[t], Z1),                     \
        _mm512_permutex2var_epi16(Z2, idx[t], Z3))
        const __m512i px = CDEF_PTAP(12);
        __m512i sum = _mm512_setzero_si512();
        __m512i umn = _mm512_set1_epi16(0x7FFF);
        __m512i mx = px;
        if (p)
            for (int k = 0; k < 4; k++) {
                const __m512i t = CDEF_PTAP(k);
                const __m512i d = _mm512_sub_epi16(t, px);
                const __m512i m = _mm512_srai_epi16(d, 15);
                const __m512i ad = _mm512_abs_epi16(d);
                const __m512i cl =
                    _mm512_subs_epu16(vp, _mm512_sra_epi16(ad, shp));
                __m512i v = _mm512_min_epu16(ad, cl);
                v = _mm512_sub_epi16(_mm512_xor_si512(v, m), m);
                sum = _mm512_add_epi16(sum,
                    _mm512_mullo_epi16(k < 2 ? tp0 : tp1, v));
                if (track) {
                    umn = _mm512_min_epu16(umn, t);
                    mx = _mm512_max_epi16(mx, t);
                }
            }
        if (s)
            for (int k = 4; k < 12; k++) {
                const __m512i t = CDEF_PTAP(k);
                const __m512i d = _mm512_sub_epi16(t, px);
                const __m512i m = _mm512_srai_epi16(d, 15);
                const __m512i ad = _mm512_abs_epi16(d);
                const __m512i cl =
                    _mm512_subs_epu16(vs, _mm512_sra_epi16(ad, shs));
                __m512i v = _mm512_min_epu16(ad, cl);
                v = _mm512_sub_epi16(_mm512_xor_si512(v, m), m);
                /* sec weights are 2 (k<8) and 1: adds, not mullo */
                if (k < 8)
                    v = _mm512_add_epi16(v, v);
                sum = _mm512_add_epi16(sum, v);
                if (track) {
                    umn = _mm512_min_epu16(umn, t);
                    mx = _mm512_max_epi16(mx, t);
                }
            }
#undef CDEF_PTAP
        __m512i res = _mm512_add_epi16(px, _mm512_srai_epi16(
            _mm512_add_epi16(_mm512_add_epi16(sum,
                _mm512_srai_epi16(sum, 15)), v8v), 4));
        if (track) {
            const __m512i mn = _mm512_min_epi16(px, umn);
            res = _mm512_max_epi16(res, mn);
            res = _mm512_min_epi16(res, mx);
        }
        const __m256i lo = _mm512_castsi512_si256(res);
        const __m256i hi = _mm512_extracti64x4_epi64(res, 1);
        int32_t *o0 = o + (int64_t)y * ostride;
        _mm256_mask_storeu_epi32(o0, smask,
            _mm256_cvtepi16_epi32(_mm256_castsi256_si128(lo)));
        _mm256_mask_storeu_epi32(o0 + ostride, smask,
            _mm256_cvtepi16_epi32(_mm256_extracti128_si256(lo, 1)));
        _mm256_mask_storeu_epi32(o0 + 2 * ostride, smask,
            _mm256_cvtepi16_epi32(_mm256_castsi256_si128(hi)));
        _mm256_mask_storeu_epi32(o0 + 3 * ostride, smask,
            _mm256_cvtepi16_epi32(_mm256_extracti128_si256(hi, 1)));
    }
}

/* Paired 4-wide variant: two horizontally adjacent 4xh units (xs
 * differing by 4) ride one 8-lane-wide pass — the 16-col preloaded
 * window of the single kernel already covers both units' taps, so the
 * only changes are per-lane parameters: strengths/taps/shifts blend by
 * lane group (vpsravw for the per-unit constrain shifts), the tap
 * index tables blend between the two directions, and the final
 * min/max clamp applies per lane group.  Doubles the useful lanes of
 * chroma CDEF (4:2:0 4x4 and 4:2:2 4x8 units). */
static void cdef_filter_unit_perm_pair(const int16_t *restrict base,
                                       int64_t cstride, int h,
                                       int pA, int sA, int pB, int sB,
                                       int pshA, int sshA, int pshB,
                                       int sshB, int t0A, int t1A,
                                       int t0B, int t1B, int dirA,
                                       int dirB, int32_t *restrict o,
                                       int64_t ostride)
{
    const __mmask32 BL = 0xF0F0F0F0;  /* lanes with c = (l&7) >= 4 */
    const __m512i *idxA = cdef_pidx[dirA], *idxB = cdef_pidx[dirB];
    const __mmask32 *phiA = cdef_phi[dirA], *phiB = cdef_phi[dirB];
    const __m512i vp = _mm512_mask_blend_epi16(
        BL, _mm512_set1_epi16((short)pA), _mm512_set1_epi16((short)pB));
    const __m512i vs = _mm512_mask_blend_epi16(
        BL, _mm512_set1_epi16((short)sA), _mm512_set1_epi16((short)sB));
    const __m512i shp = _mm512_mask_blend_epi16(
        BL, _mm512_set1_epi16((short)pshA),
        _mm512_set1_epi16((short)pshB));
    const __m512i shs = _mm512_mask_blend_epi16(
        BL, _mm512_set1_epi16((short)sshA),
        _mm512_set1_epi16((short)sshB));
    const __m512i tp0 = _mm512_mask_blend_epi16(
        BL, _mm512_set1_epi16((short)t0A), _mm512_set1_epi16((short)t0B));
    const __m512i tp1 = _mm512_mask_blend_epi16(
        BL, _mm512_set1_epi16((short)t1A), _mm512_set1_epi16((short)t1B));
    const __m512i v8v = _mm512_set1_epi16(8);
    const __mmask32 trk = (pA && sA ? ~BL & 0xFFFFFFFF : 0) |
                          (pB && sB ? BL : 0);
    const int any_p = pA | pB, any_s = sA | sB;

    __m512i Z0, Z1, Z2, Z3;
    for (int y = 0; y < h; y += 4) {
        const int16_t *r = base + (int64_t)(y - 2) * cstride - 2;
        if (y == 0) {
            Z0 = _mm512_inserti64x4(_mm512_castsi256_si512(
                     _mm256_loadu_si256((const __m256i *)r)),
                 _mm256_loadu_si256((const __m256i *)(r + cstride)), 1);
            Z1 = _mm512_inserti64x4(_mm512_castsi256_si512(
                     _mm256_loadu_si256((const __m256i *)(r + 2 * cstride))),
                 _mm256_loadu_si256((const __m256i *)(r + 3 * cstride)), 1);
        } else {
            /* rows y-2..y+1 were the previous iteration's y+2..y+5 */
            Z0 = Z2;
            Z1 = Z3;
        }
        Z2 = _mm512_inserti64x4(_mm512_castsi256_si512(
                 _mm256_loadu_si256((const __m256i *)(r + 4 * cstride))),
             _mm256_loadu_si256((const __m256i *)(r + 5 * cstride)), 1);
        Z3 = _mm512_inserti64x4(_mm512_castsi256_si512(
                 _mm256_loadu_si256((const __m256i *)(r + 6 * cstride))),
             _mm256_loadu_si256((const __m256i *)(r + 7 * cstride)), 1);
#define CDEF_PTAPP(t)                                                  \
    _mm512_mask_blend_epi16(                                           \
        (phiA[t] & ~BL) | (phiB[t] & BL),                              \
        _mm512_permutex2var_epi16(Z0,                                  \
            _mm512_mask_blend_epi16(BL, idxA[t], idxB[t]), Z1),        \
        _mm512_permutex2var_epi16(Z2,                                  \
            _mm512_mask_blend_epi16(BL, idxA[t], idxB[t]), Z3))
        const __m512i px = CDEF_PTAPP(12);
        __m512i sum = _mm512_setzero_si512();
        __m512i umn = _mm512_set1_epi16(0x7FFF);
        __m512i mx = px;
        if (any_p)
            for (int k = 0; k < 4; k++) {
                const __m512i t = CDEF_PTAPP(k);
                const __m512i d = _mm512_sub_epi16(t, px);
                const __m512i m = _mm512_srai_epi16(d, 15);
                const __m512i ad = _mm512_abs_epi16(d);
                const __m512i cl =
                    _mm512_subs_epu16(vp, _mm512_srav_epi16(ad, shp));
                __m512i v = _mm512_min_epu16(ad, cl);
                v = _mm512_sub_epi16(_mm512_xor_si512(v, m), m);
                sum = _mm512_add_epi16(sum,
                    _mm512_mullo_epi16(k < 2 ? tp0 : tp1, v));
                umn = _mm512_min_epu16(umn, t);
                mx = _mm512_max_epi16(mx, t);
            }
        if (any_s)
            for (int k = 4; k < 12; k++) {
                const __m512i t = CDEF_PTAPP(k);
                const __m512i d = _mm512_sub_epi16(t, px);
                const __m512i m = _mm512_srai_epi16(d, 15);
                const __m512i ad = _mm512_abs_epi16(d);
                const __m512i cl =
                    _mm512_subs_epu16(vs, _mm512_srav_epi16(ad, shs));
                __m512i v = _mm512_min_epu16(ad, cl);
                v = _mm512_sub_epi16(_mm512_xor_si512(v, m), m);
                /* sec weights are 2 (k<8) and 1: adds, not mullo */
                if (k < 8)
                    v = _mm512_add_epi16(v, v);
                sum = _mm512_add_epi16(sum, v);
                umn = _mm512_min_epu16(umn, t);
                mx = _mm512_max_epi16(mx, t);
            }
#undef CDEF_PTAPP
        __m512i res = _mm512_add_epi16(px, _mm512_srai_epi16(
            _mm512_add_epi16(_mm512_add_epi16(sum,
                _mm512_srai_epi16(sum, 15)), v8v), 4));
        if (trk) {
            const __m512i mn = _mm512_min_epi16(px, umn);
            __m512i cl = _mm512_max_epi16(res, mn);
            cl = _mm512_min_epi16(cl, mx);
            res = _mm512_mask_blend_epi16(trk, res, cl);
        }
        const __m256i lo = _mm512_castsi512_si256(res);
        const __m256i hi = _mm512_extracti64x4_epi64(res, 1);
        int32_t *o0 = o + (int64_t)y * ostride;
        _mm256_storeu_si256((__m256i *)o0,
            _mm256_cvtepi16_epi32(_mm256_castsi256_si128(lo)));
        _mm256_storeu_si256((__m256i *)(o0 + ostride),
            _mm256_cvtepi16_epi32(_mm256_extracti128_si256(lo, 1)));
        _mm256_storeu_si256((__m256i *)(o0 + 2 * ostride),
            _mm256_cvtepi16_epi32(_mm256_castsi256_si128(hi)));
        _mm256_storeu_si256((__m256i *)(o0 + 3 * ostride),
            _mm256_cvtepi16_epi32(_mm256_extracti128_si256(hi, 1)));
    }
}
#endif /* __AVX512BW__ && __AVX512VL__ */

/* Whole-plane unit pass: copy the plane into the caller's sentinel-
 * bordered canvas scratch (the pre-CDEF pixel source, standing in for
 * the reference's cdef_line backups src/cdef_apply_tmpl.c:40-99), then
 * filter every unit from the canvas straight back into the plane.
 * Removes the Python-side plane copy, unit gather and result scatter. */
/* 8-bit whole-plane pass over an int16 canvas (reinterprets the
 * caller's int32 canvas scratch, which is twice the needed size). */
/* Stage plane rows [y0, y1) into the sentinel-bordered int16 canvas
 * (pre-CDEF pixel backup).  Called band-by-band so the filter reads
 * canvas rows staged moments earlier (cache-warm) instead of
 * re-walking a frame-sized canvas cold. */
static void cdef_stage_rows_i16(const int32_t *plane, int64_t stride,
                                int pw, int ph, int16_t *canvas,
                                int64_t y0, int64_t y1)
{
    const int64_t cstride = pw + 4;
    if (y0 == 0)
        for (int64_t x = 0; x < cstride * 2; x++)
            canvas[x] = CDEF_SENTINEL;
    for (int64_t y = y0; y < y1; y++) {
        int16_t *crow = canvas + (y + 2) * cstride;
        const int32_t *prow = plane + y * stride;
        crow[0] = crow[1] = crow[pw + 2] = crow[pw + 3] = CDEF_SENTINEL;
        for (int x = 0; x < pw; x++)
            crow[2 + x] = (int16_t)prow[x];
    }
    if (y1 >= ph)
        for (int64_t x = 0; x < cstride * 2; x++)
            canvas[(int64_t)(ph + 2) * cstride + x] = CDEF_SENTINEL;
}

/* Filter units [u0, u1) (a row band, or a whole sorted unit list) off
 * the sentinel-bordered int16 canvas, staging canvas rows on demand
 * through *staged_io (shared across calls so a caller can interleave
 * per-band work — e.g. the luma direction search — with filtering). */
static void cdef_filter_units_i16(int32_t *plane, int64_t stride, int pw,
                                  int ph, int16_t *canvas,
                                  const int64_t *ys, const int64_t *xs,
                                  const int64_t *pri, const int64_t *sec,
                                  const int64_t *dirs, int64_t u0,
                                  int64_t u1, int w, int h, int damping,
                                  int bdmin8, int64_t *staged_io)
{
    const int64_t cstride = pw + 4;
    int64_t staged = *staged_io;

    /* all 8 directions' tap offsets, hoisted out of the unit loop (the
     * canvas stride is constant across the plane) */
    int64_t dpoff[8][4], dsoff[8][8];
    for (int dir = 0; dir < 8; dir++)
        for (int k = 0; k < 2; k++) {
            dpoff[dir][k * 2] = cdef_dirs[2 + dir][k][0] * cstride +
                                cdef_dirs[2 + dir][k][1];
            dpoff[dir][k * 2 + 1] = -dpoff[dir][k * 2];
            dsoff[dir][k * 4] = cdef_dirs[4 + dir][k][0] * cstride +
                                cdef_dirs[4 + dir][k][1];
            dsoff[dir][k * 4 + 1] = -dsoff[dir][k * 4];
            dsoff[dir][k * 4 + 2] = cdef_dirs[dir][k][0] * cstride +
                                    cdef_dirs[dir][k][1];
            dsoff[dir][k * 4 + 3] = -dsoff[dir][k * 4 + 2];
        }
    const int four = !(h & 3);
    void (*const fn)(const int16_t *restrict, int64_t, int, int, int,
                     int, int, int, int, const int64_t *,
                     const int64_t *, int32_t *restrict, int64_t) =
        w == 8 ? (four ? cdef_filter_unit_i16w8x4 : cdef_filter_unit_i16w8)
               : (four ? cdef_filter_unit_i16w4x4 : cdef_filter_unit_i16w4);

#if defined(__AVX512BW__) && defined(__AVX512VL__)
    const int use_perm = (w == 8 || w == 4) && (h == 8 || h == 4);
#endif
    for (int64_t u = u0; u < u1; u++) {
        const int p = (int)pri[u], s = (int)sec[u];
        if (!p && !s)
            continue;
        if (ys[u] + h + 2 > staged) {
            /* stage this unit row band (+halo) just before filtering
             * it; always rows strictly below anything written so far */
            int64_t need = ys[u] + h + 2;
            if (need > ph)
                need = ph;
            cdef_stage_rows_i16(plane, stride, pw, ph, canvas, staged,
                                need);
            staged = need;
        }
        const int pri_shift_raw = p ? damping - ulog2i(p) : 0;
        const int pri_shift = pri_shift_raw < 0 ? 0 : pri_shift_raw;
        const int sec_shift = s ? damping - ulog2i(s) : 0;
        /* tap parity reads the strength at 8-bit scale
         * (reference src/cdef_tmpl.c pri >> bitdepth_min_8) */
        const int pri_tap0 = 4 - ((p >> bdmin8) & 1);
        const int pri_tap1 = (pri_tap0 & 3) | 2;
        const int dir = (int)dirs[u];
        const int16_t *base = canvas + (ys[u] + 2) * cstride + xs[u] + 2;
        int32_t *o = plane + ys[u] * stride + xs[u];
#if defined(__AVX512BW__) && defined(__AVX512VL__)
        if (use_perm) {
            if (w == 4 && u + 1 < u1 && ys[u + 1] == ys[u] &&
                xs[u + 1] == xs[u] + 4 &&
                (pri[u + 1] | sec[u + 1])) {
                const int pB = (int)pri[u + 1], sB = (int)sec[u + 1];
                const int pshB_raw = pB ? damping - ulog2i(pB) : 0;
                const int pshB = pshB_raw < 0 ? 0 : pshB_raw;
                const int sshB = sB ? damping - ulog2i(sB) : 0;
                const int t0B = 4 - ((pB >> bdmin8) & 1);
                cdef_filter_unit_perm_pair(
                    base, cstride, h, p, s, pB, sB, pri_shift, sec_shift,
                    pshB, sshB, pri_tap0, pri_tap1, t0B, (t0B & 3) | 2,
                    dir, (int)dirs[u + 1], o, stride);
                u++;
                continue;
            }
            cdef_filter_unit_perm(base, cstride, w, h, p, s, pri_shift,
                                  sec_shift, pri_tap0, pri_tap1, dir, o,
                                  stride);
            continue;
        }
#endif
        fn(base, cstride, h, p, s, pri_shift, sec_shift, pri_tap0,
           pri_tap1, dpoff[dir], dsoff[dir], o, stride);
    }
    *staged_io = staged;
}

static void cdef_filter_plane_i16(int32_t *plane, int64_t stride, int pw,
                                  int ph, int16_t *canvas,
                                  const int64_t *ys, const int64_t *xs,
                                  int64_t n, int w, int h,
                                  const int64_t *pri, const int64_t *sec,
                                  const int64_t *dirs, int damping,
                                  int bdmin8)
{
    int64_t staged = 0;
    cdef_filter_units_i16(plane, stride, pw, ph, canvas, ys, xs, pri,
                          sec, dirs, 0, n, w, h, damping, bdmin8,
                          &staged);
}

/* Whole-frame CDEF driver (the in-C form of recon/cdef.py cdef_frame:
 * unit collection off the cdef-index/noskip grids, lane-batched
 * direction search on the pre-CDEF luma, variance-adjusted primary
 * strength, then one whole-plane filter pass per plane).  Phases keep
 * the Python flow's order so every unit's direction search reads
 * pre-CDEF pixels (reference cdef_brow, src/cdef_apply_tmpl.c). */
int dtpu_cdef_frame(int32_t *p0, int32_t *p1, int32_t *p2,
                     int64_t stride0, int64_t stride12, int bw, int bh,
                     int ss_hor, int ss_ver, int has_chroma,
                     int32_t *canvas0, int32_t *canvas1,
                     const int32_t *cdef_idx, int64_t ci_stride,
                     const uint8_t *noskip, int64_t ns_stride,
                     const int32_t *y_str, const int32_t *uv_str,
                     const int32_t *uv_dir_map, int damping, int bitdepth)
{
    const int bdmin8 = bitdepth - 8;
    const int nrows = (bh + 1) >> 1, ncols = (bw + 1) >> 1;
    const int64_t cap = (int64_t)nrows * ncols;
    int64_t *buf = malloc(sizeof(int64_t) * cap * 10);
    if (!buf)
        return 0;  /* caller falls back to the Python path */
    int64_t *ys = buf, *xs = buf + cap, *ypri = buf + 2 * cap,
            *ysec = buf + 3 * cap, *uvpri = buf + 4 * cap,
            *uvsec = buf + 5 * cap, *dirs = buf + 6 * cap,
            *vars = buf + 7 * cap, *dys = buf + 8 * cap,
            *dxs = buf + 9 * cap;
    int64_t n = 0;

    for (int r8 = 0; r8 < nrows; r8++) {
        const int32_t *cirow = cdef_idx + (int64_t)(r8 >> 3) * ci_stride;
        const uint8_t *ns0 = noskip + (int64_t)r8 * ns_stride;
        for (int c8 = 0; c8 < ncols; c8++) {
            const int idx = cirow[c8 >> 3];
            if (idx < 0)
                continue;
            const int ylvl = y_str[idx], uvlvl = uv_str[idx];
            if (!(ylvl | uvlvl))
                continue;
            int nsk = ns0[2 * c8];
            if (2 * c8 + 1 < bw)
                nsk |= ns0[2 * c8 + 1];
            if (!nsk)
                continue;
            ys[n] = (int64_t)r8 * 8;
            xs[n] = (int64_t)c8 * 8;
            ypri[n] = (ylvl >> 2) << bdmin8;
            int s = ylvl & 3;
            ysec[n] = (s + (s == 3)) << bdmin8;
            uvpri[n] = (uvlvl >> 2) << bdmin8;
            s = uvlvl & 3;
            uvsec[n] = (s + (s == 3)) << bdmin8;
            n++;
        }
    }
    if (!n) {
        free(buf);
        return 1;
    }

    /* banded luma pass: per unit-row band, run the direction search
     * (pre-CDEF reads — the band's own rows are not filtered yet, and
     * filtering never touches rows below the current band), adjust
     * strengths, then filter.  One walk over the plane instead of a
     * separate frame-wide direction pass whose rows are cache-cold
     * again by filter time. */
    const int64_t pw0 = (int64_t)bw * 4, ph0 = (int64_t)bh * 4;
    const int64_t bandcap = ncols + 1;
    int64_t *bpos = malloc(sizeof(int64_t) * bandcap * 4);
    if (!bpos) {
        free(buf);
        return 0;
    }
    int64_t staged = 0;
    for (int64_t u = 0; u < n;) {
        int64_t ub = u;
        const int64_t by = ys[u];
        while (ub < n && ys[ub] == by)
            ub++;
        /* dir search for this band's primary-strength units */
        int64_t ndb = 0;
        for (int64_t k = u; k < ub; k++)
            if (ypri[k] | uvpri[k]) {
                bpos[ndb] = ys[k];
                bpos[bandcap + ndb] = xs[k];
                ndb++;
            }
        if (ndb)
            dtpu_cdef_find_dir_pos(p0, stride0, bpos, bpos + bandcap,
                                   ndb, bitdepth, bpos + 2 * bandcap,
                                   bpos + 3 * bandcap);
        int64_t kk = 0;
        for (int64_t k = u; k < ub; k++) {
            if (ypri[k] | uvpri[k]) {
                dirs[k] = bpos[2 * bandcap + kk];
                vars[k] = bpos[3 * bandcap + kk];
                kk++;
            } else {
                dirs[k] = 0;
                vars[k] = 0;
            }
            /* variance-adjusted primary strength (reference
             * adjust_strength); dys/dxs become the luma plane's
             * per-unit p/dir arrays */
            int64_t yadj = 0;
            if (ypri[k] && vars[k]) {
                const int v6 = (int)(vars[k] >> 6);
                const int i = v6 ? imini(ulog2i(v6), 12) : 0;
                yadj = (ypri[k] * (4 + i) + 8) >> 4;
            }
            dys[k] = ypri[k] ? yadj : 0;
            dxs[k] = ypri[k] ? dirs[k] : 0;
        }
        cdef_filter_units_i16(p0, stride0, (int)pw0, (int)ph0,
                              (int16_t *)canvas0, ys, xs, dys, ysec,
                              dxs, u, ub, 8, 8, damping, bitdepth - 8,
                              &staged);
        u = ub;
    }
    free(bpos);

    if (has_chroma) {
        /* chroma coords/strengths/dirs in place: ys/xs shift to the
         * chroma grid, dirs remap via uv_dir_map, uvsec unpacks */
        for (int64_t u = 0; u < n; u++) {
            ys[u] >>= ss_ver;
            xs[u] >>= ss_hor;
            dirs[u] = uvpri[u] ? uv_dir_map[dirs[u]] : 0;
        }
        const int w = 8 >> ss_hor, h = 8 >> ss_ver;
        const int pwc = (int)(pw0 >> ss_hor), phc = (int)(ph0 >> ss_ver);
        dtpu_cdef_filter_plane(p1, stride12, pwc, phc, canvas1, ys, xs,
                               n, w, h, uvpri, uvsec, dirs, damping - 1,
                               bitdepth);
        dtpu_cdef_filter_plane(p2, stride12, pwc, phc, canvas1, ys, xs,
                               n, w, h, uvpri, uvsec, dirs, damping - 1,
                               bitdepth);
    }
    free(buf);
    return 1;
}

void dtpu_cdef_filter_plane(int32_t *plane, int64_t stride, int pw, int ph,
                            int32_t *canvas, const int64_t *ys,
                            const int64_t *xs, int64_t n, int w, int h,
                            const int64_t *pri, const int64_t *sec,
                            const int64_t *dirs, int damping, int bitdepth)
{
    /* int16 canvas path for every bitdepth: pixels <= 4095 fit, and
     * the shift-threshold linkage keeps sentinel-wrapped diffs
     * harmless (proof at cdef_filter_unit_perm above; the same
     * argument covers the generic i16 kernels' mask formulation) */
    if ((w == 8 || w == 4) && !(h & 1)) {
        cdef_filter_plane_i16(plane, stride, pw, ph, (int16_t *)canvas,
                              ys, xs, n, w, h, pri, sec, dirs, damping,
                              bitdepth - 8);
        return;
    }
    const int64_t cstride = pw + 4;
    for (int64_t x = 0; x < cstride * 2; x++)
        canvas[x] = CDEF_SENTINEL;
    for (int y = 0; y < ph; y++) {
        int32_t *crow = canvas + (int64_t)(y + 2) * cstride;
        crow[0] = crow[1] = crow[pw + 2] = crow[pw + 3] = CDEF_SENTINEL;
        memcpy(crow + 2, plane + (int64_t)y * stride,
               sizeof(int32_t) * pw);
    }
    for (int64_t x = 0; x < cstride * 2; x++)
        canvas[(int64_t)(ph + 2) * cstride + x] = CDEF_SENTINEL;

    for (int64_t u = 0; u < n; u++) {
        const int p = (int)pri[u], s = (int)sec[u];
        if (!p && !s)
            continue;
        /* unit positions are plane coords; canvas coords are +2 */
        const int32_t *base = canvas + (ys[u] + 2) * cstride + xs[u] + 2;
        int32_t *o = plane + ys[u] * stride + xs[u];
        cdef_filter_unit(base, cstride, w, h, p, s, (int)dirs[u],
                         damping, bitdepth, o, stride);
    }
}
