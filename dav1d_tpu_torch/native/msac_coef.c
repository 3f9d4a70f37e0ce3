/* Native entropy-decode core: MSAC range decoder + the coefficient
 * decode tail (the decoder's Amdahl bottleneck).
 *
 * Bit-exact with the Python reference implementations
 * (dav1d_tpu/msac.py, dav1d_tpu/recon/coef.py); semantics follow the
 * AV1 spec 8.2 symbol decoder with the reference's windowed formulation
 * (reference src/msac.c:36-220) and the coefficient parse of reference
 * decode_coefs (src/recon_tmpl.c:321-730).
 *
 * Built at import time with the system compiler (no pip deps); driven
 * via ctypes. CDF arrays are the caller's numpy uint16 buffers, mutated
 * in place exactly like the Python path.
 */

#include <stdint.h>
#include <stddef.h>
#include <string.h>

#include "dtpu.h"

#define EC_PROB_SHIFT 6
#define EC_MIN_PROB 4
#define EC_WIN_SIZE 64

static inline int ulog2_u32(uint32_t v) {
    return 31 - __builtin_clz(v);
}

static void refill(DtpuMsac *s) {
    int c = EC_WIN_SIZE - s->cnt - 24;
    uint64_t dif = s->dif;
    uint64_t pos = s->pos, end = s->end;
    const uint8_t *buf = s->buf;
    for (;;) {
        if (pos >= end) {
            dif |= ~(~(uint64_t)0xFF << c);
            break;
        }
        dif |= (uint64_t)(buf[pos] ^ 0xFF) << c;
        pos++;
        c -= 8;
        if (c < 0)
            break;
    }
    s->dif = dif;
    s->cnt = EC_WIN_SIZE - c - 24;
    s->pos = pos;
}

static inline void norm(DtpuMsac *s, uint64_t dif, uint32_t rng) {
    int d = 15 ^ ulog2_u32(rng);
    int cnt = s->cnt;
    s->dif = dif << d;
    s->rng = rng << d;
    s->cnt = cnt - d;
    if (cnt >= 0 && cnt < d)
        refill(s);
}

void dtpu_msac_init(DtpuMsac *s, const uint8_t *buf, uint64_t start,
                    uint64_t end, int disable_cdf_update) {
    s->buf = buf;
    s->pos = start;
    s->end = end;
    s->dif = 0;
    s->rng = 0x8000;
    s->cnt = -15;
    s->allow_update_cdf = !disable_cdf_update;
    refill(s);
}

int dtpu_decode_bool_equi(DtpuMsac *s) {
    uint32_t r = s->rng;
    uint64_t dif = s->dif;
    uint32_t v = ((r >> 8) << 7) + EC_MIN_PROB;
    uint64_t vw = (uint64_t)v << (EC_WIN_SIZE - 16);
    int ret;
    if (dif >= vw) {
        dif -= vw;
        v = r - v;
        ret = 0;
    } else {
        ret = 1;
    }
    norm(s, dif, v);
    return ret;
}

int dtpu_decode_bool(DtpuMsac *s, unsigned f) {
    uint32_t r = s->rng;
    uint64_t dif = s->dif;
    uint32_t v = ((r >> 8) * (f >> EC_PROB_SHIFT) >> (7 - EC_PROB_SHIFT))
                 + EC_MIN_PROB;
    uint64_t vw = (uint64_t)v << (EC_WIN_SIZE - 16);
    int ret;
    if (dif >= vw) {
        dif -= vw;
        v = r - v;
        ret = 0;
    } else {
        ret = 1;
    }
    norm(s, dif, v);
    return ret;
}

int dtpu_decode_symbol_adapt(DtpuMsac *s, uint16_t *cdf, size_t n_symbols) {
    uint32_t c = (uint32_t)(s->dif >> (EC_WIN_SIZE - 16));
    uint32_t r = s->rng >> 8;
    int val = -1;
    uint32_t v = s->rng, u;
    do {
        val++;
        u = v;
        v = r * (cdf[val] >> EC_PROB_SHIFT) >> (7 - EC_PROB_SHIFT);
        v += EC_MIN_PROB * ((unsigned)n_symbols - val);
    } while (c < v);
    norm(s, s->dif - ((uint64_t)v << (EC_WIN_SIZE - 16)), u - v);

    if (s->allow_update_cdf) {
        uint16_t count = cdf[n_symbols];
        int rate = 4 + (count >> 4) + (n_symbols > 2);
        int i = 0;
        for (; i < val; i++)
            cdf[i] += (32768 - cdf[i]) >> rate;
        for (; i < (int)n_symbols; i++)
            cdf[i] -= cdf[i] >> rate;
        cdf[n_symbols] = count + (count < 32);
    }
    return val;
}

int dtpu_decode_bool_adapt(DtpuMsac *s, uint16_t *cdf) {
    int bit = dtpu_decode_bool(s, cdf[0]);
    if (s->allow_update_cdf) {
        uint16_t count = cdf[1];
        int rate = 4 + (count >> 4);
        if (bit)
            cdf[0] += (32768 - cdf[0]) >> rate;
        else
            cdf[0] -= cdf[0] >> rate;
        cdf[1] = count + (count < 32);
    }
    return bit;
}

int dtpu_decode_hi_tok(DtpuMsac *s, uint16_t *cdf) {
    int tok_br = dtpu_decode_symbol_adapt(s, cdf, 3);
    int tok = 3 + tok_br;
    if (tok_br == 3) {
        tok_br = dtpu_decode_symbol_adapt(s, cdf, 3);
        tok = 6 + tok_br;
        if (tok_br == 3) {
            tok_br = dtpu_decode_symbol_adapt(s, cdf, 3);
            tok = 9 + tok_br;
            if (tok_br == 3)
                tok = 12 + dtpu_decode_symbol_adapt(s, cdf, 3);
        }
    }
    return tok;
}

unsigned dtpu_decode_bools(DtpuMsac *s, unsigned n) {
    unsigned v = 0;
    while (n--)
        v = (v << 1) | dtpu_decode_bool_equi(s);
    return v;
}

int dtpu_decode_uniform(DtpuMsac *s, unsigned n) {
    int l = ulog2_u32(n) + 1;
    unsigned m = (1u << l) - n;
    unsigned v = dtpu_decode_bools(s, l - 1);
    return v < m ? (int)v : (int)((v << 1) - m + dtpu_decode_bool_equi(s));
}

static int inv_recenter(unsigned r, unsigned v) {
    if (v > 2 * r)
        return v;
    if (v & 1)
        return r - ((v + 1) >> 1);
    return (v >> 1) + r;
}

int dtpu_decode_subexp(DtpuMsac *s, int ref, int n, unsigned k) {
    unsigned a = 0;
    if (dtpu_decode_bool_equi(s)) {
        if (dtpu_decode_bool_equi(s))
            k += dtpu_decode_bool_equi(s) + 1;
        a = 1u << k;
    }
    unsigned v = dtpu_decode_bools(s, k) + a;
    return ref * 2 <= n ? inv_recenter(ref, v)
                        : n - 1 - inv_recenter(n - 1 - ref, v);
}

static int read_golomb(DtpuMsac *s) {
    int len = 0;
    unsigned val = 1;
    while (!dtpu_decode_bool_equi(s) && len < 32)
        len++;
    while (len--)
        val = (val << 1) + dtpu_decode_bool_equi(s);
    return val - 1;
}

/* ---- coefficient decode tail (post-txtp) -------------------------------
 *
 * Own formulation (AV1 spec 5.11.39 coeffs() syntax + 8.3.2 context
 * derivation), structured as three phases over plain data:
 *
 *   1. magnitude phase (reverse scan order, eob..1 then DC): clamped
 *      magnitudes min(level, 15) land in the `levels` context plane and
 *      in cf[pos]; nonzero AC positions are collected into nz[].
 *   2. DC sign + dequant.
 *   3. AC signs + dequant in forward scan order (nz[] walked backward).
 *
 * Neighbor contexts are the spec's sums computed directly:
 *   coeff_base ctx : offset(pos) + min(4, (1 + sum_{5 nbrs} min(3, lvl)) >> 1)
 *   coeff_br  ctx : offset(pos) + min(6, (1 + sum_{3 nbrs} lvl) >> 1)
 * (levels values are <= 15, so the 3-neighbor br sum needs no clamp.)
 *
 * cf[] uses this decoder's coefficient-plane ABI: position index
 * rc = (x << (slh+2)) | y, i.e. a column-major (4<<slw, 4<<slh) plane —
 * chosen so the batched device itx consumes one fixed layout for every
 * tx class (see ops/itx.py).
 */

#define TX_CLASS_2D 0
#define TX_CLASS_H 1
#define TX_CLASS_V 2

/* 5-neighbor base-magnitude and 3-neighbor br-magnitude sums at `base`
 * in the levels plane.  Neighbor sets per spec: 2D uses (+1 row, +1 col,
 * +1+1 diag) for br and additionally (+2 row, +2 col) for base; the 1-D
 * classes scan along their axis (+1..+4 along, +1 across). */
static inline unsigned min3_(unsigned v) { return v < 3 ? v : 3; }

static inline void nbr_mags(const uint8_t *levels, int base, int tx_class,
                            int stride, unsigned *base_mag,
                            unsigned *br_mag) {
    const unsigned l0 = levels[base + stride], l1 = levels[base + 1];
    if (tx_class == TX_CLASS_2D) {
        const unsigned l2 = levels[base + stride + 1];
        *br_mag = l0 + l1 + l2;
        *base_mag = min3_(l0) + min3_(l1) + min3_(l2)
                    + min3_(levels[base + 2])
                    + min3_(levels[base + 2 * stride]);
    } else {
        const unsigned l2 = levels[base + 2];
        *br_mag = l0 + l1 + l2;
        *base_mag = min3_(l0) + min3_(l1) + min3_(l2)
                    + min3_(levels[base + 3]) + min3_(levels[base + 4]);
    }
}

static inline int base_ctx_from_mag(unsigned mag) {
    unsigned v = (mag + 1) >> 1;
    return v < 4 ? (int)v : 4;
}

static inline int br_ctx_from_mag(unsigned mag) {
    unsigned v = (mag + 1) >> 1;
    return v < 6 ? (int)v : 6;
}

/* Returns res_ctx (cul_level | dc_sign_level); fills cf, *eob_out.
 * cdf row pointers are pre-selected by the caller. */
int dtpu_decode_coefs_tail(
    DtpuMsac *s,
    int tctx, int chroma, int tx2dszctx, int tx_class, int slw, int slh,
    int dbg_tx_is_rect_nonsq,          /* unused (kept for ABI) */
    uint16_t *eob_bin_cdf, int eob_bin_nsym,
    uint16_t *eob_hi_bit_cdf,          /* (9, 2) row-major */
    uint16_t *eob_base_tok_cdf,        /* (4, 4) */
    uint16_t *base_tok_cdf,            /* (41, 4) */
    uint16_t *br_tok_cdf,              /* (21, 4) */
    uint16_t *dc_sign_cdf,             /* (3, 2) */
    const uint16_t *scan,              /* or NULL for 1-D classes */
    const uint8_t *lo_ctx_offsets,     /* (5,5) or NULL */
    int dc_sign_ctx,
    int dq0, int dq1, const uint8_t *qm, int dq_shift, uint32_t cf_max,
    int32_t *cf, uint8_t *levels_buf, int *eob_out)
{
    /* eob: class symbol, then optional hi bit + literal low bits
     * (spec eob_pt / eob_extra) */
    int eob = dtpu_decode_symbol_adapt(s, eob_bin_cdf, eob_bin_nsym);
    if (eob > 1) {
        int eob_bin = eob - 2;
        int hi = dtpu_decode_bool_adapt(s, &eob_hi_bit_cdf[2 * eob_bin]);
        eob = ((hi | 2) << eob_bin) | dtpu_decode_bools(s, eob_bin);
    }
    *eob_out = eob;

    unsigned dc_tok;
    uint16_t nz[1023];                 /* nonzero AC positions, high->low */
    int n_nz = 0;
    uint8_t *levels = levels_buf;

    if (eob) {
        int stride, shift, shift2, mask;
        if (tx_class == TX_CLASS_2D) {
            stride = 4 << slh;
            shift = slh + 2;
            shift2 = 0;
            mask = (4 << slh) - 1;
            memset(levels, 0, (size_t)stride * ((4 << slw) + 2));
        } else if (tx_class == TX_CLASS_H) {
            stride = 16;
            shift = slh + 2;
            shift2 = 0;
            mask = (4 << slh) - 1;
            memset(levels, 0, (size_t)stride * ((4 << slh) + 2));
        } else {
            stride = 16;
            shift = slw + 2;
            shift2 = slh + 2;
            mask = (4 << slw) - 1;
            memset(levels, 0, (size_t)stride * ((4 << slw) + 2));
        }

        /* magnitude at the eob position (coeff_base_eob: min level 1) */
        int ctx = 1 + (eob > (2 << tx2dszctx)) + (eob > (4 << tx2dszctx));
        unsigned tok = 1 + dtpu_decode_symbol_adapt(
            s, &eob_base_tok_cdf[4 * ctx], 2);
        unsigned x, y, rc;
        if (tx_class == TX_CLASS_2D) {
            rc = scan[eob];
            x = rc >> shift;
            y = rc & mask;
        } else if (tx_class == TX_CLASS_H) {
            x = eob & mask;
            y = eob >> shift;
            rc = eob;
        } else {
            x = eob & mask;
            y = eob >> shift;
            rc = (x << shift2) | y;
        }
        if (tok == 3) {
            ctx = (tx_class == TX_CLASS_2D ? (x | y) > 1 : y != 0) ? 14 : 7;
            tok = dtpu_decode_hi_tok(s, &br_tok_cdf[4 * ctx]);
        }
        cf[rc] = (int32_t)tok;
        nz[n_nz++] = (uint16_t)rc;
        levels[tx_class == TX_CLASS_2D ? (int)rc : (int)(x * stride + y)]
            = (uint8_t)tok;

        /* remaining AC magnitudes, reverse scan order */
        for (int i = eob - 1; i > 0; i--) {
            unsigned rc_i;
            if (tx_class == TX_CLASS_2D) {
                rc_i = scan[i];
                x = rc_i >> shift;
                y = rc_i & mask;
            } else if (tx_class == TX_CLASS_H) {
                x = i & mask;
                y = i >> shift;
                rc_i = i;
            } else {
                x = i & mask;
                y = i >> shift;
                rc_i = (x << shift2) | y;
            }
            const int lvl_base = tx_class == TX_CLASS_2D
                ? (int)rc_i : (int)(x * stride + y);
            unsigned base_mag, br_mag;
            nbr_mags(levels, lvl_base, tx_class, stride, &base_mag, &br_mag);
            const int offset = tx_class == TX_CLASS_2D
                ? lo_ctx_offsets[5 * (y < 4 ? y : 4) + (x < 4 ? x : 4)]
                : 26 + (y > 1 ? 10 : (int)y * 5);
            ctx = offset + base_ctx_from_mag(base_mag);
            tok = dtpu_decode_symbol_adapt(s, &base_tok_cdf[4 * ctx], 3);
            if (tok == 3) {
                const unsigned far = tx_class == TX_CLASS_2D
                    ? (x | y) > 1 : y > 0;
                ctx = (far ? 14 : 7) + br_ctx_from_mag(br_mag);
                tok = dtpu_decode_hi_tok(s, &br_tok_cdf[4 * ctx]);
            }
            levels[lvl_base] = (uint8_t)tok;
            if (tok) {
                cf[rc_i] = (int32_t)tok;
                nz[n_nz++] = (uint16_t)rc_i;
            }
        }

        /* DC magnitude */
        unsigned br_mag = 0;
        if (tx_class == TX_CLASS_2D) {
            ctx = 0;
        } else {
            unsigned base_mag;
            nbr_mags(levels, 0, tx_class, stride, &base_mag, &br_mag);
            ctx = 26 + base_ctx_from_mag(base_mag);
        }
        dc_tok = dtpu_decode_symbol_adapt(s, &base_tok_cdf[4 * ctx], 3);
        if (dc_tok == 3) {
            if (tx_class == TX_CLASS_2D)
                br_mag = (unsigned)levels[1] + levels[stride]
                         + levels[stride + 1];
            dc_tok = dtpu_decode_hi_tok(
                s, &br_tok_cdf[4 * br_ctx_from_mag(br_mag)]);
        }
    } else {
        /* eob == 0: DC only */
        dc_tok = 1 + dtpu_decode_symbol_adapt(s, &eob_base_tok_cdf[0], 2);
        if (dc_tok == 3)
            dc_tok = dtpu_decode_hi_tok(s, &br_tok_cdf[0]);
    }

    /* DC sign + dequant (spec 7.12.3: golomb extension beyond 15,
     * 24-bit wrap, clip to the bitdepth's coefficient range) */
    unsigned cul_level;
    unsigned dc_sign_level;

    if (!dc_tok) {
        cul_level = 0;
        dc_sign_level = 1 << 6;
    } else {
        const int dc_sign =
            dtpu_decode_bool_adapt(s, dc_sign_cdf + 2 * dc_sign_ctx);
        unsigned dc_dq = dq0;
        dc_sign_level = (dc_sign - 1) & (2 << 6);
        if (qm)
            dc_dq = (dc_dq * qm[0] + 16) >> 5;
        if (dc_tok == 15) {
            dc_tok = (read_golomb(s) + 15) & 0xFFFFF;
            dc_dq = (dc_dq * dc_tok) & 0xFFFFFF;
        } else {
            dc_dq *= dc_tok;
        }
        cul_level = dc_tok;
        dc_dq >>= dq_shift;
        if (dc_dq > cf_max + dc_sign)
            dc_dq = cf_max + dc_sign;
        cf[0] = dc_sign ? -(int32_t)dc_dq : (int32_t)dc_dq;
    }

    /* AC signs + dequant, forward scan order */
    for (int k = n_nz - 1; k >= 0; k--) {
        const unsigned rc = nz[k];
        const int sign = dtpu_decode_bool_equi(s);
        unsigned tok = (unsigned)cf[rc];
        unsigned dq = qm ? (dq1 * qm[rc] + 16) >> 5 : (unsigned)dq1;
        if (tok == 15) {
            tok = (read_golomb(s) + 15) & 0xFFFFF;
            dq = (dq * tok) & 0xFFFFFF;
        } else {
            dq *= tok;
        }
        dq >>= dq_shift;
        if (dq > cf_max + sign)
            dq = cf_max + sign;
        cul_level += tok;
        cf[rc] = sign ? -(int32_t)dq : (int32_t)dq;
    }

    return (int)((cul_level < 63 ? cul_level : 63) | dc_sign_level);
}

/* ---- full coefficient decode (skip ctx + txtp + tail) ------------------- */

/* Mirrors recon/coef.py decode_coefs end to end (reference decode_coefs,
 * src/recon_tmpl.c:321-730) so the Python hot loop makes ONE native call
 * per tx block.  Per-tile pointers live in DtpuCoefCtx (built once per
 * tile state on the Python side); per-call parameters are plain ints. */

#define TXFM_TYPE_DCT_DCT 0
#define TXFM_TYPE_IDTX 9
#define TXFM_TYPE_WHT 16
#define UV_INTER_DCT_MASK \
    ((1u << 12) | (1u << 13) | (1u << 14) | (1u << 15)) /* V/H (FLIP)ADST */

/* Returns (txtp << 16) | res_ctx; *eob_out = -1 on all-skip.
 * y_mode_nofilt: FILTER_PRED already resolved by the caller.  cf must be
 * n_coef int32s (zero-filled here). */
int dtpu_decode_coefs(
    DtpuCoefCtx *cx, DtpuMsac *s,
    const uint8_t *a, int a_off, const uint8_t *l, int l_off,
    int tx, int bs, int intra, int plane,
    int y_mode_nofilt, int uv_mode, int ytxtp,
    int lossless, int qidx_nonzero, int reduced_txtp_set,
    int dq0, int dq1, const uint8_t *qm,
    int32_t *cf, int *eob_out)
{
    const uint8_t *ti = cx->txfm_info + 8 * tx;
    const int lw = ti[2], lh = ti[3];
    const int tmin = ti[4], tmax = ti[5], tctx = ti[7];
    const int chroma = plane != 0;
    const uint8_t *bd = cx->block_dim + 4 * bs;
    a += a_off;
    l += l_off;

    /* skip context (reference get_skip_ctx, src/recon_tmpl.c:60-139) */
    int sctx;
    if (chroma) {
        const int ss_ver = cx->layout == 1;
        const int ss_hor = cx->layout != 3;
        const int not_one_blk =
            (bd[2] - ((bd[2] != 0) && ss_hor) > lw) ||
            (bd[3] - ((bd[3] != 0) && ss_ver) > lh);
        int ca = 0, cl = 0;
        for (int i = 0; i < (1 << lw); i++)
            ca |= a[i] != 0x40;
        for (int i = 0; i < (1 << lh); i++)
            cl |= l[i] != 0x40;
        sctx = 7 + not_one_blk * 3 + ca + cl;
    } else if (bd[2] == lw && bd[3] == lh) {
        sctx = 0;
    } else {
        unsigned la = 0, ll = 0;
        int na = 1 << lw, nl = 1 << lh;
        if (na > 16) na = 16;
        if (nl > 16) nl = 16;
        for (int i = 0; i < na; i++)
            la |= a[i];
        for (int i = 0; i < nl; i++)
            ll |= l[i];
        la &= 0x3F;
        ll &= 0x3F;
        sctx = cx->skip_ctx_tbl[5 * (la < 4 ? la : 4) + (ll < 4 ? ll : 4)];
    }

    const int all_skip =
        dtpu_decode_bool_adapt(s, cx->skip + 2 * (13 * tctx + sctx));
    if (all_skip) {
        *eob_out = -1;
        return ((lossless ? TXFM_TYPE_WHT : TXFM_TYPE_DCT_DCT) << 16) | 0x40;
    }

    /* transform type (reference src/recon_tmpl.c:377-434) */
    int txtp;
    if (lossless) {
        txtp = TXFM_TYPE_WHT;
    } else if (tmax + intra >= 4 /* TX_64X64 */) {
        txtp = TXFM_TYPE_DCT_DCT;
    } else if (chroma) {
        if (intra) {
            txtp = cx->txtp_from_uvmode[uv_mode];
        } else if (tmax == 3 /* env.h get_uv_inter_txtp */) {
            txtp = ytxtp == TXFM_TYPE_IDTX ? TXFM_TYPE_IDTX
                                           : TXFM_TYPE_DCT_DCT;
        } else if (tmin == 2 && ((1u << ytxtp) & UV_INTER_DCT_MASK)) {
            txtp = TXFM_TYPE_DCT_DCT;
        } else {
            txtp = ytxtp;
        }
    } else if (!qidx_nonzero) {
        txtp = TXFM_TYPE_DCT_DCT;
    } else if (intra) {
        if (reduced_txtp_set || tmin == 2 /* TX_16X16 */) {
            int idx = dtpu_decode_symbol_adapt(
                s, cx->txtp_intra2 + 8 * (13 * tmin + y_mode_nofilt), 4);
            txtp = cx->tx_types_per_set[idx];
        } else {
            int idx = dtpu_decode_symbol_adapt(
                s, cx->txtp_intra1 + 8 * (13 * tmin + y_mode_nofilt), 6);
            txtp = cx->tx_types_per_set[idx + 5];
        }
    } else {
        if (reduced_txtp_set || tmax == 3 /* TX_32X32 */) {
            int idx = dtpu_decode_bool_adapt(s, cx->txtp_inter3 + 2 * tmin);
            txtp = idx ? TXFM_TYPE_DCT_DCT : TXFM_TYPE_IDTX;
        } else if (tmin == 2 /* TX_16X16 */) {
            int idx = dtpu_decode_symbol_adapt(s, cx->txtp_inter2, 11);
            txtp = cx->tx_types_per_set[idx + 12];
        } else {
            int idx = dtpu_decode_symbol_adapt(
                s, cx->txtp_inter1 + 16 * tmin, 15);
            txtp = cx->tx_types_per_set[idx + 24];
        }
    }

    if (txtp >= TXFM_TYPE_IDTX)
        qm = NULL; /* QM only for the 2-D non-identity types */

    /* tail setup (mirrors recon/coef.py decode_coefs:146-164) */
    const int slw = lw < 3 ? lw : 3, slh = lh < 3 ? lh : 3;
    const int tx2dszctx = slw + slh;
    const int tx_class = cx->tx_type_class[txtp];
    const int is_1d = tx_class != TX_CLASS_2D;

    static const int eob_nsym[7] = {4, 5, 6, 7, 8, 9, 10};
    uint16_t *eob_bin_cdf = cx->eob_bin[tx2dszctx];
    eob_bin_cdf += tx2dszctx < 5
        ? (2 * chroma + is_1d) * (tx2dszctx == 4 ? 16 : 8)
        : 16 * chroma;

    const uint16_t *scan = NULL;
    const uint8_t *lo_ctx_offsets = NULL;
    if (tx_class == TX_CLASS_2D) {
        scan = cx->scans[tx];
        const int nonsq = tx >= 5; /* RTX_4X8 */
        lo_ctx_offsets = cx->lo_ctx_offsets + 25 * (nonsq + (tx & nonsq));
    }

    /* dc-sign context (reference get_dc_sign_ctx, src/recon_tmpl.c:141) */
    {
        int na = 1 << lw, nl = 1 << lh;
        int sum = -(na + nl);
        for (int i = 0; i < na; i++)
            sum += a[i] >> 6;
        for (int i = 0; i < nl; i++)
            sum += l[i] >> 6;
        int dc_sign_ctx = (sum != 0) + (sum > 0);

        memset(cf, 0, sizeof(int32_t) * ((4 << slw) * (4 << slh)));
        uint8_t levels_buf[34 * 34 + 16];
        const int btc = tctx < 3 ? tctx : 3;
        int res = dtpu_decode_coefs_tail(
            s, tctx, chroma, tx2dszctx, tx_class, slw, slh, 0,
            eob_bin_cdf, eob_nsym[tx2dszctx],
            cx->eob_hi_bit + 2 * 9 * (2 * tctx + chroma),
            cx->eob_base_tok + 4 * 4 * (2 * tctx + chroma),
            cx->base_tok + 4 * 41 * (2 * tctx + chroma),
            cx->br_tok + 4 * 21 * (2 * btc + chroma),
            cx->dc_sign + 2 * 3 * chroma,
            scan, lo_ctx_offsets, dc_sign_ctx,
            dq0, dq1, qm, tctx > 2 ? tctx - 2 : 0, cx->cf_max,
            cf, levels_buf, eob_out);
        return (txtp << 16) | res;
    }
}

/* ---- pass-1 intra coefficient walk ------------------------------------- */

static inline int cimin(int a, int b) { return a < b ? a : b; }

/* All luma + chroma coefficient blocks of one intra block in pass 1, in
 * the exact decode order of recon/intra.py recon_b_intra (reference
 * dav1d_recon_b_intra, src/recon_tmpl.c:1176-1556: 16x16-subblock
 * raster, luma then u then v per subblock).  Coefficients land in
 * arena[n * arena_stride ..]; meta[n] = {eob, txtp}.  Returns the entry
 * count n (skip blocks produce 0 entries but still reset the contexts,
 * mirroring _coef_y/_coef_uv).  The Python glue rebuilds the capture
 * records by replaying the same geometry. */
int dtpu_intra_coefs_pass1(
    DtpuCoefCtx *cx, DtpuMsac *s,
    int bx, int by, int w4, int h4, int bx4, int by4,
    int fbw, int fbh, int ss_hor, int ss_ver, int has_chroma,
    int tx, int uvtx, int bs, int skip,
    int y_mode_nofilt, int uv_mode,
    int lossless, int qidx_nonzero, int reduced_txtp_set,
    int dqy0, int dqy1, int dqu0, int dqu1, int dqv0, int dqv1,
    const uint8_t *qm_y, const uint8_t *qm_u, const uint8_t *qm_v,
    uint8_t *a_lcoef, uint8_t *l_lcoef,
    uint8_t *a_ccoef0, uint8_t *l_ccoef0,
    uint8_t *a_ccoef1, uint8_t *l_ccoef1,
    int32_t *arena, int arena_stride, int32_t *meta)
{
    const uint8_t *ti = cx->txfm_info;
    const int tw = ti[8 * tx + 0], th = ti[8 * tx + 1];
    const int utw = ti[8 * uvtx + 0], uth = ti[8 * uvtx + 1];
    const int cbx4 = bx4 >> ss_hor, cby4 = by4 >> ss_ver;
    const int cw4 = (w4 + ss_hor) >> ss_hor;
    const int ch4 = (h4 + ss_ver) >> ss_ver;
    int n = 0;

    for (int init_y = 0; init_y < h4; init_y += 16) {
        const int sub_h4 = cimin(h4, 16 + init_y);
        const int sub_ch4 = cimin(ch4, (init_y + 16) >> ss_ver);
        for (int init_x = 0; init_x < w4; init_x += 16) {
            const int sub_w4 = cimin(w4, init_x + 16);
            const int sub_cw4 = cimin(cw4, (init_x + 16) >> ss_hor);

            for (int y = init_y; y < sub_h4; y += th)
                for (int x = init_x; x < sub_w4; x += tw) {
                    if (skip) {
                        memset(a_lcoef + bx4 + x, 0x40, tw);
                        memset(l_lcoef + by4 + y, 0x40, th);
                        continue;
                    }
                    int eob;
                    const int ret = dtpu_decode_coefs(
                        cx, s, a_lcoef, bx4 + x, l_lcoef, by4 + y,
                        tx, bs, 1, 0, y_mode_nofilt, uv_mode, 0,
                        lossless, qidx_nonzero, reduced_txtp_set,
                        dqy0, dqy1, qm_y,
                        arena + (int64_t)n * arena_stride, &eob);
                    memset(a_lcoef + bx4 + x, ret & 0xFFFF,
                           cimin(tw, fbw - (bx + x)));
                    memset(l_lcoef + by4 + y, ret & 0xFFFF,
                           cimin(th, fbh - (by + y)));
                    meta[2 * n] = eob;
                    meta[2 * n + 1] = ret >> 16;
                    n++;
                }

            if (!has_chroma)
                continue;
            const int icx = init_x >> ss_hor, icy = init_y >> ss_ver;
            for (int pl = 0; pl < 2; pl++) {
                uint8_t *ac = pl ? a_ccoef1 : a_ccoef0;
                uint8_t *lc = pl ? l_ccoef1 : l_ccoef0;
                const int dq0 = pl ? dqv0 : dqu0;
                const int dq1 = pl ? dqv1 : dqu1;
                const uint8_t *qm = pl ? qm_v : qm_u;
                for (int y = icy; y < sub_ch4; y += uth)
                    for (int x = icx; x < sub_cw4; x += utw) {
                        if (skip) {
                            memset(ac + cbx4 + x, 0x40, utw);
                            memset(lc + cby4 + y, 0x40, uth);
                            continue;
                        }
                        int eob;
                        const int ret = dtpu_decode_coefs(
                            cx, s, ac, cbx4 + x, lc, cby4 + y,
                            uvtx, bs, 1, 1 + pl, y_mode_nofilt, uv_mode,
                            0, lossless, qidx_nonzero, reduced_txtp_set,
                            dq0, dq1, qm,
                            arena + (int64_t)n * arena_stride, &eob);
                        memset(ac + cbx4 + x, ret & 0xFFFF,
                               cimin(utw, (fbw - (bx + (x << ss_hor))
                                           + ss_hor) >> ss_hor));
                        memset(lc + cby4 + y, ret & 0xFFFF,
                               cimin(uth, (fbh - (by + (y << ss_ver))
                                           + ss_ver) >> ss_ver));
                        meta[2 * n] = eob;
                        meta[2 * n + 1] = ret >> 16;
                        n++;
                    }
            }
        }
    }
    return n;
}
