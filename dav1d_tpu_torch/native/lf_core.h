/* Width-generic deblock edge core, included twice by lf.c:
 *
 *   #define LF_CORE_NAME lf_core4_impl
 *   #define LF_VT        lf_v4
 *   #define LF_NL        4
 *   #include "lf_core.h"
 *
 * Lanes are edge lines; E/I/H arrive as per-lane vectors already
 * scaled by << (bitdepth - 8), so an 8-lane instantiation can filter
 * two adjacent 4-line cells with different filter levels in one pass
 * (the reference's 2x-unrolled asm cores, e.g. lpf_8 in
 * src/x86/loopfilter_avx2.asm, do the same).  The body is the
 * former lf_core4 verbatim with the type and the strength splats
 * parameterized. */

#define LFG_ABS(v)                                                      \
    ({ const LF_VT _m = (v) < 0; (LF_VT)(((v) ^ _m) - _m); })
#define LFG_BLEND(m, a, b) (LF_VT)(((a) & (m)) | ((b) & ~(m)))
#define LFG_CLAMP(v, lo, hi)                                            \
    ({ const LF_VT _c = LFG_BLEND((v) < (lo), (lo), (v));               \
       LFG_BLEND(_c > (hi), (hi), _c); })

static int LF_CORE_NAME(LF_VT *t, LF_VT vE, LF_VT vI, LF_VT vH, int wd,
                        int bitdepth)
{
    /* t[o+7] = tap vector for offset o in [-7, 6].  Returns 0 when no
     * lane passes the filter mask (caller skips the store-back). */
    const int bd_m8 = bitdepth - 8;
    const LF_VT zero = {0};
    const LF_VT vF = zero + (1 << bd_m8);
    const LF_VT vmaxp = zero + ((1 << bitdepth) - 1);
    const int cd_lim = 128 << bd_m8;
    const LF_VT vcd_hi = zero + (cd_lim - 1), vcd_lo = zero - cd_lim;

#define LD(o) (t[(o) + 7])
#define ST(o, v) (t[(o) + 7] = (v))
    const LF_VT p1 = LD(-2), p0 = LD(-1), q0 = LD(0), q1 = LD(1);
    LF_VT fm = (LFG_ABS(p1 - p0) <= vI) & (LFG_ABS(q1 - q0) <= vI) &
               (LFG_ABS(p0 - q0) * 2 + (LFG_ABS(p1 - q1) >> 1) <= vE);
    LF_VT p2 = zero, q2 = zero, p3 = zero, q3 = zero;
    if (wd > 4) {
        p2 = LD(-3);
        q2 = LD(2);
        fm &= (LFG_ABS(p2 - p1) <= vI) & (LFG_ABS(q2 - q1) <= vI);
        if (wd > 6) {
            p3 = LD(-4);
            q3 = LD(3);
            fm &= (LFG_ABS(p3 - p2) <= vI) & (LFG_ABS(q3 - q2) <= vI);
        }
    }
    {
        int32_t any = 0;
        for (int l = 0; l < LF_NL; l++)
            any |= fm[l];
        if (!any)
            return 0;
    }
    LF_VT flat8in = zero;
    if (wd >= 6)
        flat8in = (LFG_ABS(p2 - p0) <= vF) & (LFG_ABS(p1 - p0) <= vF) &
                  (LFG_ABS(q1 - q0) <= vF) & (LFG_ABS(q2 - q0) <= vF);
    if (wd >= 8)
        flat8in &= (LFG_ABS(p3 - p0) <= vF) & (LFG_ABS(q3 - q0) <= vF);

    /* narrow family (always computed: the cheap fallback lanes) */
    const LF_VT hev = (LFG_ABS(p1 - p0) > vH) | (LFG_ABS(q1 - q0) > vH);
    LF_VT fh = LFG_CLAMP(p1 - q1, vcd_lo, vcd_hi);
    fh = LFG_CLAMP(3 * (q0 - p0) + fh, vcd_lo, vcd_hi);
    const LF_VT fnh = LFG_CLAMP(3 * (q0 - p0), vcd_lo, vcd_hi);
    const LF_VT f = LFG_BLEND(hev, fh, fnh);
    const LF_VT f1 = LFG_BLEND(f + 4 < vcd_hi, f + 4, vcd_hi) >> 3;
    const LF_VT f2 = LFG_BLEND(f + 3 < vcd_hi, f + 3, vcd_hi) >> 3;
    const LF_VT g = (f1 + 1) >> 1;
    const LF_VT n_p0 = LFG_CLAMP(p0 + f2, zero, vmaxp);
    const LF_VT n_q0 = LFG_CLAMP(q0 - f1, zero, vmaxp);
    const LF_VT n_p1 = LFG_CLAMP(p1 + g, zero, vmaxp);
    const LF_VT n_q1 = LFG_CLAMP(q1 - g, zero, vmaxp);

    LF_VT m16 = zero, m8 = zero, m6 = zero;
    LF_VT p6 = zero, p5 = zero, p4 = zero, q4 = zero, q5 = zero,
          q6 = zero;
    if (wd >= 16) {
        p6 = LD(-7);
        p5 = LD(-6);
        p4 = LD(-5);
        q4 = LD(4);
        q5 = LD(5);
        q6 = LD(6);
        const LF_VT flat8out =
            (LFG_ABS(p6 - p0) <= vF) & (LFG_ABS(p5 - p0) <= vF) &
            (LFG_ABS(p4 - p0) <= vF) & (LFG_ABS(q4 - q0) <= vF) &
            (LFG_ABS(q5 - q0) <= vF) & (LFG_ABS(q6 - q0) <= vF);
        m16 = fm & flat8out & flat8in;
        m8 = fm & flat8in & ~m16;
    } else if (wd >= 8) {
        m8 = fm & flat8in;
    } else if (wd == 6) {
        m6 = fm & flat8in;
    }
    const LF_VT mwide = m16 | m8 | m6;
    const LF_VT mn = fm & ~mwide;           /* narrow */
    const LF_VT mn2 = mn & ~hev;            /* narrow side taps */

    if (wd >= 16) {
        const LF_VT e8 = zero + 8;
        ST(-6, LFG_BLEND(m16,
               (p6 * 7 + p5 * 2 + p4 * 2 + p3 + p2 + p1 + p0 + q0 + e8)
                   >> 4, LD(-6)));
        ST(-5, LFG_BLEND(m16,
               (p6 * 5 + p5 * 2 + p4 * 2 + p3 * 2 + p2 + p1 + p0 + q0 +
                q1 + e8) >> 4, LD(-5)));
        ST(-4, LFG_BLEND(m16,
               (p6 * 4 + p5 + p4 * 2 + p3 * 2 + p2 * 2 + p1 + p0 + q0 +
                q1 + q2 + e8) >> 4, LD(-4)));
        ST(3, LFG_BLEND(m16,
              (p2 + p1 + p0 + q0 + q1 + q2 * 2 + q3 * 2 + q4 * 2 + q5 +
               q6 * 4 + e8) >> 4, LD(3)));
        ST(4, LFG_BLEND(m16,
              (p1 + p0 + q0 + q1 + q2 + q3 * 2 + q4 * 2 + q5 * 2 +
               q6 * 5 + e8) >> 4, LD(4)));
        ST(5, LFG_BLEND(m16,
              (p0 + q0 + q1 + q2 + q3 + q4 * 2 + q5 * 2 + q6 * 7 + e8)
                  >> 4, LD(5)));
    }
    if (wd >= 8) {
        const LF_VT e4 = zero + 4, e8 = zero + 8;
        LF_VT v;
        v = LFG_BLEND(m8, (p3 + p3 + p3 + 2 * p2 + p1 + p0 + q0 + e4)
                              >> 3, LD(-3));
        if (wd >= 16)
            v = LFG_BLEND(m16,
                (p6 * 3 + p5 + p4 + p3 * 2 + p2 * 2 + p1 * 2 + p0 + q0 +
                 q1 + q2 + q3 + e8) >> 4, v);
        ST(-3, v);
        v = LFG_BLEND(m8, (p0 + q0 + q1 + 2 * q2 + q3 + q3 + q3 + e4)
                              >> 3, LD(2));
        if (wd >= 16)
            v = LFG_BLEND(m16,
                (p3 + p2 + p1 + p0 + q0 + q1 * 2 + q2 * 2 + q3 * 2 + q4 +
                 q5 + q6 * 3 + e8) >> 4, v);
        ST(2, v);
    }
    {
        const LF_VT e4 = zero + 4, e8 = zero + 8;
        /* offsets -2..1: all four families can write them */
        LF_VT v;
        v = LFG_BLEND(mn2, n_p1, p1);
        if (wd == 6)
            v = LFG_BLEND(m6, (p2 + 2 * p2 + 2 * p1 + 2 * p0 + q0 + e4)
                                  >> 3, v);
        if (wd >= 8)
            v = LFG_BLEND(m8, (p3 + p3 + p2 + 2 * p1 + p0 + q0 + q1 + e4)
                                  >> 3, v);
        if (wd >= 16)
            v = LFG_BLEND(m16,
                (p6 * 2 + p5 + p4 + p3 + p2 * 2 + p1 * 2 + p0 * 2 + q0 +
                 q1 + q2 + q3 + q4 + e8) >> 4, v);
        ST(-2, v);
        v = LFG_BLEND(mn, n_p0, p0);
        if (wd == 6)
            v = LFG_BLEND(m6, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + e4)
                                  >> 3, v);
        if (wd >= 8)
            v = LFG_BLEND(m8, (p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2 + e4)
                                  >> 3, v);
        if (wd >= 16)
            v = LFG_BLEND(m16,
                (p6 + p5 + p4 + p3 + p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 +
                 q2 + q3 + q4 + q5 + e8) >> 4, v);
        ST(-1, v);
        v = LFG_BLEND(mn, n_q0, q0);
        if (wd == 6)
            v = LFG_BLEND(m6, (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + e4)
                                  >> 3, v);
        if (wd >= 8)
            v = LFG_BLEND(m8, (p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3 + e4)
                                  >> 3, v);
        if (wd >= 16)
            v = LFG_BLEND(m16,
                (p5 + p4 + p3 + p2 + p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2 +
                 q3 + q4 + q5 + q6 + e8) >> 4, v);
        ST(0, v);
        v = LFG_BLEND(mn2, n_q1, q1);
        if (wd == 6)
            v = LFG_BLEND(m6, (p0 + 2 * q0 + 2 * q1 + 2 * q2 + q2 + e4)
                                  >> 3, v);
        if (wd >= 8)
            v = LFG_BLEND(m8, (p1 + p0 + q0 + 2 * q1 + q2 + q3 + q3 + e4)
                                  >> 3, v);
        if (wd >= 16)
            v = LFG_BLEND(m16,
                (p4 + p3 + p2 + p1 + p0 + q0 * 2 + q1 * 2 + q2 * 2 + q3 +
                 q4 + q5 + q6 * 2 + e8) >> 4, v);
        ST(1, v);
    }
#undef LD
#undef ST
    return 1;
}

#undef LFG_ABS
#undef LFG_BLEND
#undef LFG_CLAMP
#undef LF_CORE_NAME
#undef LF_VT
#undef LF_NL
