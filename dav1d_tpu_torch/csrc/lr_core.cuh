// The arithmetic of the loop-restoration kernels (csrc/lr.cu): the
// phases of one column chunk of one stripe unit, over the chunk's shared
// arrays.
//
// A job is one stripe unit of one plane (ops/lr.py job_table): its
// origin (x, y), width uw <= 384 and height sh <= 64, LR edge flags, the
// plane's height h (the last row the bottom context may read is h - 1)
// and six filter parameters: the Wiener half-filters fh[3], fv[3], or
// the self-guided s0, s1, w0, w1 and variant (0: 5x5 only, 1: 3x3 only,
// 2: both).  A CTA takes one chunk of CW output columns of one job.  Its
// phases, each a loop that thread `tid` of `nt` runs over its share:
//
//   stage   the padded window, (sh + 6) x (cw + 6), from the post-CDEF
//           plane and the pre-CDEF snapshot (recon/lr_apply
//           _pad_unit_indices): columns clamped at an absent left or
//           right edge and to the plane; the three rows above from the
//           snapshot's rows y - 2, y - 2, y - 1 with a top edge, else
//           the unit's first row; the three below from the snapshot's
//           rows y + sh, then min(y + sh + 1, h - 1) twice with a bottom
//           edge, else the unit's last row;
//   Wiener  the horizontal 7-tap pass into an int32 intermediate
//           (+2^(bd+6) + 2^(rb_h-1), >> rb_h, clipped to
//           [0, 2^(bd+8-rb_h))), then the vertical pass (rounded by rb_v
//           about 2^(bd+rb_v-1), clipped to the bit depth) into the
//           output (reference wiener_filter_h/v,
//           src/looprestoration_tmpl.c:44-190);
//   SGR     the (A, B) rows of the 3x3 boxes (every row -1..sh) and of
//           the 5x5 boxes (odd rows), then per pixel the 3x3 weights
//           4/3 (>> 9) and the 5x5 weights 6/5 on even rows (>> 9) and
//           odd rows (>> 8), blended src + ((w0 t5 + w1 t3 + 2^10) >>
//           11) and clipped (reference sgr_5x5_c / sgr_3x3_c /
//           sgr_mix_c, src/looprestoration_tmpl.c:679-1090).
//
// Exactness: z = (p s + 2^19) >> 20 and A = (x su one_by_x + 2^11) >> 12
// exceed int32 at 12-bit; both are int64 products here.  (The plain
// version, ops/lr.py, keeps int32 with the JAX package's split multiply;
// the host tests hold the two forms equal at 12-bit on extreme pixels.)
// Every other intermediate fits int32: box sums <= 25 * 4095, square
// sums <= 25 * 4095^2, the weighted (A, B) sums and the blend < 2^27.
//
// The kernels read the post-CDEF plane and write a separate output
// plane: a unit's window overlaps its neighbours' pixels by 3 columns,
// which must be the unfiltered ones.
//
// The header compiles as CUDA device code (included by lr.cu) and as
// plain C++ (a host build runs the same phases thread by thread), so
// nothing outside the LR_* macros uses a CUDA builtin.
#pragma once

#ifdef __CUDACC__
#define LR_FN __device__ inline
#define LR_CONST __constant__
#define LR_LDG(p) __ldg(p)
#define LR_TRAP() __trap()
#else
#include <stdlib.h>
#define LR_FN inline
#define LR_CONST
#define LR_LDG(p) (*(p))
#define LR_TRAP() abort()
#endif

namespace lr {

// Columns of a job row (int32, ops/lr.py job_table).
constexpr int JOB_COLS = 12;
constexpr int J_X = 0, J_Y = 1, J_UW = 2, J_SH = 3, J_EDGES = 4, J_H = 5,
              J_P = 6;
constexpr int MAX_UW = 384, MAX_SH = 64;
// edge flags (recon/lr_apply.py LR_HAVE_*)
constexpr int HAVE_LEFT = 1, HAVE_RIGHT = 2, HAVE_TOP = 4, HAVE_BOTTOM = 8;
// output columns of a CTA
constexpr int WIENER_CW = 64, SGR_CW = 32;

// tables.sgr_x_by_x
LR_CONST const int X_BY_X[256] = {
    255, 128, 85, 64, 51, 43, 37, 32, 28, 26, 23, 21, 20, 18, 17, 16,
    15,  14,  13, 13, 12, 12, 11, 11, 10, 10, 9,  9,  9,  9,  8,  8,
    8,   8,   7,  7,  7,  7,  7,  6,  6,  6,  6,  6,  6,  6,  5,  5,
    5,   5,   5,  5,  5,  5,  5,  5,  4,  4,  4,  4,  4,  4,  4,  4,
    4,   4,   4,  4,  4,  4,  4,  4,  4,  3,  3,  3,  3,  3,  3,  3,
    3,   3,   3,  3,  3,  3,  3,  3,  3,  3,  3,  3,  3,  3,  3,  3,
    3,   3,   3,  3,  3,  3,  2,  2,  2,  2,  2,  2,  2,  2,  2,  2,
    2,   2,   2,  2,  2,  2,  2,  2,  2,  2,  2,  2,  2,  2,  2,  2,
    2,   2,   2,  2,  2,  2,  2,  2,  2,  2,  2,  2,  2,  2,  2,  2,
    2,   2,   2,  2,  2,  2,  2,  2,  2,  2,  2,  2,  2,  2,  2,  2,
    2,   2,   2,  2,  2,  2,  2,  2,  2,  2,  1,  1,  1,  1,  1,  1,
    1,   1,   1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,
    1,   1,   1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,
    1,   1,   1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,
    1,   1,   1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,
    1,   1,   1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  0,
};

// The planes of a launch: the post-CDEF plane, the pre-CDEF snapshot and
// the output, each (H, W) int32 with row stride W.
struct Planes {
    const int* post;
    const int* pre;
    int* out;
    int H, W, bd;
};

// One job's chunk: the job row and the chunk's first column (relative
// to the unit) and width.
struct Job {
    int x, y, uw, sh, edges, h;
    int p[6];
    int cx0, cw;
};

// Job row `row`, chunk `chunk` of cw_max columns; false when the chunk
// lies beyond the unit.  Traps on a unit the kernels do not take.
LR_FN bool load_job(Job& j, const int* row, int chunk, int cw_max) {
    j.x = LR_LDG(row + J_X);
    j.y = LR_LDG(row + J_Y);
    j.uw = LR_LDG(row + J_UW);
    j.sh = LR_LDG(row + J_SH);
    j.edges = LR_LDG(row + J_EDGES);
    j.h = LR_LDG(row + J_H);
    for (int k = 0; k < 6; k++) j.p[k] = LR_LDG(row + J_P + k);
    if (j.uw < 1 || j.uw > MAX_UW || j.sh < 1 || j.sh > MAX_SH) LR_TRAP();
    j.cx0 = chunk * cw_max;
    if (j.cx0 >= j.uw) return false;
    j.cw = j.uw - j.cx0 < cw_max ? j.uw - j.cx0 : cw_max;
    return true;
}

// Plane row of window row r (0 <= r < sh + 6).
LR_FN const int* win_row(const Job& j, const Planes& p, int r) {
    long long y;
    const int* base = p.post;
    if (r < 3) {
        if (j.edges & HAVE_TOP) {
            base = p.pre;
            y = j.y - 2 + (r == 2);
        } else {
            y = j.y;
        }
    } else if (r < 3 + j.sh) {
        y = j.y + r - 3;
    } else if (j.edges & HAVE_BOTTOM) {
        base = p.pre;
        y = r == 3 + j.sh ? j.y + j.sh
                          : (j.y + j.sh + 1 < j.h - 1 ? j.y + j.sh + 1
                                                      : j.h - 1);
    } else {
        y = j.y + j.sh - 1;
    }
    return base + y * p.W;
}

// Plane column of window column c (0 <= c < cw + 6).
LR_FN int win_col(const Job& j, const Planes& p, int c) {
    int x = j.x + j.cx0 + c - 3;
    if (!(j.edges & HAVE_LEFT) && x < j.x) x = j.x;
    if (!(j.edges & HAVE_RIGHT) && x > j.x + j.uw - 1) x = j.x + j.uw - 1;
    return x < 0 ? 0 : (x > p.W - 1 ? p.W - 1 : x);
}

// The padded window into win (row stride ws = cw_max + 6), DEPTH reads
// of a thread in flight before their stores.
constexpr int DEPTH = 4;

LR_FN void stage(int* win, int ws, const Job& j, const Planes& p, int tid,
                 int nt) {
    const int w = j.cw + 6, n = (j.sh + 6) * w;
    for (int i0 = tid; i0 < n; i0 += DEPTH * nt) {
        int v[DEPTH];
#pragma unroll
        for (int d = 0; d < DEPTH; d++) {
            const int i = i0 + d * nt, r = i / w, c = i - r * w;
            if (i < n) v[d] = LR_LDG(win_row(j, p, r) + win_col(j, p, c));
        }
#pragma unroll
        for (int d = 0; d < DEPTH; d++) {
            const int i = i0 + d * nt, r = i / w, c = i - r * w;
            if (i < n) win[r * ws + c] = v[d];
        }
    }
}

// ---- Wiener -------------------------------------------------------------

struct WienerTile {
    int win[(MAX_SH + 6) * (WIENER_CW + 6)];
    int mid[(MAX_SH + 6) * WIENER_CW];
};

LR_FN void taps(const int* f, int* t) {
    t[0] = t[6] = f[0];
    t[1] = t[5] = f[1];
    t[2] = t[4] = f[2];
    t[3] = 128 - 2 * (f[0] + f[1] + f[2]);
}

LR_FN void wiener_h(WienerTile& s, const Job& j, int bd, int tid, int nt) {
    int t[7];
    taps(j.p, t);
    const int rb_h = bd == 12 ? 5 : 3;
    const int lim = (1 << (bd + 8 - rb_h)) - 1;
    const int rnd = (1 << (bd + 6)) + (1 << (rb_h - 1));
    const int n = (j.sh + 6) * j.cw;
    for (int i = tid; i < n; i += nt) {
        const int r = i / j.cw, c = i - r * j.cw;
        const int* w = s.win + r * (WIENER_CW + 6) + c;
        int acc = rnd;
#pragma unroll
        for (int k = 0; k < 7; k++) acc += t[k] * w[k];
        acc >>= rb_h;
        s.mid[r * WIENER_CW + c] = acc < 0 ? 0 : (acc > lim ? lim : acc);
    }
}

LR_FN void wiener_v(const WienerTile& s, const Job& j, const Planes& p,
                    int tid, int nt) {
    int t[7];
    taps(j.p + 3, t);
    const int rb_v = p.bd == 12 ? 9 : 11;
    const int rnd = (1 << (rb_v - 1)) - (1 << (p.bd + rb_v - 1));
    const int maxp = (1 << p.bd) - 1;
    const int n = j.sh * j.cw;
    for (int i = tid; i < n; i += nt) {
        const int r = i / j.cw, c = i - r * j.cw;
        const int* m = s.mid + r * WIENER_CW + c;
        int acc = rnd;
#pragma unroll
        for (int k = 0; k < 7; k++) acc += t[k] * m[k * WIENER_CW];
        acc >>= rb_v;
        p.out[(long long)(j.y + r) * p.W + j.x + j.cx0 + c] =
            acc < 0 ? 0 : (acc > maxp ? maxp : acc);
    }
}

// ---- self-guided ----------------------------------------------------------

constexpr int SGR_WS = SGR_CW + 6;  // window row stride
constexpr int SGR_AS = SGR_CW + 2;  // (A, B) row stride: columns -1..cw

struct SgrTile {
    int win[(MAX_SH + 6) * SGR_WS];
    // (A, B) of rows -1..sh at index y + 1; the 5x5 ones on odd rows
    int a3[(MAX_SH + 2) * SGR_AS], b3[(MAX_SH + 2) * SGR_AS];
    int a5[(MAX_SH + 2) * SGR_AS], b5[(MAX_SH + 2) * SGR_AS];
};

// reference sgr_calc_row_ab (src/looprestoration_tmpl.c:505-523) for one
// box: sum su and square sum sq of n pixels.
LR_FN void calc_ab(int su, int sq, int s, int n, int one_by_x, int bdm8,
                   int* A, int* B) {
    const int a = (sq + ((1 << (2 * bdm8)) >> 1)) >> (2 * bdm8);
    const int b = (su + ((1 << bdm8) >> 1)) >> bdm8;
    int pp = a * n - b * b;
    pp = pp < 0 ? 0 : pp;
    const int z = (int)(((long long)pp * s + (1 << 19)) >> 20);
    const int xv = X_BY_X[z < 255 ? z : 255];
    *A = (int)(((long long)xv * su * one_by_x + (1 << 11)) >> 12);
    *B = xv;
}

// Box sums of the (2r+1)^2 window pixels whose top-left is window
// (r0, c0).
LR_FN void box(const int* win, int r0, int c0, int d, int* su, int* sq) {
    int a = 0, b = 0;
    for (int y = 0; y < d; y++)
        for (int x = 0; x < d; x++) {
            const int v = win[(r0 + y) * SGR_WS + c0 + x];
            a += v;
            b += v * v;
        }
    *su = a;
    *sq = b;
}

LR_FN void sgr_ab(SgrTile& s, const Job& j, int bd, int tid, int nt) {
    const int variant = j.p[4], w = j.cw + 2, n = (j.sh + 2) * w;
    for (int i = tid; i < n; i += nt) {
        // (A, B) row k = y + 1 of rows y = -1..sh, column c = x + 1
        const int k = i / w, c = i - k * w, o = k * SGR_AS + c;
        int su, sq;
        if (variant != 0) {  // 3x3 box of window rows k+1..k+3
            box(s.win, k + 1, c + 1, 3, &su, &sq);
            calc_ab(su, sq, j.p[1], 9, 455, bd - 8, s.a3 + o, s.b3 + o);
        }
        if (variant != 1 && !(k & 1)) {  // odd y: window rows k..k+4
            box(s.win, k, c, 5, &su, &sq);
            calc_ab(su, sq, j.p[0], 25, 164, bd - 8, s.a5 + o, s.b5 + o);
        }
    }
}

// The 3x3 neighbourhood of (A, B) row k + 1, column c + 1: centre and
// cross weigh 4, corners 3.
LR_FN int eight(const int* m, int k, int c) {
    const int* u = m + k * SGR_AS + c;
    const int* v = u + SGR_AS;
    const int* d = v + SGR_AS;
    return (v[1] + v[0] + v[2] + u[1] + d[1]) * 4 +
           (u[0] + d[0] + u[2] + d[2]) * 3;
}

LR_FN void sgr_filter(const SgrTile& s, const Job& j, const Planes& p,
                      int tid, int nt) {
    const int variant = j.p[4], w0 = j.p[2], w1 = j.p[3];
    const int maxp = (1 << p.bd) - 1;
    const int n = j.sh * j.cw;
    for (int i = tid; i < n; i += nt) {
        const int r = i / j.cw, c = i - r * j.cw;
        const int src = s.win[(r + 3) * SGR_WS + c + 3];
        int v = 0;
        if (variant != 1) {
            int t5;
            if (!(r & 1)) {  // rows r - 1 and r + 1: k = r and r + 2
                const int* au = s.a5 + r * SGR_AS + c;
                const int* ad = au + 2 * SGR_AS;
                const int* bu = s.b5 + r * SGR_AS + c;
                const int* bv = bu + 2 * SGR_AS;
                const int A = (au[1] + ad[1]) * 6 +
                              (au[0] + ad[0] + au[2] + ad[2]) * 5;
                const int B = (bu[1] + bv[1]) * 6 +
                              (bu[0] + bv[0] + bu[2] + bv[2]) * 5;
                t5 = (A - B * src + (1 << 8)) >> 9;
            } else {  // row r: k = r + 1
                const int* a = s.a5 + (r + 1) * SGR_AS + c;
                const int* b = s.b5 + (r + 1) * SGR_AS + c;
                const int A = a[1] * 6 + (a[0] + a[2]) * 5;
                const int B = b[1] * 6 + (b[0] + b[2]) * 5;
                t5 = (A - B * src + (1 << 7)) >> 8;
            }
            v += w0 * t5;
        }
        if (variant != 0) {
            const int t3 =
                (eight(s.a3, r, c) - eight(s.b3, r, c) * src + (1 << 8)) >> 9;
            v += w1 * t3;
        }
        const int o = src + ((v + (1 << 10)) >> 11);
        p.out[(long long)(j.y + r) * p.W + j.x + j.cx0 + c] =
            o < 0 ? 0 : (o > maxp ? maxp : o);
    }
}

}  // namespace lr
