// The arithmetic of the loop-restoration kernels (csrc/lr.cu): the
// phases of one CTA, over its shared arrays.
//
// A job is one stripe unit of one plane (ops/lr.py job_table): its
// origin (x, y), width uw <= 384 and height sh <= 64, LR edge flags, the
// plane's height h (the last row the bottom context may read is h - 1)
// and six filter parameters: the Wiener half-filters fh[3], fv[3], or
// the self-guided s0, s1, w0, w1 and variant (0: 5x5 only, 1: 3x3 only,
// 2: both).  Both filters read a padded window, (sh + 6) x (cw + 6) for
// a chunk of cw output columns, from the post-CDEF plane and the
// pre-CDEF snapshot (recon/lr_apply _pad_unit_indices): columns clamped
// at an absent left or right edge and to the plane; the three rows above
// from the snapshot's rows y - 2, y - 2, y - 1 with a top edge, else the
// unit's first row; the three below from the snapshot's rows y + sh, then
// min(y + sh + 1, h - 1) twice with a bottom edge, else the unit's last
// row.  Each phase is a loop that thread `tid` runs over its share:
//
//   Wiener  a CTA takes one band of a chunk (a chunk table row, below):
//           the window's row and column tables, then sub-band by
//           sub-band the copies of its rows, the horizontal 7-tap pass
//           into a ring of the int32 intermediate (+2^(bd+6) +
//           2^(rb_h-1), >> rb_h, clipped to [0, 2^(bd+8-rb_h))), the
//           vertical pass (rounded by rb_v about 2^(bd+rb_v-1), clipped
//           to the bit depth) into the output (reference
//           wiener_filter_h/v, src/looprestoration_tmpl.c:44-190);
//   SGR     a CTA takes one band of a chunk (a chunk table row whose
//           band of at most 16 rows starts on an even unit row): the
//           copies of the band's window rows, the 3- and 5-row
//           column sums of px and px^2, the (A, B) of the 3x3 boxes
//           (every row) and of the 5x5 boxes (odd unit rows) from
//           horizontal sums of those, then per pixel the 3x3 weights
//           4/3 (>> 9) and the 5x5 weights 6/5 on even rows (>> 9) and
//           odd rows (>> 8), blended src + ((w0 t5 + w1 t3 + 2^10) >> 11)
//           and clipped (reference sgr_5x5_c / sgr_3x3_c / sgr_mix_c,
//           src/looprestoration_tmpl.c:679-1090).
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
// nothing outside the LR_* macros uses a CUDA builtin: LR_CP4 / LR_CP16
// are cp.async copies of 4 / 16 bytes into shared memory on the card,
// LR_CP_COMMIT closes a group of them, LR_CP_WAIT1 waits for all but the
// last group and LR_CP_WAIT0 for all; on the host the copies are plain
// and the rest nothing.  The x_by_x table (LR_TABLE) is in global memory
// on the card, copied into each self-guided CTA's shared memory.
// LR_LDG16 (through the read-only path), LR_LD16 and LR_ST16 move 4
// ints at a 16-byte aligned address.
#pragma once

#ifdef __CUDACC__
#define LR_FN __device__ inline
#define LR_TABLE __device__
#define LR_LDG(p) __ldg(p)
#define LR_TRAP() __trap()
__device__ __forceinline__ void lr_cp_async(int* dst, const int* src,
                                            int bytes) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    if (bytes == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                     "l"(src)
                     : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                     "l"(src)
                     : "memory");
}
#define LR_CP4(dst, src) lr_cp_async(dst, src, 4)
#define LR_CP16(dst, src) lr_cp_async(dst, src, 16)
#define LR_CP_COMMIT() asm volatile("cp.async.commit_group;\n" ::: "memory")
#define LR_CP_WAIT1() asm volatile("cp.async.wait_group 1;\n" ::: "memory")
#define LR_CP_WAIT0() asm volatile("cp.async.wait_group 0;\n" ::: "memory")
#define LR_LDG16(p, v)                                               \
    do {                                                             \
        const int4 t_ = __ldg(reinterpret_cast<const int4*>(p));     \
        (v)[0] = t_.x, (v)[1] = t_.y, (v)[2] = t_.z, (v)[3] = t_.w;  \
    } while (0)
#define LR_LD16(p, v)                                          \
    do {                                                       \
        const int4 t_ = *reinterpret_cast<const int4*>(p);     \
        (v)[0] = t_.x, (v)[1] = t_.y, (v)[2] = t_.z, (v)[3] = t_.w; \
    } while (0)
#define LR_ST16(p, v) \
    (*reinterpret_cast<int4*>(p) = make_int4((v)[0], (v)[1], (v)[2], (v)[3]))
#else
#include <stdlib.h>
#include <string.h>
#define LR_FN inline
#define LR_TABLE
#define LR_LDG(p) (*(p))
#define LR_TRAP() abort()
#define LR_CP4(dst, src) (*(dst) = *(src))
#define LR_CP16(dst, src) memcpy(dst, src, 16)
#define LR_CP_COMMIT()
#define LR_CP_WAIT1()
#define LR_CP_WAIT0()
#define LR_LDG16(p, v) memcpy(v, p, 16)
#define LR_LD16(p, v) memcpy(v, p, 16)
#define LR_ST16(p, v) memcpy(p, v, 16)
#endif

namespace lr {

// Columns of a job row (int32, ops/lr.py job_table).
constexpr int JOB_COLS = 12;
constexpr int J_X = 0, J_Y = 1, J_UW = 2, J_SH = 3, J_EDGES = 4, J_H = 5,
              J_P = 6;
constexpr int MAX_UW = 384, MAX_SH = 64;
// edge flags (recon/lr_apply.py LR_HAVE_*)
constexpr int HAVE_LEFT = 1, HAVE_RIGHT = 2, HAVE_TOP = 4, HAVE_BOTTOM = 8;
// output columns of a CTA; output rows of a self-guided band
constexpr int WIENER_CW = 64, SGR_CW = 32, SGR_SB = 16;

// tables.sgr_x_by_x
LR_TABLE const int X_BY_X[256] = {
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

// The fields of a job row's values v.  Traps on a unit the kernels do not
// take.
LR_FN void set_job(Job& j, const int* v) {
    j.x = v[J_X];
    j.y = v[J_Y];
    j.uw = v[J_UW];
    j.sh = v[J_SH];
    j.edges = v[J_EDGES];
    j.h = v[J_H];
    for (int k = 0; k < 6; k++) j.p[k] = v[J_P + k];
    if (j.uw < 1 || j.uw > MAX_UW || j.sh < 1 || j.sh > MAX_SH) LR_TRAP();
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

// ---- Wiener: a chunk table of row bands, streamed through a ring -------
//
// A launch takes a chunk table (ops/lr.py chunk_table): one row per live
// (job, 64-column chunk, band of output rows), so no CTA exists only to
// return.  A CTA resolves its window's row sources (win_row) and column
// clamps (win_col) once, into shared tables, then streams the band's
// nr + 6 window rows in sub-bands of SB = WIENER_SB rows through two raw
// buffers: sub-band g + 1's copies (LR_CP*: cp.async on the card) are in
// flight while sub-band g runs its horizontal pass into a ring of SB + 6
// rows of the intermediate and its vertical pass out of it.  Where the
// window's columns need no clamp and the planes' rows are 16-byte
// aligned, a row is staged as 16-byte copies from the aligned column a at
// or below the window's first (its columns then start `shift` words into
// the raw row); elsewhere element by element through the column table.
// In a chunk narrower than a multiple of 4 columns the raw words past a
// row's copies are zero (wiener_setup).

// columns of a chunk row (int32, ops/lr.py chunk_table): the job's index
// (for the host's check), the chunk's first column, the band's first
// output row and rows, then the job's row, so that a CTA's first load
// (four 16-byte loads of a 64-byte row) brings all it needs
constexpr int CHUNK_COLS = 4 + JOB_COLS;
constexpr int C_JOB = 0, C_X = 1, C_R0 = 2, C_NR = 3, C_ROW = 4;
constexpr int WIENER_THREADS = 256;
// window rows of a sub-band (the vertical pass takes WIENER_SB / 16 rows a
// thread)
constexpr int WIENER_SB = 32;
// words of a raw row: the window's 70 columns from an aligned start (the
// horizontal pass reads words 4q .. 4q + 15 of it, q < 16)
constexpr int RAW_S = 76;

struct WienerRing {
    int raw[2][WIENER_SB * RAW_S];         // window rows of two sub-bands
    int mid[(WIENER_SB + 6) * WIENER_CW];  // the horizontal pass, a ring
    const int* row[MAX_SH + 6];  // plane row of each window row
    int col[WIENER_CW + 6];      // plane column of each window column
};

// One CTA's band: its job, its chunk's columns (Job cx0, cw), its first
// output row r0 and rows nr in the unit, and how its rows are staged.
struct Band {
    Job j;
    int r0, nr;
    bool vec;   // 16-byte copies
    int a;      // plane column of raw word 0 (vec)
    int shift;  // window column 0 in a raw row
    int nw;     // 16-byte copies a row (vec)
};

LR_FN bool aligned16(const int* q) {
    return (reinterpret_cast<unsigned long long>(q) & 15) == 0;
}

// Chunk row `ci` of a table of cw_max-column chunks (16-byte aligned);
// `sgr`: the self-guided table, whose bands start on an even unit row and
// hold at most SGR_SB rows.  Traps on a row the kernel does not take
// (ops/lr.py check_chunks refuses it on the host).
LR_FN void load_band(Band& b, const int* chunks, int ci, const Planes& p,
                     int cw_max, bool sgr) {
    const int* c = chunks + (long long)ci * CHUNK_COLS;
    int v[CHUNK_COLS];
#pragma unroll
    for (int k = 0; k < CHUNK_COLS; k += 4) LR_LDG16(c + k, v + k);
    Job& j = b.j;
    set_job(j, v + C_ROW);
    j.cx0 = v[C_X];
    b.r0 = v[C_R0];
    b.nr = v[C_NR];
    if (j.cx0 < 0 || j.cx0 % cw_max || j.cx0 >= j.uw || b.r0 < 0 ||
        b.nr < 1 || b.r0 + b.nr > j.sh ||
        (sgr && ((b.r0 & 1) || b.nr > SGR_SB)))
        LR_TRAP();
    j.cw = j.uw - j.cx0 < cw_max ? j.uw - j.cx0 : cw_max;
    // the window's plane columns x_lo .. x_hi, unclamped?
    const int x_lo = j.x + j.cx0 - 3, x_hi = j.x + j.cx0 + j.cw + 2;
    const bool whole = (x_lo >= j.x || (j.edges & HAVE_LEFT)) &&
                       (x_hi <= j.x + j.uw - 1 || (j.edges & HAVE_RIGHT)) &&
                       x_lo >= 0 && x_hi <= p.W - 1;
    b.vec = whole && p.W % 4 == 0 && aligned16(p.post) && aligned16(p.pre);
    b.a = x_lo & ~3;
    b.shift = b.vec ? x_lo - b.a : 0;
    b.nw = (x_hi + 4 - b.a) >> 2;
}

// Sub-bands of the band's nr + 6 window rows.
LR_FN int sub_bands(const Band& b) {
    return (b.nr + 6 + WIENER_SB - 1) / WIENER_SB;
}

// The row and column tables, the thread's share, and in a chunk whose
// width is not a multiple of 4 zeros in the raw words past each row's
// copies: its horizontal pass reads them for the columns past cw, whose
// sums the vertical pass drops, and zero keeps those sums defined.
LR_FN void wiener_setup(WienerRing& s, const Band& b, const Planes& p,
                        int tid) {
    for (int i = tid; i < b.nr + 6; i += WIENER_THREADS)
        s.row[i] = win_row(b.j, p, b.r0 + i);
    for (int c = tid; c < b.j.cw + 6; c += WIENER_THREADS)
        s.col[c] = win_col(b.j, p, c);
    if (b.j.cw % 4 == 0) return;
    const int staged = b.vec ? 4 * b.nw : b.j.cw + 6;
    for (int r = tid; r < 2 * WIENER_SB; r += WIENER_THREADS)
        for (int c = staged; c < RAW_S; c++)
            s.raw[r / WIENER_SB][(r % WIENER_SB) * RAW_S + c] = 0;
}

// Issue the copies of sub-band g's window rows into raw buffer g & 1, the
// thread's share (nothing past the band's last window row).
LR_FN void wiener_issue(WienerRing& s, const Band& b, int g, int tid) {
    const int r0 = g * WIENER_SB;
    const int rows = b.nr + 6 - r0 < WIENER_SB ? b.nr + 6 - r0 : WIENER_SB;
    int* raw = s.raw[g & 1];
    if (b.vec) {
        // 32 lanes a row (nw <= 19), 8 rows at a time
        const int q = tid & 31;
        if (q >= b.nw) return;
        for (int r = tid >> 5; r < rows; r += WIENER_THREADS / 32)
            LR_CP16(raw + r * RAW_S + 4 * q, s.row[r0 + r] + b.a + 4 * q);
    } else {
        // 128 lanes a row (cw + 6 <= 70), 2 rows at a time
        const int c = tid & 127;
        if (c >= b.j.cw + 6) return;
        for (int r = tid >> 7; r < rows; r += WIENER_THREADS / 128)
            LR_CP4(raw + r * RAW_S + c, s.row[r0 + r] + s.col[c]);
    }
}

LR_FN void taps(const int* f, int* t) {
    t[0] = t[6] = f[0];
    t[1] = t[5] = f[1];
    t[2] = t[4] = f[2];
    t[3] = 128 - 2 * (f[0] + f[1] + f[2]);
}

// The horizontal sums of window columns S + j .. S + j + 6 (j < 4) of the
// 16 words v, rounded (rnd, >> rb) and clipped to [0, lim].
template <int S>
LR_FN void hsum4(const int* v, const int* t, int rnd, int rb, int lim,
                 int* o) {
#pragma unroll
    for (int j = 0; j < 4; j++) {
        int acc = rnd;
#pragma unroll
        for (int k = 0; k < 7; k++) acc += t[k] * v[S + j + k];
        acc >>= rb;
        o[j] = acc < 0 ? 0 : (acc > lim ? lim : acc);
    }
}

// The horizontal pass of sub-band g (raw buffer g & 1) into the ring: the
// 7-tap sum, +2^(bd+6) + 2^(rb_h-1), >> rb_h, clipped to
// [0, 2^(bd+8-rb_h)).  A thread takes 4 columns of a row from 16 raw
// words read as four 16-byte loads, the band's shift (uniform across the
// CTA) picking the words; columns past cw compute, from the zeroed
// words, what the vertical pass drops.
LR_FN void wiener_hpass(WienerRing& s, const Band& b, int g, int bd,
                        int tid) {
    constexpr int M = WIENER_SB + 6, TPR = WIENER_CW / 4,
                  RS = WIENER_THREADS / TPR;
    const int q = tid % TPR;
    if (4 * q >= b.j.cw) return;
    int t[7];
    taps(b.j.p, t);
    const int rb_h = bd == 12 ? 5 : 3;
    const int lim = (1 << (bd + 8 - rb_h)) - 1;
    const int rnd = (1 << (bd + 6)) + (1 << (rb_h - 1));
    const int r0 = g * WIENER_SB;
    const int rows = b.nr + 6 - r0 < WIENER_SB ? b.nr + 6 - r0 : WIENER_SB;
    const int rt = tid / TPR;
    const int* raw = s.raw[g & 1] + rt * RAW_S + 4 * q;
    int* mid = s.mid + 4 * q;
    const int slot0 = (r0 + rt) % M;
    // rows rt, rt + RS, ... of the sub-band
#pragma unroll
    for (int i = 0; i < (WIENER_SB + RS - 1) / RS; i++) {
        if (rt + RS * i >= rows) break;
        const int* w = raw + RS * i * RAW_S;
        int v[16], o[4];
        LR_LD16(w, v);
        LR_LD16(w + 4, v + 4);
        LR_LD16(w + 8, v + 8);
        LR_LD16(w + 12, v + 12);
        switch (b.shift) {
            case 0: hsum4<0>(v, t, rnd, rb_h, lim, o); break;
            case 1: hsum4<1>(v, t, rnd, rb_h, lim, o); break;
            case 2: hsum4<2>(v, t, rnd, rb_h, lim, o); break;
            default: hsum4<3>(v, t, rnd, rb_h, lim, o); break;
        }
        const int slot = slot0 + RS * i < M ? slot0 + RS * i
                                            : slot0 + RS * i - M;
        LR_ST16(mid + slot * WIENER_CW, o);
    }
}

// The vertical pass of the output rows whose 7 intermediate rows the ring
// holds after sub-band g: rows g SB - 6 .. (g + 1) SB - 7 of the band,
// rounded by rb_v about 2^(bd+rb_v-1), clipped to the bit depth, into the
// output plane.  A thread takes 4 columns of SB / 16 consecutive rows
// from SB / 16 + 6 ring rows read once (16-byte loads), and stores them
// as 16 bytes where the output row allows it.
LR_FN void wiener_vpass(const WienerRing& s, const Band& b, int g,
                        const Planes& p, int tid) {
    constexpr int M = WIENER_SB + 6, TPR = WIENER_CW / 4,
                  VR = WIENER_SB / (WIENER_THREADS / TPR);
    static_assert(VR >= 1, "sub-bands of at least 16 rows");
    const int c0 = 4 * (tid % TPR);
    const int lo = g * WIENER_SB - 6 > 0 ? g * WIENER_SB - 6 : 0;
    const int hi = (g + 1) * WIENER_SB - 6 < b.nr ? (g + 1) * WIENER_SB - 6
                                                  : b.nr;
    const int o0 = lo + (tid / TPR) * VR;
    if (c0 >= b.j.cw || o0 >= hi) return;
    int t[7];
    taps(b.j.p + 3, t);
    const int rb_v = p.bd == 12 ? 9 : 11;
    const int rnd = (1 << (rb_v - 1)) - (1 << (p.bd + rb_v - 1));
    const int maxp = (1 << p.bd) - 1;
    // ring rows o0 .. o0 + VR + 5 (those past hi + 5 are not used)
    int m[VR + 6][4];
    int slot = o0 % M;
#pragma unroll
    for (int i = 0; i < VR + 6; i++) {
        LR_LD16(s.mid + slot * WIENER_CW + c0, m[i]);
        slot = slot + 1 == M ? 0 : slot + 1;
    }
    const int n = b.j.cw - c0 < 4 ? b.j.cw - c0 : 4;
    int* out = p.out + (long long)(b.j.y + b.r0 + o0) * p.W + b.j.x +
               b.j.cx0 + c0;
#pragma unroll
    for (int i = 0; i < VR; i++) {
        if (o0 + i >= hi) break;
        int o[4];
#pragma unroll
        for (int j = 0; j < 4; j++) {
            int acc = rnd;
#pragma unroll
            for (int k = 0; k < 7; k++) acc += t[k] * m[i + k][j];
            acc >>= rb_v;
            o[j] = acc < 0 ? 0 : (acc > maxp ? maxp : acc);
        }
        int* d = out + (long long)i * p.W;
        if (n == 4 && aligned16(d)) {
            LR_ST16(d, o);
        } else {
#pragma unroll
            for (int j = 0; j < 4; j++)
                if (j < n) d[j] = o[j];
        }
    }
}

// ---- self-guided: a chunk table of 16-row bands, one CTA each ----------
//
// A launch takes a chunk table of SGR_CW-column chunks (ops/lr.py
// chunk_table(sgr=True)): one row per live (job, chunk, band of at most
// SGR_SB output rows), every band starting on an even unit row, since the
// 5x5 (A, B) exist on odd unit rows and the filter weighs even and odd
// rows differently (the parity is the unit's).  A CTA runs its band in
// four phases between barriers:
//
//   sgr_issue   the band's nr + 6 window rows (win_row of the unit window
//               rows r0 .. r0 + nr + 5): 16-byte copies from the aligned
//               column a where the chunk's columns need no clamp, as the
//               Wiener kernel stages (load_band), else element copies
//               through win_col;
//   sgr_vsum    per window column, the 3-row sums of px and px^2 under
//               each (A, B) row q of the band (unit row r0 - 1 + q, window
//               rows q + 1 .. q + 3) and the 5-row sums (rows q .. q + 4)
//               under the odd unit rows (even q);
//   sgr_ab      per (A, B) point, the horizontal sums of 3 (5) of those
//               and calc_ab, the x_by_x table from shared memory: 6 (10)
//               shared reads a point where box sums took 18 (50);
//   sgr_filter  4 columns a thread: the (A, B) neighbourhoods through
//               16-byte shared loads, the blend and the clip, a 16-byte
//               store where the output row allows it.

constexpr int SGR_THREADS = 256;
// (A, B) rows of a band, of them on odd unit rows
constexpr int SGR_Q = SGR_SB + 2, SGR_Q5 = SGR_SB / 2 + 1;
// words of a staged window row: the chunk's 38 window columns from an
// aligned start
constexpr int SGR_RS = 44;
// window columns; (A, B) row stride (columns -1..cw, 16-byte rows)
constexpr int SGR_VW = SGR_CW + 6, SGR_AS = 36;

struct SgrTile {
    int win[(SGR_SB + 6) * SGR_RS];  // window rows of the band
    // (A, B) of (A, B) row q at q * SGR_AS; the 5x5 ones of even q at
    // q / 2 * SGR_AS
    int a3[SGR_Q * SGR_AS], b3[SGR_Q * SGR_AS];
    int a5[SGR_Q5 * SGR_AS], b5[SGR_Q5 * SGR_AS];
    // column sums of px and px^2: 3 rows under every q, 5 under even q
    int vs3[SGR_Q * SGR_VW], vq3[SGR_Q * SGR_VW];
    int vs5[SGR_Q5 * SGR_VW], vq5[SGR_Q5 * SGR_VW];
    int x_by_x[256];
};

// reference sgr_calc_row_ab (src/looprestoration_tmpl.c:505-523) for one
// box: sum su and square sum sq of n pixels; xbx the x_by_x table.
LR_FN void calc_ab(int su, int sq, int s, int n, int one_by_x, int bdm8,
                   const int* xbx, int* A, int* B) {
    const int a = (sq + ((1 << (2 * bdm8)) >> 1)) >> (2 * bdm8);
    const int b = (su + ((1 << bdm8) >> 1)) >> bdm8;
    int pp = a * n - b * b;
    pp = pp < 0 ? 0 : pp;
    const int z = (int)(((long long)pp * s + (1 << 19)) >> 20);
    const int xv = xbx[z < 255 ? z : 255];
    *A = (int)(((long long)xv * su * one_by_x + (1 << 11)) >> 12);
    *B = xv;
}

// The x_by_x table into shared memory (the thread's share).
LR_FN void sgr_setup(SgrTile& s, int tid) {
    for (int i = tid; i < 256; i += SGR_THREADS) s.x_by_x[i] = X_BY_X[i];
}

// Issue the copies of the band's window rows, the thread's share.
LR_FN void sgr_issue(SgrTile& s, const Band& b, const Planes& p, int tid) {
    const int R = b.r0, rows = b.nr + 6;
    if (b.vec) {
        for (int i = tid; i < rows * b.nw; i += SGR_THREADS) {
            const int r = i / b.nw, q = i - r * b.nw;
            LR_CP16(s.win + r * SGR_RS + 4 * q,
                    win_row(b.j, p, R + r) + b.a + 4 * q);
        }
    } else {
        const int w = b.j.cw + 6;
        for (int i = tid; i < rows * w; i += SGR_THREADS) {
            const int r = i / w, c = i - r * w;
            LR_CP4(s.win + r * SGR_RS + c,
                   win_row(b.j, p, R + r) + win_col(b.j, p, c));
        }
    }
}

// The column sums of the band (the thread's share).
LR_FN void sgr_vsum(SgrTile& s, const Band& b, int tid) {
    const int variant = b.j.p[4], w = b.j.cw + 6;
    const int n = (b.nr + 2) * w;
    for (int i = tid; i < n; i += SGR_THREADS) {
        const int q = i / w, c = i - q * w;
        const int* col = s.win + q * SGR_RS + b.shift + c;
        int v[5];
#pragma unroll
        for (int k = 0; k < 5; k++) v[k] = col[k * SGR_RS];
        const int su = v[1] + v[2] + v[3];
        const int sq = v[1] * v[1] + v[2] * v[2] + v[3] * v[3];
        if (variant != 0) {
            s.vs3[q * SGR_VW + c] = su;
            s.vq3[q * SGR_VW + c] = sq;
        }
        if (variant != 1 && !(q & 1)) {
            s.vs5[(q >> 1) * SGR_VW + c] = su + v[0] + v[4];
            s.vq5[(q >> 1) * SGR_VW + c] = sq + v[0] * v[0] + v[4] * v[4];
        }
    }
}

// The (A, B) of the band's rows q, columns -1..cw (the thread's share).
LR_FN void sgr_ab(SgrTile& s, const Band& b, int bd, int tid) {
    const int variant = b.j.p[4], w = b.j.cw + 2;
    const int n = (b.nr + 2) * w;
    for (int i = tid; i < n; i += SGR_THREADS) {
        const int q = i / w, c = i - q * w;
        if (variant != 0) {  // 3x3: window columns c + 1 .. c + 3
            const int* vs = s.vs3 + q * SGR_VW + c + 1;
            const int* vq = s.vq3 + q * SGR_VW + c + 1;
            calc_ab(vs[0] + vs[1] + vs[2], vq[0] + vq[1] + vq[2], b.j.p[1],
                    9, 455, bd - 8, s.x_by_x, s.a3 + q * SGR_AS + c,
                    s.b3 + q * SGR_AS + c);
        }
        if (variant != 1 && !(q & 1)) {  // 5x5: columns c .. c + 4
            const int* vs = s.vs5 + (q >> 1) * SGR_VW + c;
            const int* vq = s.vq5 + (q >> 1) * SGR_VW + c;
            calc_ab(vs[0] + vs[1] + vs[2] + vs[3] + vs[4],
                    vq[0] + vq[1] + vq[2] + vq[3] + vq[4], b.j.p[0], 25, 164,
                    bd - 8, s.x_by_x, s.a5 + (q >> 1) * SGR_AS + c,
                    s.b5 + (q >> 1) * SGR_AS + c);
        }
    }
}

// Words c0 .. c0 + 7 of row `row` of an (A, B) array (two 16-byte loads).
LR_FN void ab8(const int* m, int row, int c0, int* v) {
    LR_LD16(m + row * SGR_AS + c0, v);
    LR_LD16(m + row * SGR_AS + c0 + 4, v + 4);
}

// The band's output rows, 4 columns a thread (the thread's share).
// Columns past the chunk's width are neither computed nor stored, and
// their (A, B) words, never written, are not read.
LR_FN void sgr_filter(const SgrTile& s, const Band& b, const Planes& p,
                      int tid) {
    constexpr int QPR = SGR_CW / 4;  // 4-column groups of a row
    const int r = tid / QPR, c0 = 4 * (tid % QPR);
    if (r >= b.nr || c0 >= b.j.cw) return;
    static_assert(SGR_SB * QPR <= SGR_THREADS, "a band in one pass");
    const int variant = b.j.p[4], w0 = b.j.p[2], w1 = b.j.p[3];
    const int maxp = (1 << p.bd) - 1;
    const int n = b.j.cw - c0 < 4 ? b.j.cw - c0 : 4;
    const int* sw = s.win + (r + 3) * SGR_RS + b.shift + c0 + 3;
    int src[4], v[4] = {0, 0, 0, 0};
#pragma unroll
    for (int j = 0; j < 4; j++) src[j] = sw[j];
    if (variant != 1) {
        int A[2][8], B[2][8];
        // even unit rows (r, since r0 is even): rows q = r and r + 2;
        // odd: q = r + 1
        const int even = !(r & 1), k = even ? r >> 1 : (r + 1) >> 1;
        ab8(s.a5, k, c0, A[0]);
        ab8(s.b5, k, c0, B[0]);
        if (even) {
            ab8(s.a5, k + 1, c0, A[1]);
            ab8(s.b5, k + 1, c0, B[1]);
        }
#pragma unroll
        for (int j = 0; j < 4; j++) {
            if (j >= n) break;
            int t5;
            if (even) {
                const int a = (A[0][j + 1] + A[1][j + 1]) * 6 +
                              (A[0][j] + A[1][j] + A[0][j + 2] + A[1][j + 2]) *
                                  5;
                const int bb = (B[0][j + 1] + B[1][j + 1]) * 6 +
                               (B[0][j] + B[1][j] + B[0][j + 2] + B[1][j + 2]) *
                                   5;
                t5 = (a - bb * src[j] + (1 << 8)) >> 9;
            } else {
                const int a = A[0][j + 1] * 6 + (A[0][j] + A[0][j + 2]) * 5;
                const int bb = B[0][j + 1] * 6 + (B[0][j] + B[0][j + 2]) * 5;
                t5 = (a - bb * src[j] + (1 << 7)) >> 8;
            }
            v[j] += w0 * t5;
        }
    }
    if (variant != 0) {
        // the weighted 3x3 sums, row by row: centre row 4 / 4 / 4, the
        // rows above and below 3 / 4 / 3
        int ea[4] = {0, 0, 0, 0}, eb[4] = {0, 0, 0, 0};
#pragma unroll
        for (int k = 0; k < 3; k++) {
            int A[8], B[8];
            ab8(s.a3, r + k, c0, A);
            ab8(s.b3, r + k, c0, B);
            const int side = k == 1 ? 4 : 3;
#pragma unroll
            for (int j = 0; j < 4; j++) {
                if (j >= n) break;
                ea[j] += A[j + 1] * 4 + (A[j] + A[j + 2]) * side;
                eb[j] += B[j + 1] * 4 + (B[j] + B[j + 2]) * side;
            }
        }
#pragma unroll
        for (int j = 0; j < 4; j++) {
            if (j >= n) break;
            v[j] += w1 * ((ea[j] - eb[j] * src[j] + (1 << 8)) >> 9);
        }
    }
    int o[4];
#pragma unroll
    for (int j = 0; j < 4; j++) {
        const int t = src[j] + ((v[j] + (1 << 10)) >> 11);
        o[j] = t < 0 ? 0 : (t > maxp ? maxp : t);
    }
    int* d = p.out + (long long)(b.j.y + b.r0 + r) * p.W +
             b.j.x + b.j.cx0 + c0;
    if (n == 4 && aligned16(d)) {
        LR_ST16(d, o);
    } else {
#pragma unroll
        for (int j = 0; j < 4; j++)
            if (j < n) d[j] = o[j];
    }
}

}  // namespace lr
