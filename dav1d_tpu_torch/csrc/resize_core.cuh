// The arithmetic of the super-res resize kernel (csrc/resize.cu): the
// phases of one CTA over one output tile of a batch of planes, as the
// kernel's threads run them.
//
// Semantics (reference resize_c, src/mc_tmpl.c; the plain version
// ops/resize.resize_plain): at output column x the accumulated phase is
// pos = mx0 + x * step (recon/mc_np.resize_coords, the closed form of
// resize_c's stepping); its high bits give the source column
// sx = (pos >> 14) - 1 and bits 8..13 the filter row
// ((pos & 0x3FFF) >> 8).  The eight taps read source columns
// sx - 3 .. sx + 4, each clamped to [0, src_w); the output is
// clip((-sum(tap * px) + 64) >> 7, 0, 2^bd - 1).  Exact in int32:
// |tap| <= 128 and px < 2^12 bound the sum by 2^22.
//
// Outside the resampled rectangle ([0, h) x [0, out_w)) the output is 0,
// as the host's zeroed allocation-sized planes are.
//
// A launch takes up to MAX_PLANES planes (a Batch, passed by value), cut
// into strips of TW output columns; the strips' rows, numbered plane by
// plane, strip by strip, top to bottom (Batch::start holds the prefix
// sums), are dealt to the CTAs in runs of equal length (to one row).  A
// CTA walks its run in tiles of up to TR rows, each within one strip, so
// that its tiles mostly go down one strip.  For one tile a CTA of THREADS
// threads:
//
//   tile_of  finds the tile at a strip row: its plane, origin and rows,
//            and the source span of its strip: plane columns a .. a + nw
//            - 1, a the 4-aligned column at or below sx(x0) - 3;
//   stage    copies rows [y0, min(y0 + ny, h)) of the span into a raw
//            buffer of SW words a row, 4 words at a time: a 16-byte copy
//            (RS_CP16, cp.async on the card) where the 4 columns need no
//            clamp and the rows are 16-byte aligned, else one word a column
//            through the clamp to [0, src_w) (RS_CP4);
//   taps_of  (once a strip) lane l's pairs of columns x0 + 2 l + 64 p and
//            x0 + 2 l + 64 p + 1 (p < 2): the offset of the pair's window
//            in a raw row, the first column's 8 taps and the second's 8
//            taps placed in 9 (its window starts 0 or 1 word later), from
//            the 512-byte table in shared memory (two words a filter row);
//   compute  rows w, w + 8, ... (< ny) of warp w: per pair nine shared
//            reads, 17 multiply-adds and one 8-byte store, 0 outside the
//            rectangle (zero taps).
//
// The header compiles as CUDA device code (included by resize.cu) and as
// plain C++ (a host build runs the phases thread by thread).  On the host
// the copies are plain and RS_CP_* nothing.
#pragma once

#ifdef __CUDACC__
#define RS_FN __device__ inline
#define RS_TABLE __device__
#define RS_TRAP() __trap()
__device__ __forceinline__ void rs_cp_async(int* dst, const int* src,
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
#define RS_CP4(dst, src) rs_cp_async(dst, src, 4)
#define RS_CP16(dst, src) rs_cp_async(dst, src, 16)
#define RS_ST8(p, v) (*reinterpret_cast<int2*>(p) = make_int2((v)[0], (v)[1]))
#define RS_CP_COMMIT() asm volatile("cp.async.commit_group;\n" ::: "memory")
// wait until at most N groups are in flight
#define RS_CP_WAIT(N) \
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory")
#else
#include <stdlib.h>
#include <string.h>
#define RS_FN inline
#define RS_TABLE
#define RS_TRAP() abort()
#define RS_CP4(dst, src) (*(dst) = *(src))
#define RS_CP16(dst, src) memcpy(dst, src, 16)
#define RS_ST8(p, v) memcpy(p, v, 8)
#define RS_CP_COMMIT()
#define RS_CP_WAIT(N)
#endif

namespace rs {

// tables.resize_filter (64 filter rows of 8 taps, the spec's
// Upscale_Filter negated as the reference stores it); in global memory on
// the card, copied into each CTA's shared memory (load_filter)
RS_TABLE const signed char FILTER[64][8] = {
    {0, 0, 0, -128, 0, 0, 0, 0},       {0, 0, 1, -128, -2, 1, 0, 0},
    {0, -1, 3, -127, -4, 2, -1, 0},    {0, -1, 4, -127, -6, 3, -1, 0},
    {0, -2, 6, -126, -8, 3, -1, 0},    {0, -2, 7, -125, -11, 4, -1, 0},
    {1, -2, 8, -125, -13, 5, -2, 0},   {1, -3, 9, -124, -15, 6, -2, 0},
    {1, -3, 10, -123, -18, 6, -2, 1},  {1, -3, 11, -122, -20, 7, -3, 1},
    {1, -4, 12, -121, -22, 8, -3, 1},  {1, -4, 13, -120, -25, 9, -3, 1},
    {1, -4, 14, -118, -28, 9, -3, 1},  {1, -4, 15, -117, -30, 10, -4, 1},
    {1, -5, 16, -116, -32, 11, -4, 1}, {1, -5, 16, -114, -35, 12, -4, 1},
    {1, -5, 17, -112, -38, 12, -4, 1}, {1, -5, 18, -111, -40, 13, -5, 1},
    {1, -5, 18, -109, -43, 14, -5, 1}, {1, -6, 19, -107, -45, 14, -5, 1},
    {1, -6, 19, -105, -48, 15, -5, 1}, {1, -6, 19, -103, -51, 16, -5, 1},
    {1, -6, 20, -101, -53, 16, -6, 1}, {1, -6, 20, -99, -56, 17, -6, 1},
    {1, -6, 20, -97, -58, 17, -6, 1},  {1, -6, 20, -95, -61, 18, -6, 1},
    {2, -7, 20, -93, -64, 18, -6, 2},  {2, -7, 20, -91, -66, 19, -6, 1},
    {2, -7, 20, -88, -69, 19, -6, 1},  {2, -7, 20, -86, -71, 19, -6, 1},
    {2, -7, 20, -84, -74, 20, -7, 2},  {2, -7, 20, -81, -76, 20, -7, 1},
    {2, -7, 20, -79, -79, 20, -7, 2},  {1, -7, 20, -76, -81, 20, -7, 2},
    {2, -7, 20, -74, -84, 20, -7, 2},  {1, -6, 19, -71, -86, 20, -7, 2},
    {1, -6, 19, -69, -88, 20, -7, 2},  {1, -6, 19, -66, -91, 20, -7, 2},
    {2, -6, 18, -64, -93, 20, -7, 2},  {1, -6, 18, -61, -95, 20, -6, 1},
    {1, -6, 17, -58, -97, 20, -6, 1},  {1, -6, 17, -56, -99, 20, -6, 1},
    {1, -6, 16, -53, -101, 20, -6, 1}, {1, -5, 16, -51, -103, 19, -6, 1},
    {1, -5, 15, -48, -105, 19, -6, 1}, {1, -5, 14, -45, -107, 19, -6, 1},
    {1, -5, 14, -43, -109, 18, -5, 1}, {1, -5, 13, -40, -111, 18, -5, 1},
    {1, -4, 12, -38, -112, 17, -5, 1}, {1, -4, 12, -35, -114, 16, -5, 1},
    {1, -4, 11, -32, -116, 16, -5, 1}, {1, -4, 10, -30, -117, 15, -4, 1},
    {1, -3, 9, -28, -118, 14, -4, 1},  {1, -3, 9, -25, -120, 13, -4, 1},
    {1, -3, 8, -22, -121, 12, -4, 1},  {1, -3, 7, -20, -122, 11, -3, 1},
    {1, -2, 6, -18, -123, 10, -3, 1},  {0, -2, 6, -15, -124, 9, -3, 1},
    {0, -2, 5, -13, -125, 8, -2, 1},   {0, -1, 4, -11, -125, 7, -2, 0},
    {0, -1, 3, -8, -126, 6, -2, 0},    {0, -1, 3, -6, -127, 4, -1, 0},
    {0, -1, 2, -4, -127, 3, -1, 0},    {0, 0, 1, -2, -128, 1, 0, 0},
};

constexpr int MAX_PLANES = 6;
constexpr int THREADS = 256;
// output columns and rows of a tile: 32 lanes x 2 pairs of adjacent
// columns, 8 warps x 4 rows
constexpr int TW = 128, TR = 32;
// words of a staged source row: a tile's span is at most
// sx(x0 + 127) - sx(x0) + 8 <= 136 columns at step <= 2^14 (the wrapper
// refuses a larger step), plus 3 for the aligned start: <= 139 words, so
// a pair's ninth word stays inside the row
constexpr int SW = 140;
constexpr int MAX_STEP = 1 << 14;
// raw buffers of a CTA: the tile it filters and the one after it, whose
// copies are in flight meanwhile
constexpr int NBUF = 2;
// words of the filter table in shared memory
constexpr int FILTER_WORDS = 64 * 8 / 4;
// int32 geometry columns of a plane (the C entry point's geo rows)
constexpr int GEO_COLS = 8;

// One plane of a launch: the source (row stride src_stride), the geometry
// of superres_geometry (decode/frame.py) and the output plane (out_rows x
// out_stride, row stride out_stride), and whether its output rows take
// 8-byte stores.
struct Plane {
    const int* src;
    int* out;
    int src_stride, src_w, h, out_w, out_rows, out_stride, step, mx0;
    bool st8;
};

// A launch: n planes, the prefix sums of their strip rows (a plane has
// ceil(out_stride / TW) strips of out_rows rows; start[0] = 0, start[k]
// = total for k >= n), its CTAs (CTA c of ctas takes the strip rows
// [c total / ctas, (c + 1) total / ctas): as many rows as any other, to
// one) and the pixel maximum.
struct Batch {
    Plane p[MAX_PLANES];
    int start[MAX_PLANES + 1];
    int n, total, ctas, maxp;
};

// The strip rows [*u0, *u1) of CTA c.
RS_FN void run_of(const Batch& b, int c, int* u0, int* u1) {
    *u0 = (int)((long long)c * b.total / b.ctas);
    *u1 = (int)((long long)(c + 1) * b.total / b.ctas);
}

// A tile: the piece of a CTA's run at one strip row: its plane k, strip
// tx, origin, output rows ny (<= TR: up to the run's end or the strip's),
// the source rows it stages (0 below h or right of out_w), its strip's
// span (plane column a of raw word 0, a multiple of 4, nw words a row),
// and whether its plane's rows are 16-byte aligned (16-byte copies where
// no clamp bites).
struct Tile {
    int k, tx, x0, y0, ny, rows, a, nw;
    bool vec;
};

// Lane l's pairs of columns x = x0 + 2 l + 64 p and x + 1 (p < 2) of a
// strip: the offset of x's window in a raw row, x's 8 taps and x + 1's
// taps over the same window and the word after it (x + 1's window starts
// 0 or 1 word later: step <= 2^14), zero for a column outside the
// resampled rectangle.
struct Taps {
    int off[2], t0[2][8], t1[2][9];
};

RS_FN long long pos_of(const Plane& p, int x) {
    return (long long)p.mx0 + (long long)x * p.step;
}

RS_FN int sx_of(long long pos) { return (int)(pos >> 14) - 1; }

RS_FN bool aligned16(const int* q) {
    return (reinterpret_cast<unsigned long long>(q) & 15) == 0;
}

// The table as words, 4 taps a word (thread tid's share).
RS_FN void load_filter(int* filt, int tid) {
    for (int i = tid; i < FILTER_WORDS; i += THREADS) {
        const signed char* f = &FILTER[0][0] + 4 * i;
        filt[i] = (int)((unsigned)(f[0] & 255) | (unsigned)(f[1] & 255) << 8 |
                        (unsigned)(f[2] & 255) << 16 |
                        (unsigned)(f[3] & 255) << 24);
    }
}

// The tile at strip row u of a run that ends at u1 (u < u1 <= b.total).
// On the card b is the kernel's parameter (__grid_constant__), read in
// place at a dynamic plane index.  Traps on a span wider than a raw row.
RS_FN void tile_of(const Batch& b, int u, int u1, Tile& T) {
    int k = 0;
#pragma unroll
    for (int i = 1; i < MAX_PLANES; i++) k += i < b.n && u >= b.start[i];
    const Plane& p = b.p[k];
    const int local = u - b.start[k], tx = local / p.out_rows;
    T.k = k;
    T.tx = tx;
    T.x0 = tx * TW;
    T.y0 = local - tx * p.out_rows;
    T.ny = p.out_rows - T.y0 < TR ? p.out_rows - T.y0 : TR;
    T.ny = u1 - u < T.ny ? u1 - u : T.ny;
    T.rows = T.a = T.nw = 0;
    T.vec = false;
    if (T.x0 >= p.out_w) return;
    T.rows = p.h - T.y0 < T.ny ? p.h - T.y0 : T.ny;
    T.rows = T.rows < 0 ? 0 : T.rows;
    const int xe = (T.x0 + TW < p.out_w ? T.x0 + TW : p.out_w) - 1;
    const int lo = sx_of(pos_of(p, T.x0)) - 3, hi = sx_of(pos_of(p, xe)) + 4;
    T.a = lo & ~3;  // the floor, also below 0
    T.nw = hi - T.a + 1;
    if (T.nw > SW) RS_TRAP();
    T.vec = p.src_stride % 4 == 0 && aligned16(p.src);
}

// Thread tid's share of the copies of the tile's source rows into raw, a
// group of 4 words at a time (a row of up to SW / 4 groups: constant
// divisors): a 16-byte copy where the rows are 16-byte aligned and the
// group's columns need no clamp, else 4 copies through the clamp to
// [0, src_w) (the first and last strips of a plane, or every group of a
// plane whose rows are not aligned).
RS_FN void stage(const Plane& p, const Tile& T, int* raw, int tid) {
    constexpr int Q = SW / 4;
    const int* src = p.src + (long long)T.y0 * p.src_stride;
    const int nq = (T.nw + 3) >> 2;
    for (int i = tid; i < T.rows * Q; i += THREADS) {
        const int r = i / Q, q = i - r * Q, x = T.a + 4 * q;
        if (q >= nq) continue;
        const int* row = src + (long long)r * p.src_stride;
        int* dst = raw + r * SW + 4 * q;
        if (T.vec && x >= 0 && x + 3 < p.src_w) {
            RS_CP16(dst, row + x);
        } else {
#pragma unroll
            for (int e = 0; e < 4; e++) {
                const int c = x + e < 0 ? 0
                              : (x + e >= p.src_w ? p.src_w - 1 : x + e);
                RS_CP4(dst + e, row + c);
            }
        }
    }
}

// The 8 taps of filter row ph into t (8 signed bytes of two shared
// words).
RS_FN void unpack(const int* filt, int ph, int* t) {
    const int w0 = filt[2 * ph], w1 = filt[2 * ph + 1];
#pragma unroll
    for (int k = 0; k < 4; k++) {
        t[k] = (signed char)(w0 >> (8 * k));
        t[k + 4] = (signed char)(w1 >> (8 * k));
    }
}

// Thread tid's pairs of the tile's strip from the shared filter words
// filt.
RS_FN void taps_of(const Plane& p, const Tile& T, const int* filt, Taps& tp,
                   int tid) {
    const int lane = tid & 31;
#pragma unroll
    for (int q = 0; q < 2; q++) {
        const int x = T.x0 + 2 * lane + 64 * q;
        int t[8];
        tp.off[q] = 0;
#pragma unroll
        for (int k = 0; k < 9; k++) tp.t1[q][k] = 0;
        if (x < p.out_w) {
            const long long pos = pos_of(p, x);
            tp.off[q] = sx_of(pos) - 3 - T.a;
            unpack(filt, (int)((pos & 0x3FFF) >> 8), t);
        } else {
#pragma unroll
            for (int k = 0; k < 8; k++) t[k] = 0;
        }
#pragma unroll
        for (int k = 0; k < 8; k++) tp.t0[q][k] = t[k];
        if (x + 1 < p.out_w) {
            const long long pos = pos_of(p, x + 1);
            const bool d = sx_of(pos) - 3 - T.a != tp.off[q];  // 1 word on
            unpack(filt, (int)((pos & 0x3FFF) >> 8), t);
#pragma unroll
            for (int k = 0; k < 9; k++)
                tp.t1[q][k] = d ? (k ? t[k - 1] : 0) : (k < 8 ? t[k] : 0);
        }
    }
}

// Thread tid's output pixels of the tile from the staged rows raw: per
// row and pair, nine shared reads (lanes 2 columns apart read words 1 to
// 1.8 apart: at most 2-way bank conflicts), 17 multiply-adds, one 8-byte
// store.  No branch but the warp-uniform ones on a row.
RS_FN void compute(const Plane& p, const Tile& T, const Taps& tp,
                   const int* raw, int maxp, int tid) {
    const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
    for (int i = 0; i < TR / 8; i++) {
        const int r = warp + 8 * i, y = T.y0 + r;
        if (r >= T.ny) break;
        int v[2][2] = {{0, 0}, {0, 0}};
        if (r < T.rows) {
            const int* w = raw + r * SW;
#pragma unroll
            for (int q = 0; q < 2; q++) {
                const int* px = w + tp.off[q];
                int a0 = 0, a1 = 0;
#pragma unroll
                for (int k = 0; k < 8; k++) a0 += tp.t0[q][k] * px[k];
#pragma unroll
                for (int k = 0; k < 9; k++) a1 += tp.t1[q][k] * px[k];
                // zero taps give 0, as the rectangle's outside must be
                const int c0 = (64 - a0) >> 7, c1 = (64 - a1) >> 7;
                v[q][0] = c0 < 0 ? 0 : (c0 > maxp ? maxp : c0);
                v[q][1] = c1 < 0 ? 0 : (c1 > maxp ? maxp : c1);
            }
        }
        int* o = p.out + (long long)y * p.out_stride + T.x0 + 2 * lane;
#pragma unroll
        for (int q = 0; q < 2; q++) {
            const int x = T.x0 + 2 * lane + 64 * q;
            if (p.st8 && x + 1 < p.out_stride) {
                RS_ST8(o + 64 * q, v[q]);
            } else {
                if (x < p.out_stride) o[64 * q] = v[q][0];
                if (x + 1 < p.out_stride) o[64 * q + 1] = v[q][1];
            }
        }
    }
}

// The batch of the n planes: srcs / outs their pointers, geo their
// GEO_COLS ints (src_stride, src_w, h, out_w, out_rows, out_stride, step,
// mx0), `ctas` CTAs at most (one a strip row where there are fewer).
// Returns false on a plane the kernel does not take (the wrapper refuses
// those first).
inline bool make_batch(Batch& b, const int* const* srcs, int* const* outs,
                       const int* geo, int n, int bitdepth, int ctas) {
    if (n < 1 || n > MAX_PLANES || ctas < 1) return false;
    b.n = n;
    b.maxp = (1 << bitdepth) - 1;
    int total = 0;
    for (int k = 0; k < MAX_PLANES; k++) {
        b.start[k] = total;
        if (k >= n) {
            b.p[k] = b.p[0];
            continue;
        }
        const int* g = geo + k * GEO_COLS;
        Plane& p = b.p[k];
        p = Plane{srcs[k], outs[k], g[0], g[1], g[2], g[3], g[4], g[5],
                  g[6], g[7],
                  g[5] % 2 == 0 &&
                      (reinterpret_cast<unsigned long long>(outs[k]) & 7) == 0};
        if (p.src_w < 1 || p.src_w > p.src_stride || p.h < 1 ||
            p.h > p.out_rows || p.out_w < 1 || p.out_w > p.out_stride ||
            p.step < 1 || p.step > MAX_STEP)
            return false;
        total += p.out_rows * ((p.out_stride + TW - 1) / TW);
    }
    b.start[MAX_PLANES] = total;
    b.total = total;
    b.ctas = total < ctas ? total : ctas;
    return true;
}

}  // namespace rs
