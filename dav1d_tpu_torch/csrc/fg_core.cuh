// The arithmetic of the film-grain kernel (csrc/fg.cu), and the phases of
// one of its threads: groups of 4 consecutive pixels of a row.
//
// A pixel (x, y) of a plane lies in grain block bi = x >> (5 - ss_x) of
// block row row = y >> (5 - ss_y) (blocks of bsz = 32 >> ss_x columns and
// bszy = 32 >> ss_y rows), at (xx, yy) inside it.  Its grain value is the
// plane's grain LUT (74 x 82 int32, native/fg.c dtpu_fg_gen_y / _uv) at
// the block's random offset byte o (ops/fg.py row_offsets): column
// 3 + (2 >> ss_x) (3 + (o >> 4)) + xx, row 3 + (2 >> ss_y) (3 + (o & 15))
// + yy.  With overlap, the first 2 >> ss_x columns of a block blend with
// the left block's LUT read one block further right, and the first
// 2 >> ss_y rows of a block row with the upper row's generator read one
// block further down (itself blended with its left neighbour first), each
// blend round2(old w0 + new w1, 5) clipped to the grain range (reference
// sample_lut and the overlap loops of fgy/fguv_32x32xn,
// src/filmgrain_tmpl.c; dav1d_tpu/recon/filmgrain.py _grain_blocks).
//
// The scaling index is the pixel for luma; for chroma the luma average
// under it (the horizontal pair, the right one clamped to the luma width;
// the top row of a vertical pair), itself with chroma_scaling_from_luma,
// else clip((avg uv_luma_mult + src uv_mult) >> 6 + uv_offset
// 2^(bd-8), 0, 2^bd - 1).  The pixel is then clip(src + round2(scaling
// [idx] grain, scaling_shift), minv, maxv).  Every intermediate fits
// int32: |grain| <= 2^11, scaling <= 255.
//
// A group is 4 pixels x0 .. x0 + 3 of one row, x0 a multiple of 4: it
// never straddles a grain block (16 or 32 columns), so its block
// geometry (by shifts) and offsets are read once.  A thread takes the
// group at one column on ROWS rows (GY apart): load() issues every row's
// pixel loads (and, for chroma, the luma under them) and its block's
// offset byte into registers before any is used, the pixels as one
// 16-byte load where the row segment is whole and aligned and as scalar
// loads in the ragged groups (the plane's last columns, a row that is
// not 16-byte aligned); finish() issues every row's grain LUT reads,
// then computes and stores the rows.  Between the two the CTA stages the
// scaling LUT in shared memory.
//
// The header compiles as CUDA device code (included by fg.cu) and as
// plain C++ (a host build runs the same phases thread by thread), so
// nothing outside the FG_* macros uses a CUDA builtin.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define FG_FN __device__ __forceinline__
#define FG_LDG(p) __ldg(p)
#define FG_LDG4(p) __ldg(reinterpret_cast<const int4*>(p))
#define FG_ST4(p, v) (*reinterpret_cast<int4*>(p) = (v))
typedef int4 fg_int4;
#else
#define FG_FN inline
#define FG_LDG(p) (*(p))
struct fg_int4 {
    int x, y, z, w;
};
#define FG_LDG4(p) (fg_int4{(p)[0], (p)[1], (p)[2], (p)[3]})
#define FG_ST4(p, v) \
    ((p)[0] = (v).x, (p)[1] = (v).y, (p)[2] = (v).z, (p)[3] = (v).w)
#endif

namespace fg {

constexpr int GRAIN_W = 82, LUT_ROWS = 74, BLOCK = 32;
constexpr int N_PARAMS = 12;
// a CTA: THREADS threads, GX groups (4 GX columns) by GY rows, each thread
// ROWS rows: ROWS_LUMA in a luma plane, ROWS_CHROMA in a chroma plane
// (csrc/fg.cu says why)
constexpr int THREADS = 256, GX = 32, GY = THREADS / GX;
constexpr int ROWS_LUMA = 4, ROWS_CHROMA = 1;

struct Params {  // ops/fg.py PlaneParams.ints()
    int pl, ss_x, ss_y, bd, shift, minv, maxv, overlap, csfl, uv_mult,
        uv_luma_mult, uv_offset;
};

// The planes of a launch: the top-left w x h pixels of src (row stride
// ss) into out (row stride w); luma (row stride ls, cropped width lw)
// for a chroma plane.
struct Planes {
    const int* src;
    long long ss;
    const int* luma;
    long long ls;
    int lw;
    int* out;
    int w, h;
};

FG_FN int clip(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

FG_FN bool aligned16(const int* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

FG_FN int lane(const fg_int4& v, int k) {
    return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

// LUT read of block offset byte o, one block right / down when bxs / bys
FG_FN int lut_at(const int* lut, int o, int bxs, int bys, int xx, int yy,
                 const Params& p) {
    const int ox = 3 + (2 >> p.ss_x) * (3 + (o >> 4)) +
                   (BLOCK >> p.ss_x) * bxs + xx;
    const int oy = 3 + (2 >> p.ss_y) * (3 + (o & 15)) +
                   (BLOCK >> p.ss_y) * bys + yy;
    return FG_LDG(lut + oy * GRAIN_W + ox);
}

FG_FN int blend(int old, int cur, int w0, int w1, int gctr) {
    return clip((old * w0 + cur * w1 + 16) >> 5, -gctr, gctr - 1);
}

// weight k (0 old, 1 new) of overlap position i under subsampling s
FG_FN int wsub(int s, int i, int k) {
    return s ? (k ? 22 : 23) : (i ? (k ? 27 : 17) : (k ? 17 : 27));
}

// The offsets pair of the block that holds pixel (x0, y); offs: the
// frame's (n_rows, n_blocks, 2) offsets.
FG_FN const int* block_offs(const int* offs, int n_blocks, int x0, int y,
                            const Params& p) {
    const int row = y >> (5 - p.ss_y), bi = x0 >> (5 - p.ss_x);
    return offs + ((long long)row * n_blocks + bi) * 2;
}

// The grain values g[0..3] of pixels x0 .. x0 + 3 of row y (x0 a multiple
// of 4) before the overlap blends: four consecutive LUT words at the
// block's offset byte o0.
FG_FN void grain_base(const int* lut, int o0, int x0, int y, const Params& p,
                      int* g) {
    const int yy = y & ((BLOCK >> p.ss_y) - 1);
    const int xx0 = x0 & ((BLOCK >> p.ss_x) - 1);
    const int oy = 3 + (2 >> p.ss_y) * (3 + (o0 & 15)) + yy;
    const int* q = lut + oy * GRAIN_W + 3 + (2 >> p.ss_x) * (3 + (o0 >> 4)) +
                   xx0;
#pragma unroll
    for (int k = 0; k < 4; k++) g[k] = FG_LDG(q + k);
}

// The overlap blends of g[0..3] (grain_base's) with the left block (the
// block's first 2 >> ss_x columns, which lie in its first group) and the
// upper block row (its first 2 >> ss_y rows); o: block_offs of the group.
FG_FN void grain_overlap(const int* lut, const int* o, int x0, int y,
                         const Params& p, int* g) {
    const int row = y >> (5 - p.ss_y), yy = y & ((BLOCK >> p.ss_y) - 1);
    const int bi = x0 >> (5 - p.ss_x), xx0 = x0 & ((BLOCK >> p.ss_x) - 1);
    const bool mx = bi > 0 && xx0 == 0;
    const bool my = row > 0 && yy < (2 >> p.ss_y);
    if (!(mx || my)) return;
    const int gctr = 128 << (p.bd - 8);
    const int nx = mx ? 2 >> p.ss_x : 0;
    const int ol0 = mx ? FG_LDG(o - 2) : 0;
    const int o1 = my ? FG_LDG(o + 1) : 0;
    const int ol1 = mx && my ? FG_LDG(o - 1) : 0;
#pragma unroll
    for (int k = 0; k < 4; k++) {
        int gk = g[k];
        if (k < nx)
            gk = blend(lut_at(lut, ol0, 1, 0, k, yy, p), gk,
                       wsub(p.ss_x, k, 0), wsub(p.ss_x, k, 1), gctr);
        if (my) {
            int t = lut_at(lut, o1, 0, 1, xx0 + k, yy, p);
            if (k < nx)
                t = blend(lut_at(lut, ol1, 1, 1, k, yy, p), t,
                          wsub(p.ss_x, k, 0), wsub(p.ss_x, k, 1), gctr);
            gk = blend(t, gk, wsub(p.ss_y, yy, 0), wsub(p.ss_y, yy, 1),
                       gctr);
        }
        g[k] = gk;
    }
}

// The scaling index of a chroma pixel s over the luma average avg.
FG_FN int chroma_index(int avg, int s, const Params& p) {
    if (p.csfl) return avg;
    const int comb = avg * p.uv_luma_mult + s * p.uv_mult;
    return clip((comb >> 6) + p.uv_offset * (1 << (p.bd - 8)), 0,
                (1 << p.bd) - 1);
}

// The grained value of pixel value s with grain g, scaling value sc
// (scaling[index]).
FG_FN int apply(int s, int sc, int g, const Params& p) {
    const int noise = (sc * g + ((1 << p.shift) >> 1)) >> p.shift;
    return clip(s + noise, p.minv, p.maxv);
}

// ---- the phases of one thread ----------------------------------------

// A thread's loads in flight: each row's group, for chroma the luma
// pixels under it (2 x 4 with ss_x, else 4 in l[k][0]), and the offset
// byte of each row's block.
template <bool CHROMA, int ROWS>
struct Regs {
    fg_int4 s[ROWS];
    fg_int4 l[CHROMA ? ROWS : 1][2];
    int o0[ROWS];
};

// Thread (gx, gy) of CTA (bx, by): its group's first column and first
// row.
FG_FN int group_x(int bx, int tid) { return (bx * GX + tid % GX) * 4; }
template <int ROWS>
FG_FN int group_y(int by, int tid) {
    return by * GY * ROWS + tid / GX;
}

// Scalar loads of n <= 4 pixels at p (the ragged groups); zero beyond.
FG_FN fg_int4 load_ragged(const int* q, int n) {
    fg_int4 v;
    v.x = FG_LDG(q);
    v.y = n > 1 ? FG_LDG(q + 1) : 0;
    v.z = n > 2 ? FG_LDG(q + 2) : 0;
    v.w = n > 3 ? FG_LDG(q + 3) : 0;
    return v;
}

// Issue the loads of every row of the thread's group: the pixels, for
// chroma the luma under them, and the block's offset byte (0 on rows past
// the plane, whose LUT reads finish() still makes).
template <bool CHROMA, int ROWS>
FG_FN void load(Regs<CHROMA, ROWS>& r, const Planes& pl, const int* offs,
                int n_blocks, int x0, int y0, const Params& p) {
    if (x0 >= pl.w) return;
    const int n = pl.w - x0 < 4 ? pl.w - x0 : 4;
#pragma unroll
    for (int k = 0; k < ROWS; k++) {
        const int y = y0 + GY * k;
        r.o0[k] = y < pl.h ? FG_LDG(block_offs(offs, n_blocks, x0, y, p))
                           : 0;
        if (y >= pl.h) continue;
        const int* s = pl.src + y * pl.ss + x0;
        r.s[k] = n == 4 && aligned16(s) ? FG_LDG4(s) : load_ragged(s, n);
        if (!CHROMA) continue;
        const int* l = pl.luma + (long long)(y << p.ss_y) * pl.ls;
        if (p.ss_x) {
            // luma columns 2 x0 .. 2 x0 + 7, the last clamped to lw - 1
            const int lx = 2 * x0;
            if (lx + 8 <= pl.lw && aligned16(l + lx)) {
                r.l[CHROMA ? k : 0][0] = FG_LDG4(l + lx);
                r.l[CHROMA ? k : 0][1] = FG_LDG4(l + lx + 4);
            } else {
                int v[8];
#pragma unroll
                for (int m = 0; m < 8; m++) {
                    const int c = lx + m < pl.lw - 1 ? lx + m : pl.lw - 1;
                    v[m] = (m >> 1) < n ? FG_LDG(l + c) : 0;
                }
                r.l[CHROMA ? k : 0][0] = fg_int4{v[0], v[1], v[2], v[3]};
                r.l[CHROMA ? k : 0][1] = fg_int4{v[4], v[5], v[6], v[7]};
            }
        } else {
            r.l[CHROMA ? k : 0][0] = n == 4 && aligned16(l + x0)
                                         ? FG_LDG4(l + x0)
                                         : load_ragged(l + x0, n);
        }
    }
}

// The scaling LUT (1 << bd entries) into shared memory, the thread's
// share.
FG_FN void stage_scaling(short* s_sc, const int* scaling, int bd, int tid,
                         int nt) {
    for (int i = tid; i < (1 << bd); i += nt)
        s_sc[i] = (short)FG_LDG(scaling + i);
}

// Grain, index, scale and store every row of the thread's group (after
// load() and the scaling LUT's staging): every row's LUT reads first,
// then row by row the overlap blends, the index, the scale and the
// stores.
template <bool CHROMA, int ROWS>
FG_FN void finish(const Regs<CHROMA, ROWS>& r, const short* s_sc,
                  const Planes& pl, const int* lut, const int* offs,
                  int n_blocks, int x0, int y0, const Params& p) {
    if (x0 >= pl.w) return;
    const int n = pl.w - x0 < 4 ? pl.w - x0 : 4;
    int g[ROWS][4];
#pragma unroll
    for (int k = 0; k < ROWS; k++)
        grain_base(lut, r.o0[k], x0, y0 + GY * k, p, g[k]);
#pragma unroll
    for (int k = 0; k < ROWS; k++) {
        const int y = y0 + GY * k;
        if (y >= pl.h) break;
        if (p.overlap)
            grain_overlap(lut, block_offs(offs, n_blocks, x0, y, p), x0, y,
                          p, g[k]);
        int o[4];
#pragma unroll
        for (int m = 0; m < 4; m++) {
            const int s = lane(r.s[k], m);
            int idx = s;
            if (CHROMA) {
                const fg_int4* l = r.l[CHROMA ? k : 0];
                const int avg =
                    p.ss_x ? (lane(l[m >> 1], (2 * m) & 3) +
                              lane(l[m >> 1], (2 * m + 1) & 3) + 1) >> 1
                           : lane(l[0], m);
                idx = chroma_index(avg, s, p);
            }
            o[m] = apply(s, s_sc[idx], g[k][m], p);
        }
        int* d = pl.out + (long long)y * pl.w + x0;
        if (n == 4 && aligned16(d)) {
            FG_ST4(d, (fg_int4{o[0], o[1], o[2], o[3]}));
        } else {
#pragma unroll
            for (int m = 0; m < 4; m++)
                if (m < n) d[m] = o[m];
        }
    }
}

}  // namespace fg
