// The arithmetic of the film-grain kernel (csrc/fg.cu): one output pixel
// of one plane.
//
// A pixel (x, y) of a plane lies in grain block bi = x / bsz of block row
// row = y / bszy (bsz = 32 >> ss_x, bszy = 32 >> ss_y), at (xx, yy) inside
// it.  Its grain value is the plane's grain LUT (74 x 82 int32, native/fg.c
// dtpu_fg_gen_y / _uv) at the block's random offset byte o (ops/fg.py
// row_offsets): column 3 + (2 >> ss_x) (3 + (o >> 4)) + xx, row
// 3 + (2 >> ss_y) (3 + (o & 15)) + yy.  With overlap, the first 2 >> ss_x
// columns of a block blend with the left block's LUT read one block
// further right, and the first 2 >> ss_y rows of a block row with the
// upper row's generator read one block further down (itself blended with
// its left neighbour first), each blend round2(old w0 + new w1, 5)
// clipped to the grain range (reference sample_lut and the overlap loops
// of fgy/fguv_32x32xn, src/filmgrain_tmpl.c; dav1d_tpu/recon/filmgrain.py
// _grain_blocks).
//
// The scaling index is the pixel for luma; for chroma the luma average
// under it (the horizontal pair, the right one clamped to the luma width;
// the top row of a vertical pair), itself with chroma_scaling_from_luma,
// else clip((avg uv_luma_mult + src uv_mult) >> 6 + uv_offset
// 2^(bd-8), 0, 2^bd - 1).  The pixel is then clip(src + round2(scaling
// [idx] grain, scaling_shift), minv, maxv).  Every intermediate fits
// int32: |grain| <= 2^11, scaling <= 255.
//
// The header compiles as CUDA device code (included by fg.cu) and as
// plain C++ (a host build runs it pixel by pixel), so nothing outside
// the FG_* macros uses a CUDA builtin.
#pragma once

#ifdef __CUDACC__
#define FG_FN __device__ __forceinline__
#define FG_LDG(p) __ldg(p)
#else
#define FG_FN inline
#define FG_LDG(p) (*(p))
#endif

namespace fg {

constexpr int GRAIN_W = 82, LUT_ROWS = 74, BLOCK = 32;
constexpr int N_PARAMS = 12;

struct Params {  // ops/fg.py PlaneParams.ints()
    int pl, ss_x, ss_y, bd, shift, minv, maxv, overlap, csfl, uv_mult,
        uv_luma_mult, uv_offset;
};

FG_FN int clip(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
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

// The blended grain value of pixel (x, y); offs: the frame's
// (n_rows, n_blocks, 2) offsets.
FG_FN int grain(const int* lut, const int* offs, int n_blocks, int x, int y,
                const Params& p) {
    const int bsz = BLOCK >> p.ss_x, bszy = BLOCK >> p.ss_y;
    const int row = y / bszy, yy = y % bszy;
    const int bi = x / bsz, xx = x % bsz;
    const int* o = offs + ((long long)row * n_blocks + bi) * 2;
    int g = lut_at(lut, FG_LDG(o), 0, 0, xx, yy, p);
    if (!p.overlap) return g;
    const int gctr = 128 << (p.bd - 8);
    const bool mx = bi > 0 && xx < (2 >> p.ss_x);
    const bool my = row > 0 && yy < (2 >> p.ss_y);
    if (mx)
        g = blend(lut_at(lut, FG_LDG(o - 2), 1, 0, xx, yy, p), g,
                  wsub(p.ss_x, xx, 0), wsub(p.ss_x, xx, 1), gctr);
    if (my) {
        int t = lut_at(lut, FG_LDG(o + 1), 0, 1, xx, yy, p);
        if (mx)
            t = blend(lut_at(lut, FG_LDG(o - 1), 1, 1, xx, yy, p), t,
                      wsub(p.ss_x, xx, 0), wsub(p.ss_x, xx, 1), gctr);
        g = blend(t, g, wsub(p.ss_y, yy, 0), wsub(p.ss_y, yy, 1), gctr);
    }
    return g;
}

// The scaling index of pixel (x, y) with value s; luma: the grain-free
// luma plane (row stride ls, cropped width lw).
FG_FN int index(int s, const int* luma, long long ls, int lw, int x, int y,
                const Params& p) {
    if (p.pl == 0) return s;
    const int* l0 = luma + (long long)(y << p.ss_y) * ls;
    int avg;
    if (p.ss_x) {
        const int lx0 = x * 2;
        const int lx1 = lx0 + 1 < lw ? lx0 + 1 : lw - 1;
        avg = (FG_LDG(l0 + lx0) + FG_LDG(l0 + lx1) + 1) >> 1;
    } else {
        avg = FG_LDG(l0 + x);
    }
    if (p.csfl) return avg;
    const int comb = avg * p.uv_luma_mult + s * p.uv_mult;
    return clip((comb >> 6) + p.uv_offset * (1 << (p.bd - 8)), 0,
                (1 << p.bd) - 1);
}

// The grained value of pixel (x, y) with value s and grain g, scaling
// value sc (scaling[index]).
FG_FN int apply(int s, int sc, int g, const Params& p) {
    const int noise = (sc * g + ((1 << p.shift) >> 1)) >> p.shift;
    return clip(s + noise, p.minv, p.maxv);
}

}  // namespace fg
