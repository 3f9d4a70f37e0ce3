// The arithmetic of the super-res resize kernel (csrc/resize.cu): one
// output column of the horizontal 8-tap upscale over a few rows, as one
// thread of the kernel computes it.
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
// The header compiles as CUDA device code (included by resize.cu) and as
// plain C++ (a host build runs it thread by thread).
#pragma once

#ifdef __CUDACC__
#define RS_FN __device__ inline
#define RS_CONST __constant__
#define RS_LDG(p) __ldg(p)
#else
#define RS_FN inline
#define RS_CONST
#define RS_LDG(p) (*(p))
#endif

namespace rs {

// tables.resize_filter (64 filter rows of 8 taps, the spec's
// Upscale_Filter negated as the reference stores it)
RS_CONST const signed char FILTER[64][8] = {
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

// What a launch resamples: the source plane (row stride src_stride), the
// geometry of superres_geometry (decode/frame.py) and the output plane
// (out_rows x out_stride, row stride out_stride).
struct Params {
    const int* src;
    int src_stride, src_w, h, out_w, out_stride;
    int step, mx0, maxp;
};

// Output rows a thread computes.
constexpr int ROWS = 8;

// Rows [y0, y0 + n) (n <= ROWS) of output column x of the (out_rows,
// out_stride) plane into out (the column's first pixel, row stride
// out_stride): the column's source columns and filter row once, then
// every row's eight reads before any store, so that the reads of all
// the rows are in flight together (the output could alias the source
// as far as the compiler knows).
RS_FN void column(const Params& p, int x, int y0, int n, int* out) {
    const long long pos = (long long)p.mx0 + (long long)x * p.step;
    const int sx = (int)(pos >> 14) - 1;
    const signed char* f = FILTER[(int)((pos & 0x3FFF) >> 8)];
    const bool inside = x < p.out_w;
    int c[8], t[8], acc[ROWS];
#pragma unroll
    for (int k = 0; k < 8; k++) {
        const int v = sx - 3 + k;
        c[k] = v < 0 ? 0 : (v >= p.src_w ? p.src_w - 1 : v);
        t[k] = f[k];
    }
#pragma unroll
    for (int r = 0; r < ROWS; r++) {
        acc[r] = 0;
        if (inside && r < n && y0 + r < p.h) {
            const int* row = p.src + (long long)(y0 + r) * p.src_stride;
#pragma unroll
            for (int k = 0; k < 8; k++) acc[r] -= t[k] * RS_LDG(row + c[k]);
        }
    }
#pragma unroll
    for (int r = 0; r < ROWS; r++) {
        if (r >= n) break;
        int v = 0;
        if (inside && y0 + r < p.h) {
            v = (acc[r] + 64) >> 7;
            v = v < 0 ? 0 : (v > p.maxp ? p.maxp : v);
        }
        out[(long long)r * p.out_stride] = v;
    }
}

}  // namespace rs
