// Deblocking loop filter, one direction of one plane.
//
// Replaces the TPU kernels dav1d_tpu/ops/pallas_lf.py _build_v (vertical
// edges) and _build_h (horizontal edges), whose filter core is
// pallas_lf._core.  The TPU version evaluates the multi-width decision
// lattice at EVERY pixel of a row band as full-width vector ops (the
// VPU has no cheap gather); here one thread owns one line of one edge:
// a (4x4 cell, one of its 4 lines) pair of the packed cell map
// E | I << 8 | H << 16 | cls << 24 (ops/lf.cellmap).  Cells without an
// edge exit at once, so the work is proportional to the edges, not the
// plane.
//
// Semantics (pallas_lf / recon/lf.py): within one direction no edge
// reads another edge's writes, so every edge reads the input plane and
// writes a copy of it (the entry point copies src -> dst first, then the
// threads overwrite the pixels their edge changes).  Taps outside the
// plane read 0, as the TPU kernel's zero canvas padding does.  All
// arithmetic is int32: 12-bit wd16 sums stay exact.
//
// Bound on the H100: memory.  A launch reads the plane once (copy) plus
// <= 14 taps per edge line and writes <= 12 pixels per line; ~1 B of
// work per byte.  Design: no shared memory, early exit on empty cells;
// the copy is one cudaMemcpyAsync on the same stream.
#include "common.cuh"

namespace {

template <bool VERT>
__global__ void deblock_kernel(const int* __restrict__ src,
                               int* __restrict__ dst,
                               const int* __restrict__ cells, int H, int W,
                               int H4, int W4, int bitdepth, int luma) {
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    // VERT: thread = (pixel row y, cell column cx); the edge is the
    //       left boundary of the cell, column 4*cx, in row y.
    // HORZ: thread = (cell row cy, pixel column x); the edge is the top
    //       boundary of the cell, row 4*cy, in column x.
    int y0, x0, P;
    if (VERT) {
        if (i >= (long long)H * W4) return;
        y0 = (int)(i / W4);
        int cx = (int)(i % W4);
        x0 = 4 * cx;
        P = cells[(long long)(y0 >> 2) * W4 + cx];
    } else {
        if (i >= (long long)H4 * W) return;
        int cy = (int)(i / W);
        x0 = (int)(i % W);
        y0 = 4 * cy;
        P = cells[(long long)cy * W4 + (x0 >> 2)];
    }
    if (P == 0) return;

    const int cls = (P >> 24) & 255;
    int wd;
    if (luma)
        wd = cls == 1 ? 4 : cls == 2 ? 8 : cls == 3 ? 16 : 0;
    else
        wd = cls == 1 ? 4 : cls == 2 ? 6 : 0;
    if (!wd) return;

    const int bd_m8 = bitdepth - 8;
    const int F = 1 << bd_m8;
    const int maxp = (1 << bitdepth) - 1;
    const int cd_lim = 128 << bd_m8;
    const int E = (P & 255) << bd_m8;
    const int I = ((P >> 8) & 255) << bd_m8;
    const int Hl = ((P >> 16) & 255) << bd_m8;

    // o < 0: p side (tap(-1 - k) = p_k), o >= 0: q side (tap(k) = q_k)
    auto tap = [&](int o) -> int {
        int y = VERT ? y0 : y0 + o;
        int x = VERT ? x0 + o : x0;
        return (y >= 0 && y < H && x >= 0 && x < W)
                   ? src[(long long)y * W + x] : 0;
    };
    auto put = [&](int o, int v) {
        int y = VERT ? y0 : y0 + o;
        int x = VERT ? x0 + o : x0;
        if (y >= 0 && y < H && x >= 0 && x < W)
            dst[(long long)y * W + x] = v;
    };

    const int p1 = tap(-2), p0 = tap(-1), q0 = tap(0), q1 = tap(1);
    if (!(dtpu_abs(p1 - p0) <= I && dtpu_abs(q1 - q0) <= I &&
          2 * dtpu_abs(p0 - q0) + (dtpu_abs(p1 - q1) >> 1) <= E))
        return;

    bool narrow = false;
    if (wd == 4) {
        narrow = true;
    } else {
        const int p2 = tap(-3), q2 = tap(2);
        if (!(dtpu_abs(p2 - p1) <= I && dtpu_abs(q2 - q1) <= I)) return;
        const bool flat6 = dtpu_abs(p2 - p0) <= F && dtpu_abs(p1 - p0) <= F &&
                           dtpu_abs(q1 - q0) <= F && dtpu_abs(q2 - q0) <= F;
        if (wd == 6) {
            if (flat6) {
                put(-2, (3 * p2 + 2 * p1 + 2 * p0 + q0 + 4) >> 3);
                put(-1, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3);
                put(0, (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3);
                put(1, (p0 + 2 * q0 + 2 * q1 + 3 * q2 + 4) >> 3);
                return;
            }
            narrow = true;
        } else {
            const int p3 = tap(-4), q3 = tap(3);
            if (!(dtpu_abs(p3 - p2) <= I && dtpu_abs(q3 - q2) <= I)) return;
            const bool flat8 = flat6 && dtpu_abs(p3 - p0) <= F &&
                               dtpu_abs(q3 - q0) <= F;
            if (!flat8) {
                narrow = true;
            } else {
                bool big = false;
                int p4 = 0, p5 = 0, p6 = 0, q4 = 0, q5 = 0, q6 = 0;
                if (wd == 16) {
                    p6 = tap(-7); p5 = tap(-6); p4 = tap(-5);
                    q4 = tap(4); q5 = tap(5); q6 = tap(6);
                    big = dtpu_abs(p6 - p0) <= F && dtpu_abs(p5 - p0) <= F &&
                          dtpu_abs(p4 - p0) <= F && dtpu_abs(q4 - q0) <= F &&
                          dtpu_abs(q5 - q0) <= F && dtpu_abs(q6 - q0) <= F;
                }
                if (big) {
                    put(-6, (7 * p6 + 2 * p5 + 2 * p4 + p3 + p2 + p1 + p0 +
                             q0 + 8) >> 4);
                    put(-5, (5 * p6 + 2 * p5 + 2 * p4 + 2 * p3 + p2 + p1 +
                             p0 + q0 + q1 + 8) >> 4);
                    put(-4, (4 * p6 + p5 + 2 * p4 + 2 * p3 + 2 * p2 + p1 +
                             p0 + q0 + q1 + q2 + 8) >> 4);
                    put(-3, (3 * p6 + p5 + p4 + 2 * p3 + 2 * p2 + 2 * p1 +
                             p0 + q0 + q1 + q2 + q3 + 8) >> 4);
                    put(-2, (2 * p6 + p5 + p4 + p3 + 2 * p2 + 2 * p1 +
                             2 * p0 + q0 + q1 + q2 + q3 + q4 + 8) >> 4);
                    put(-1, (p6 + p5 + p4 + p3 + p2 + 2 * p1 + 2 * p0 +
                             2 * q0 + q1 + q2 + q3 + q4 + q5 + 8) >> 4);
                    put(0, (p5 + p4 + p3 + p2 + p1 + 2 * p0 + 2 * q0 +
                            2 * q1 + q2 + q3 + q4 + q5 + q6 + 8) >> 4);
                    put(1, (p4 + p3 + p2 + p1 + p0 + 2 * q0 + 2 * q1 +
                            2 * q2 + q3 + q4 + q5 + 2 * q6 + 8) >> 4);
                    put(2, (p3 + p2 + p1 + p0 + q0 + 2 * q1 + 2 * q2 +
                            2 * q3 + q4 + q5 + 3 * q6 + 8) >> 4);
                    put(3, (p2 + p1 + p0 + q0 + q1 + 2 * q2 + 2 * q3 +
                            2 * q4 + q5 + 4 * q6 + 8) >> 4);
                    put(4, (p1 + p0 + q0 + q1 + q2 + 2 * q3 + 2 * q4 +
                            2 * q5 + 5 * q6 + 8) >> 4);
                    put(5, (p0 + q0 + q1 + q2 + q3 + 2 * q4 + 2 * q5 +
                            7 * q6 + 8) >> 4);
                } else {
                    put(-3, (3 * p3 + 2 * p2 + p1 + p0 + q0 + 4) >> 3);
                    put(-2, (2 * p3 + p2 + 2 * p1 + p0 + q0 + q1 + 4) >> 3);
                    put(-1, (p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2 + 4) >> 3);
                    put(0, (p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3 + 4) >> 3);
                    put(1, (p1 + p0 + q0 + 2 * q1 + q2 + 2 * q3 + 4) >> 3);
                    put(2, (p0 + q0 + q1 + 2 * q2 + 3 * q3 + 4) >> 3);
                }
                return;
            }
        }
    }
    if (narrow) {
        const bool hev = dtpu_abs(p1 - p0) > Hl || dtpu_abs(q1 - q0) > Hl;
        const int d30 = 3 * (q0 - p0);
        int fv = hev ? d30 + dtpu_clip(p1 - q1, -cd_lim, cd_lim - 1) : d30;
        fv = dtpu_clip(fv, -cd_lim, cd_lim - 1);
        const int f1 = min(fv + 4, cd_lim - 1) >> 3;
        const int f2 = min(fv + 3, cd_lim - 1) >> 3;
        put(-1, dtpu_clip(p0 + f2, 0, maxp));
        put(0, dtpu_clip(q0 - f1, 0, maxp));
        if (!hev) {
            const int fo = (f1 + 1) >> 1;
            put(-2, dtpu_clip(p1 + fo, 0, maxp));
            put(1, dtpu_clip(q1 - fo, 0, maxp));
        }
    }
}

}  // namespace

// One deblock pass over an (H, W) int32 plane: dst = src with every edge
// of `cells` ((H+3)/4, (W+3)/4) int32, packed) filtered.  vertical != 0
// filters vertical edges, else horizontal edges.  Returns cudaError_t.
DTPU_API int dtpu_deblock(const int* src, int* dst, const int* cells, int H,
                          int W, int vertical, int bitdepth, int luma,
                          void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t e = cudaMemcpyAsync(dst, src, (size_t)H * W * sizeof(int),
                                    cudaMemcpyDeviceToDevice, s);
    if (e != cudaSuccess) return (int)e;
    const int H4 = (H + 3) >> 2, W4 = (W + 3) >> 2;
    const int threads = 256;
    if (vertical)
        deblock_kernel<true><<<dtpu_blocks((long long)H * W4, threads),
                               threads, 0, s>>>(src, dst, cells, H, W, H4,
                                                W4, bitdepth, luma);
    else
        deblock_kernel<false><<<dtpu_blocks((long long)H4 * W, threads),
                                threads, 0, s>>>(src, dst, cells, H, W, H4,
                                                 W4, bitdepth, luma);
    return (int)cudaGetLastError();
}
