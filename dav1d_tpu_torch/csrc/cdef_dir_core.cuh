// The arithmetic of the CDEF direction search kernel (csrc/cdef_dir.cu):
// the direction and variance of one 8x8 block, as one thread of the
// kernel computes them.
//
// Semantics (reference cdef_find_dir_c, src/cdef_tmpl.c:239; the plain
// version ops/cdef.find_dir_maps_plain): px = (pixel >> (bd - 8)) - 128;
// eight partial-sum sets, one per direction, in cost-row order
//   0 diag0  bin y + x          (15 bins)
//   1 alt0   bin y + (x >> 1)   (11)
//   2 hv0    bin y              (8)
//   3 alt1   bin 3 + y - (x >> 1)
//   4 diag1  bin 7 + y - x      (15)
//   5 alt2   bin 3 - (y >> 1) + x
//   6 hv1    bin x              (8)
//   7 alt3   bin (y >> 1) + x   (11)
// cost[d] = sum over bins of bin_weight[d][bin] * psum^2 (the (8, 15)
// table state.cdef_bin_weights, divisors 840..105); dir = the strict
// first maximum of cost, var = (cost[dir] - cost[dir ^ 4]) >> 10.  No
// float arithmetic anywhere: a TF32 pass would silently break
// exactness.  Exact in int32: |psum| <= 8 * 128, and the largest cost
// is 880,803,840 < 2^31 (ops/cdef._dir_from_psum_t).
//
// The loops are fully unrolled so that every partial sum stays in a
// register.
//
// The header compiles as CUDA device code (included by cdef_dir.cu) and
// as plain C++ (a host build runs it block by block).
#pragma once

#ifdef __CUDACC__
#define CDIR_FN __device__ inline
#else
#define CDIR_FN inline
#endif

namespace cdir {

// Block (by, bx) of the int32 plane (row stride W): its direction into
// *dir and its variance into *var.
CDIR_FN void block(const int* __restrict__ plane, int W, int bd_m8,
                   const int* __restrict__ bw, int by, int bx, int* dir,
                   int* var) {
    int hv0[8] = {0}, hv1[8] = {0};
    int dg0[15] = {0}, dg1[15] = {0};
    int a0[11] = {0}, a1[11] = {0}, a2[11] = {0}, a3[11] = {0};
#pragma unroll
    for (int y = 0; y < 8; y++) {
        const int* row = plane + (long long)(by * 8 + y) * W + bx * 8;
#pragma unroll
        for (int x = 0; x < 8; x++) {
            const int px = (row[x] >> bd_m8) - 128;
            dg0[y + x] += px;
            a0[y + (x >> 1)] += px;
            hv0[y] += px;
            a1[3 + y - (x >> 1)] += px;
            dg1[7 + y - x] += px;
            a2[3 - (y >> 1) + x] += px;
            hv1[x] += px;
            a3[(y >> 1) + x] += px;
        }
    }

    int cost[8] = {0};
#pragma unroll
    for (int b = 0; b < 15; b++) {
        cost[0] += bw[0 * 15 + b] * dg0[b] * dg0[b];
        cost[4] += bw[4 * 15 + b] * dg1[b] * dg1[b];
    }
#pragma unroll
    for (int b = 0; b < 8; b++) {
        cost[2] += bw[2 * 15 + b] * hv0[b] * hv0[b];
        cost[6] += bw[6 * 15 + b] * hv1[b] * hv1[b];
    }
#pragma unroll
    for (int b = 0; b < 11; b++) {
        cost[1] += bw[1 * 15 + b] * a0[b] * a0[b];
        cost[3] += bw[3 * 15 + b] * a1[b] * a1[b];
        cost[5] += bw[5 * 15 + b] * a2[b] * a2[b];
        cost[7] += bw[7 * 15 + b] * a3[b] * a3[b];
    }

    // strict first maximum
    int best = 0, best_cost = cost[0];
#pragma unroll
    for (int d = 1; d < 8; d++) {
        if (cost[d] > best_cost) {
            best_cost = cost[d];
            best = d;
        }
    }
    int alt_cost = cost[0];
#pragma unroll
    for (int d = 1; d < 8; d++)
        if ((best ^ 4) == d) alt_cost = cost[d];
    *dir = best;
    *var = (best_cost - alt_cost) >> 10;
}

}  // namespace cdir
