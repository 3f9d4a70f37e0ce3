// CDEF direction search over every 8-aligned 8x8 block of a luma plane.
//
// Replaces the TPU program dav1d_tpu/ops/cdef.py _jit_find_dir_maps
// (core _find_dir_t / _dir_from_psum_t), which builds the 8 partial-sum
// sets as one bf16 MXU contraction and the cost lattice as split-f32
// matmuls because the TPU's vector unit has no cheap integer reduction.
// Here one thread owns one block and forms the partial sums and costs
// in int32 registers, as the reference cdef_find_dir_c does
// (src/cdef_tmpl.c:239).  No float arithmetic anywhere: a TF32 pass
// would silently break exactness.  Exact in int32: |psum| <= 8*128, and
// the largest cost is 880,803,840 < 2^31 (ops/cdef._dir_from_psum_t).
//
// The bin weights (cost divisors 840..105) come in as an (8, 15) int32
// device table (dav1d_tpu_torch/state.py cdef_bin_weights), in cost-row
// order diag0, alt0, hv0, alt1, diag1, alt2, hv1, alt3.
//
// Bound on the H100: neither; a 1080p plane is 32,400 blocks, so the
// launch is latency-bound (one wave of small blocks).  Design: the
// loops are fully unrolled so every partial sum stays in a register.
#include "common.cuh"

namespace {

__global__ void cdef_dir_kernel(const int* __restrict__ plane, int W,
                                int R8, int W8, int bd_m8,
                                const int* __restrict__ bw,
                                int* __restrict__ dir_out,
                                int* __restrict__ var_out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= R8 * W8) return;
    const int by = i / W8, bx = i % W8;

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
    dir_out[i] = best;
    var_out[i] = (best_cost - alt_cost) >> 10;
}

}  // namespace

// Direction and variance of every 8x8 block of an (H, W) int32 plane
// (row stride W): dir/var are (H/8, W/8) int32.  Returns cudaError_t.
DTPU_API int dtpu_cdef_dir(const int* plane, int H, int W, int bitdepth,
                           const int* bin_weights, int* dir, int* var,
                           void* stream) {
    const int R8 = H / 8, W8 = W / 8;
    if (R8 * W8 == 0) return (int)cudaSuccess;
    const int threads = 128;
    cdef_dir_kernel<<<dtpu_blocks((long long)R8 * W8, threads), threads, 0,
                      (cudaStream_t)stream>>>(plane, W, R8, W8, bitdepth - 8,
                                              bin_weights, dir, var);
    return (int)cudaGetLastError();
}
