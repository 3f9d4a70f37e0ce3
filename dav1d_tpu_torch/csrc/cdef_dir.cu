// CDEF direction search over every 8-aligned 8x8 block of a luma plane.
//
// Replaces the TPU program dav1d_tpu/ops/cdef.py _jit_find_dir_maps
// (core _find_dir_t / _dir_from_psum_t), which builds the 8 partial-sum
// sets as one bf16 MXU contraction and the cost lattice as split-f32
// matmuls because the TPU's vector unit has no cheap integer reduction.
// Here one thread owns one block and forms the partial sums and costs
// in int32 registers, as the reference cdef_find_dir_c does
// (src/cdef_tmpl.c:239); the arithmetic, its semantics and the
// exactness argument are in cdef_dir_core.cuh.
//
// The bin weights (cost divisors 840..105) come in as an (8, 15) int32
// device table (dav1d_tpu_torch/state.py cdef_bin_weights), in cost-row
// order diag0, alt0, hv0, alt1, diag1, alt2, hv1, alt3.
//
// Bound on the H100: neither; a 1080p plane is 32,400 blocks, so the
// launch is latency-bound (one wave of small blocks).  Designs that
// spread a block over several lanes (eight lanes each loading a row
// into shared memory, a lane or a warp per direction, four lanes a
// block loading it through L1) were no faster in a decode (PERF.md).
#include "common.cuh"
#include "cdef_dir_core.cuh"

namespace {

__global__ void cdef_dir_kernel(const int* __restrict__ plane, int W,
                                int R8, int W8, int bd_m8,
                                const int* __restrict__ bw,
                                int* __restrict__ dir_out,
                                int* __restrict__ var_out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= R8 * W8) return;
    cdir::block(plane, W, bd_m8, bw, i / W8, i % W8, dir_out + i,
                var_out + i);
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
