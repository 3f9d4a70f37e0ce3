// Every inverse transform of a frame in one launch.
//
// Replaces the TPU kernel dav1d_tpu/ops/pallas_itx.py _build (body
// _core2d), which runs one pallas_call per (tx size, tx type, bit depth)
// over a batch padded to a power-of-two multiple of its tile, with the
// XLA program ops/itx._itx_core for 12-bit (int32 split rotations);
// the reference decoder launches one such program per (tx, txtp) group,
// about 24 a 1080p frame.  Here one launch covers every captured
// transform block of every plane, whatever its size and type.
//
// Jobs: int32 rows (coefficient offset into the frame's coefficient
// arena, tx, txtp, output offset), sorted by tx size (ops/itx.py
// job_table); the coefficients of a job are the arena's sw*sh words at
// its offset, column-major, zero beyond eob.  Schedule: int32 group rows
// (first job, job count, tx size), consecutive jobs of one tx size
// (ops/itx.py group_list), one CTA each.  Output: one flat buffer of
// every job's h x w residuals, row-major at its offset, int16 at
// 8/10-bit and int32 at 12-bit (12-bit IDTX exceeds int16).
//
// A CTA of 64 threads runs the phases of itx_core.cuh on its group:
// setup, load (coalesced, with the rect2 pre-scale and the row flags),
// the row pass over the flagged rows only (the other rows are zero and
// stay zero), the column pass of every column with the store of
// (v + 8) >> 4; three barriers.  A group holds 64 / w jobs of width w,
// so every column of the group has a lane: a warp holds eight 4x4 jobs,
// four 8x8 or two 16x16, a 32x32 job a warp, a 64-wide job the CTA.  The
// arithmetic is int32 at 8/10-bit, as the JAX device tier's, and int64
// at 12-bit (exact; the reference's int32 split forms are rewrites of
// the same values).
//
// Bound on the H100: the coefficient reads and residual writes, a few
// MB a 1080p frame (microseconds), above the butterflies that the
// nonzero rows and every column need.  The first design (one CTA of 64
// threads per job, a 64x65 tile each, every coded row transformed,
// column-strided coefficient reads) kept 4 of 64 threads busy on a 4x4
// job and ran at 8% of that bound.  This one runs at about 20% of it
// back to back and 15% in a decode (PERF.md): what sets the pace is the
// latency of a CTA's chain — three dependent global reads, then one
// lane's serial 1-D transform per flagged row and per column — and, in
// a decode, the kernel's code arriving cold.
#include "common.cuh"
#include "itx_core.cuh"

namespace {

// At most 96 registers a thread, so that 10 CTAs fit an SM: the long
// 1-D transforms (dct64 keeps 64 values live) spill a little, and the
// launch is faster than at 127-167 registers and 6-8 CTAs (PERF.md).
template <typename T, typename O>
__global__ void __launch_bounds__(itx::LANES, 10)
    itx_frame_kernel(const int* __restrict__ cf, const int* __restrict__ jobs,
                     const int* __restrict__ groups, O* __restrict__ out,
                     int bitdepth) {
    __shared__ itx::Group<T> s;
    const int* G = groups + (long long)blockIdx.x * itx::GROUP_COLS;
    const int first = __ldg(G + itx::G_FIRST);
    const itx::Size z =
        itx::size_of(__ldg(G + itx::G_TX), __ldg(G + itx::G_COUNT));
    itx::Clip<T> rcl, ccl;
    itx::clips<T>(bitdepth, rcl, ccl);
    const int tid = threadIdx.x, nt = blockDim.x;

    itx::setup<T>(s, jobs, first, z, tid, nt);
    __syncthreads();
    itx::load<T>(s, cf, z, tid, nt);
    __syncthreads();
    itx::rows<T>(s, z, rcl, ccl, tid, nt);
    __syncthreads();
    itx::cols<T, O>(s, z, ccl, out, tid, nt);
}

}  // namespace

DTPU_API int dtpu_itx_frame(const int* cf, const int* jobs,
                            const int* groups, int n_groups, void* out,
                            int bitdepth, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (n_groups > 0) {
        if (bitdepth == 12)
            itx_frame_kernel<long long, int><<<n_groups, itx::LANES, 0, s>>>(
                cf, jobs, groups, (int*)out, bitdepth);
        else
            itx_frame_kernel<int, short><<<n_groups, itx::LANES, 0, s>>>(
                cf, jobs, groups, (short*)out, bitdepth);
    }
    return (int)cudaGetLastError();
}

// Registers, shared memory and resident CTAs per SM of the two
// instantiations (cudaFuncGetAttributes and
// cudaOccupancyMaxActiveBlocksPerMultiprocessor at the launch's 64
// threads): out[0..2] at 8/10-bit, out[3..5] at 12-bit.
DTPU_API int dtpu_itx_occupancy(int* out) {
    cudaFuncAttributes a;
    int n = 0;
    cudaError_t e = cudaFuncGetAttributes(&a, itx_frame_kernel<int, short>);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, itx_frame_kernel<int, short>, itx::LANES, 0);
    out[0] = a.numRegs;
    out[1] = (int)a.sharedSizeBytes;
    out[2] = n;
    if (e == cudaSuccess)
        e = cudaFuncGetAttributes(&a, itx_frame_kernel<long long, int>);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, itx_frame_kernel<long long, int>, itx::LANES, 0);
    out[3] = a.numRegs;
    out[4] = (int)a.sharedSizeBytes;
    out[5] = n;
    return (int)e;
}
