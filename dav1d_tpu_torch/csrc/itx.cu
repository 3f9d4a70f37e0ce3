// Every inverse transform of a frame in one launch.
//
// Replaces the TPU kernel dav1d_tpu/ops/pallas_itx.py _build (body
// _core2d), which runs one pallas_call per (tx size, tx type, bit depth)
// over a batch padded to a power-of-two multiple of its tile, with the
// XLA program ops/itx._itx_core for 12-bit (int32 split rotations);
// the reference decoder launches one such program per (tx, txtp) group,
// about 24 a 1080p frame.  Here one launch covers every captured
// transform block of every plane, whatever its size and type: a flat job
// list (ops/itx.py job_table), one CTA per job.
//
// Jobs: int32 rows (coefficient offset into the frame's coefficient
// arena, tx, txtp, output offset); the coefficients of a job are the
// arena's sw*sh words at its offset, column-major, zero beyond eob.
// Output: one flat buffer of every job's h x w residuals, row-major at
// its offset, int16 at 8/10-bit and int32 at 12-bit (12-bit IDTX
// exceeds int16).
//
// A CTA of 64 threads holds its job's block in shared memory (row stride
// w + 1) and runs the four phases of itx_core.cuh: load (with the rect2
// pre-scale), the row pass (thread y transforms row y, then rounds and
// clips), the column pass (thread x transforms column x), the store of
// (v + 8) >> 4.  The arithmetic is int32 at 8/10-bit, as the JAX device
// tier's, and int64 at 12-bit (exact; the reference's int32 split forms
// are rewrites of the same values).
//
// Bound on the H100: the coefficient reads and residual writes are a few
// MB a 1080p frame (microseconds), and the butterflies, ~10-30 operations
// per coefficient and pass, are below the operation rate as well; what
// limits this design is latency: one job per CTA leaves most threads idle
// on the small transforms (a 4x4 job uses 4 of 64 threads per pass) and
// each pass is a serial chain in one thread.  Packing small jobs into a
// CTA and splitting the long 1-D transforms across threads is the next
// step.
#include "common.cuh"
#include "itx_core.cuh"

namespace {

template <typename T, typename O>
__global__ void __launch_bounds__(64)
    itx_frame_kernel(const int* __restrict__ cf, const int* __restrict__ jobs,
                     O* __restrict__ out, int bitdepth) {
    __shared__ T tile[itx::TILE_ELEMS];
    const int* J = jobs + (long long)blockIdx.x * itx::JOB_COLS;
    const itx::Geom g = itx::geom(__ldg(J + itx::J_TX), __ldg(J + itx::J_TXTP));
    itx::Clip<T> rcl, ccl;
    itx::clips<T>(bitdepth, rcl, ccl);
    const int tid = threadIdx.x, nt = blockDim.x;

    itx::load<T>(tile, cf + __ldg(J + itx::J_CF), g, tid, nt);
    __syncthreads();
    itx::rows<T>(tile, g, rcl, ccl, tid, nt);
    __syncthreads();
    itx::cols<T>(tile, g, ccl, tid, nt);
    __syncthreads();
    itx::store<T, O>(tile, out + __ldg(J + itx::J_OUT), g, tid, nt);
}

}  // namespace

DTPU_API int dtpu_itx_frame(const int* cf, const int* jobs, int n_jobs,
                            void* out, int bitdepth, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (n_jobs > 0) {
        if (bitdepth == 12)
            itx_frame_kernel<long long, int><<<n_jobs, 64, 0, s>>>(
                cf, jobs, (int*)out, bitdepth);
        else
            itx_frame_kernel<int, short><<<n_jobs, 64, 0, s>>>(
                cf, jobs, (short*)out, bitdepth);
    }
    return (int)cudaGetLastError();
}
