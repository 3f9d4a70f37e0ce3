// Loop restoration of one resident plane: every Wiener stripe unit in
// one launch (lr_wiener), every self-guided unit in another (lr_sgr),
// each unit gathered from the post-CDEF plane and the pre-CDEF snapshot
// and written into a separate output plane.
//
// Replaces the TPU programs dav1d_tpu/ops/lr.py _jit_wiener and _jit_sgr
// as dav1d_tpu/recon/device_chain.py _jit_lr_group fuses them: one XLA
// program per (filter, unit width, stripe height[, variant]) group that
// gathers the padded units through row and column index arrays built on
// the host from a concatenation of the post-CDEF plane and the snapshot,
// filters them batched, and scatters the rectangles into a new array.
// Here the geometry travels as one job row per unit (ops/lr.py
// job_table), so one launch takes every unit of a plane whatever its
// size: a CTA takes one chunk of columns of one unit (64 for Wiener, 32
// for SGR; CTAs past a unit's width return at once), computes the
// window's rows and columns itself (the edge flags' clamps, the
// snapshot's rows above and below a stripe) from the two planes' own
// pointers, stages the window in shared memory once (4 reads in flight a
// thread), and runs the filter's phases over shared memory
// (lr_core.cuh).
//
// Shared memory: 37,520 bytes a Wiener CTA (window and intermediate),
// 46,544 an SGR CTA (window and the four (A, B) arrays), both static.
//
// What bounds it on the H100: the bytes, the units' pixels read once
// (plus their context rows) and written once: 5 us for the 136 luma
// units of a 1080p frame at 3.35 TB/s.  A CTA walks its phases in
// series (stage, then one pass, then the next), so a launch of a few
// hundred CTAs takes 4x that (0.021 ms on an H100 at 700 W, PERF.md).
#include "common.cuh"
#include "lr_core.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    lr_wiener_kernel(const int* __restrict__ jobs, lr::Planes p) {
    __shared__ lr::WienerTile s;
    lr::Job j;
    if (!lr::load_job(j, jobs + (long long)blockIdx.x * lr::JOB_COLS,
                      blockIdx.y, lr::WIENER_CW))
        return;
    lr::stage(s.win, lr::WIENER_CW + 6, j, p, threadIdx.x, THREADS);
    __syncthreads();
    lr::wiener_h(s, j, p.bd, threadIdx.x, THREADS);
    __syncthreads();
    lr::wiener_v(s, j, p, threadIdx.x, THREADS);
}

__global__ void __launch_bounds__(THREADS)
    lr_sgr_kernel(const int* __restrict__ jobs, lr::Planes p) {
    __shared__ lr::SgrTile s;
    lr::Job j;
    if (!lr::load_job(j, jobs + (long long)blockIdx.x * lr::JOB_COLS,
                      blockIdx.y, lr::SGR_CW))
        return;
    lr::stage(s.win, lr::SGR_WS, j, p, threadIdx.x, THREADS);
    __syncthreads();
    lr::sgr_ab(s, j, p.bd, threadIdx.x, THREADS);
    __syncthreads();
    lr::sgr_filter(s, j, p, threadIdx.x, THREADS);
}

}  // namespace

// The n_jobs units of the job table (int32, lr_core.cuh columns) of the
// (H, W) int32 planes post (post-CDEF) and pre (snapshot), written into
// out; out's other pixels are left as they are.  sgr: 0 Wiener, 1
// self-guided.  Returns cudaError_t.
DTPU_API int dtpu_lr(const int* post, const int* pre, int* out, int H,
                     int W, const int* jobs, int n_jobs, int sgr,
                     int bitdepth, void* stream) {
    if (n_jobs <= 0) return (int)cudaSuccess;
    const lr::Planes p{post, pre, out, H, W, bitdepth};
    cudaStream_t st = (cudaStream_t)stream;
    if (sgr) {
        const dim3 grid(n_jobs, lr::MAX_UW / lr::SGR_CW);
        lr_sgr_kernel<<<grid, THREADS, 0, st>>>(jobs, p);
    } else {
        const dim3 grid(n_jobs, lr::MAX_UW / lr::WIENER_CW);
        lr_wiener_kernel<<<grid, THREADS, 0, st>>>(jobs, p);
    }
    return (int)cudaGetLastError();
}

