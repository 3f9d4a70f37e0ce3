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
// size, and the kernels compute the window's rows and columns themselves
// (the edge flags' clamps, the snapshot's rows above and below a stripe)
// from the two planes' own pointers (lr_core.cuh).
//
// What bounds them on the H100: the bytes, the units' pixels read once
// (plus their context rows) and written once: 5 us for the 136 luma
// units of a 1080p frame at 3.35 TB/s.
//
// lr_wiener: a CTA per row of the chunk table (ops/lr.py chunk_table),
// one band of output rows (64, 32 or 16, fewer for a small launch) of
// one 64-column chunk of one unit, so every CTA has work.  It resolves
// the window's row sources and column clamps once into shared tables,
// then streams the band in sub-bands of 32 rows (lr::WIENER_SB):
// cp.async copies (16 bytes where a row segment is contiguous
// and aligned) of sub-band g + 1 are in flight while sub-band g runs its
// horizontal pass into a ring of 38 intermediate rows and its vertical
// pass out of it, two barriers a sub-band.  Both passes take 4 columns a
// thread through 16-byte shared loads (the 7-tap sums are what remains:
// 14 multiply-adds a pixel).  Shared memory: 30,024 bytes against 37,520
// for the stage-then-filter tile it replaces.
//
// lr_sgr: a CTA per 32-column chunk of one unit (CTAs past a unit's
// width return at once) stages the whole window (4 reads in flight a
// thread) and runs the filter's phases over shared memory in series;
// 46,544 bytes of static shared memory.
#include "common.cuh"
#include "lr_core.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(lr::WIENER_THREADS)
    lr_wiener_kernel(const int* __restrict__ chunks, lr::Planes p) {
    __shared__ __align__(16) lr::WienerRing s;
    const int tid = threadIdx.x;
    lr::Band b;
    lr::load_band(b, chunks, blockIdx.x, p);
    lr::wiener_setup(s, b, p, tid);
    __syncthreads();
    lr::wiener_issue(s, b, 0, tid);
    LR_CP_COMMIT();
    lr::wiener_issue(s, b, 1, tid);
    LR_CP_COMMIT();
    const int n = lr::sub_bands(b);
    for (int g = 0; g < n; g++) {
        LR_CP_WAIT1();  // sub-band g has landed (g + 1 may be in flight)
        __syncthreads();
        lr::wiener_hpass(s, b, g, p.bd, tid);
        __syncthreads();
        lr::wiener_issue(s, b, g + 2, tid);  // into the buffer g read
        LR_CP_COMMIT();
        lr::wiener_vpass(s, b, g, p, tid);
    }
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

// The n_jobs self-guided units of the job table (int32, lr_core.cuh
// columns) of the (H, W) int32 planes post (post-CDEF) and pre
// (snapshot), written into out; out's other pixels are left as they
// are.  Returns cudaError_t.
DTPU_API int dtpu_lr_sgr(const int* post, const int* pre, int* out, int H,
                         int W, const int* jobs, int n_jobs, int bitdepth,
                         void* stream) {
    if (n_jobs <= 0) return (int)cudaSuccess;
    const lr::Planes p{post, pre, out, H, W, bitdepth};
    const dim3 grid(n_jobs, lr::MAX_UW / lr::SGR_CW);
    lr_sgr_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(jobs, p);
    return (int)cudaGetLastError();
}

// The Wiener units of a plane, one CTA for each of the n_chunks rows of
// the chunk table (int32, lr_core.cuh C_* columns: a band of a chunk of a
// unit with the unit's job row; 16-byte aligned), as dtpu_lr_sgr writes
// them.  Returns cudaError_t.
DTPU_API int dtpu_lr_wiener(const int* post, const int* pre, int* out,
                            int H, int W, const int* chunks, int n_chunks,
                            int bitdepth, void* stream) {
    if (n_chunks <= 0) return (int)cudaSuccess;
    const lr::Planes p{post, pre, out, H, W, bitdepth};
    lr_wiener_kernel<<<n_chunks, lr::WIENER_THREADS, 0,
                       (cudaStream_t)stream>>>(chunks, p);
    return (int)cudaGetLastError();
}

// Registers and static shared bytes of lr_wiener and lr_sgr into out[4].
// Returns cudaError_t.
DTPU_API int dtpu_lr_attrs(int* out) {
    const void* fns[2] = {(const void*)lr_wiener_kernel,
                          (const void*)lr_sgr_kernel};
    for (int i = 0; i < 2; i++) {
        cudaFuncAttributes a;
        const cudaError_t e = cudaFuncGetAttributes(&a, fns[i]);
        if (e != cudaSuccess) return (int)e;
        out[2 * i] = a.numRegs;
        out[2 * i + 1] = (int)a.sharedSizeBytes;
    }
    return (int)cudaSuccess;
}
