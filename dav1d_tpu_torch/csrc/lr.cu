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
// lr_sgr: a CTA per row of its own chunk table (ops/lr.py
// chunk_table(sgr=True)), one band of 16 rows (lr::SGR_SB; fewer at a
// stripe's end) of one 32-column chunk of one unit, starting on an even
// unit row (the parity of the 5x5 rows is the unit's).  Its TPU program, dav1d_tpu/ops/lr.py _jit_sgr with the box
// sums of :115 inside _jit_lr_group, is a handful of batched XLA
// passes; its first port here was a CTA per 32-column chunk on a grid of
// (units, 12) whose CTAs past a unit's width returned at once (the
// 16-unit call of the 1080p restoration stream: 128 of 192 CTAs live),
// each staging the unit's whole window and running box sums of 9 and 25
// shared reads a point in series.  Its bound is tiny (0.3 us of bytes for
// that call), so what holds it is latency: a launch plus one CTA's chain
// of dependent phases.  Here every band is 16 rows, one band a CTA (that
// call: 256 CTAs, every one with work): cp.async copies of the band's
// window rows, the column sums of px and px^2, the (A, B) rows from
// horizontal sums of those (6 or 10 shared reads a point), the filter 4
// columns a thread; x_by_x in shared memory, not divergent __constant__
// reads; 20,880 bytes of static shared memory, <= 64 registers (4 CTAs
// an SM).  What holds it (an H100 at 700 W, chip_smoke.py): the launch
// itself, about a third of the call's time (an empty kernel's launch is
// timed beside it), then one CTA's chain: the chunk row, the window's
// copies, the three phases.  On that call 16-row bands were faster than
// 8-row bands (512 CTAs) and 32-row ones; 512 threads a CTA or one (A, B)
// a work item did not shorten the chain.
#include "common.cuh"
#include "lr_core.cuh"

namespace {

__global__ void __launch_bounds__(lr::WIENER_THREADS)
    lr_wiener_kernel(const int* __restrict__ chunks, lr::Planes p) {
    __shared__ __align__(16) lr::WienerRing s;
    const int tid = threadIdx.x;
    lr::Band b;
    lr::load_band(b, chunks, blockIdx.x, p, lr::WIENER_CW, false);
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

__global__ void __launch_bounds__(lr::SGR_THREADS, 4)
    lr_sgr_kernel(const int* __restrict__ chunks, lr::Planes p) {
    __shared__ __align__(16) lr::SgrTile s;
    const int tid = threadIdx.x;
    lr::Band b;
    lr::load_band(b, chunks, blockIdx.x, p, lr::SGR_CW, true);
    lr::sgr_setup(s, tid);
    lr::sgr_issue(s, b, p, tid);
    LR_CP_COMMIT();
    LR_CP_WAIT0();
    __syncthreads();
    lr::sgr_vsum(s, b, tid);
    __syncthreads();
    lr::sgr_ab(s, b, p.bd, tid);
    __syncthreads();
    lr::sgr_filter(s, b, p, tid);
}

}  // namespace

// The self-guided units of a plane, one CTA for each of the n_chunks rows
// of its chunk table (int32, lr_core.cuh C_* columns: a band of at most
// 16 rows of a chunk of a unit, starting on an even unit row, with the
// unit's job row; 16-byte aligned), of the (H, W)
// int32 planes post (post-CDEF) and pre (snapshot), written into out;
// out's other pixels are left as they are.  Returns cudaError_t.
DTPU_API int dtpu_lr_sgr(const int* post, const int* pre, int* out, int H,
                         int W, const int* chunks, int n_chunks,
                         int bitdepth, void* stream) {
    if (n_chunks <= 0) return (int)cudaSuccess;
    const lr::Planes p{post, pre, out, H, W, bitdepth};
    lr_sgr_kernel<<<n_chunks, lr::SGR_THREADS, 0, (cudaStream_t)stream>>>(
        chunks, p);
    return (int)cudaGetLastError();
}

// The Wiener units of a plane, one CTA for each of the n_chunks rows of
// the chunk table (int32, lr_core.cuh C_* columns: a band of a chunk of a
// unit with the unit's job row; 16-byte aligned), as dtpu_lr_sgr writes
// its units.  Returns cudaError_t.
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
