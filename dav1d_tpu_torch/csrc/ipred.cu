// Intra reconstruction of one wavefront level of a plane in one launch
// per kind, in place on the plane's resident int32 canvas: prediction
// units (ipred), chroma-from-luma units (ipred_cfl) and palette units
// (ipred_pal); per unit the edge gather from the canvas, the prediction,
// the residual added and the clip (ipred_core.cuh).
//
// Replaces the TPU programs of dav1d_tpu/recon/device_intra.py:
// _unit_program (:230) and _multi_run_program (:260), which gathered the
// edges of every unit of a (w, h) key, evaluated all fourteen modes on
// them (ops/ipred.py _build / _build_rt, through _allmode_pred :198) and
// selected one per unit, and scattered the windows back, padding each
// key's batch to a power of two and fusing up to 64 levels into one
// program for XLA's launch cost; _cfl_program (:320, ops/ipred.py:644)
// and _pal_program (:406, ops/ipred.py:685).  Here one CTA takes one
// unit of any size and mode (its job row carries them), so a level is one
// launch per kind whatever its sizes, and only the unit's own mode runs.
//
// In place is legal: no unit reads a cell that a unit of its own level
// writes (recon/device_intra._LevelMap), and the levels are launched in
// order on one stream.
//
// What bounds it on the H100: neither bytes nor operations.  A level
// holds a few dozen units (a few hundred for palette), a few KB of
// pixels, so a launch costs what the launch and one CTA's serial phases
// cost, and a frame's chain costs its level count times that (PERF.md).
// The design keeps each launch to one CTA a unit and one barrier a phase;
// fewer, larger launches need the levels walked inside one kernel.
//
// Shared memory: 6,496 bytes a CTA (the job, the edge vector, the
// processed edge, the filter-intra canvas or the CFL AC), static.
#include "common.cuh"
#include "ipred_core.cuh"

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
    ipred_kernel(const int* __restrict__ jobs, ip::Plane p) {
    __shared__ ip::Shared s;
    const int tid = threadIdx.x;
    ip::load(s, jobs + (long long)blockIdx.x * ip::JOB_COLS, tid, THREADS);
    __syncthreads();
    ip::gather(s, p, true, tid, THREADS);
    __syncthreads();
    ip::prep(s, p.bd, tid, THREADS);
    __syncthreads();
    const int steps = ip::filter_steps(s.u);
    for (int st = 0; st < steps; st++) {
        ip::filter_step(s, p.bd, st, tid, THREADS);
        __syncthreads();
    }
    ip::output(s, p, tid, THREADS);
}

__global__ void __launch_bounds__(THREADS)
    ipred_cfl_kernel(const int* __restrict__ jobs, ip::Plane p,
                     const int* __restrict__ luma, int YH, int YW, int ss_hor,
                     int ss_ver) {
    __shared__ ip::Shared s;
    const int tid = threadIdx.x;
    ip::load(s, jobs + (long long)blockIdx.x * ip::JOB_COLS, tid, THREADS);
    __syncthreads();
    ip::gather(s, p, false, tid, THREADS);
    __syncthreads();
    ip::cfl_ac(s, p, luma, YH, YW, ss_hor, ss_ver, tid, THREADS);
    __syncthreads();
    ip::cfl_output(s, p, tid, THREADS);
}

__global__ void __launch_bounds__(THREADS)
    ipred_pal_kernel(const int* __restrict__ jobs, ip::Plane p,
                     const unsigned char* __restrict__ pidx) {
    ip::pal_output(jobs + (long long)blockIdx.x * ip::JOB_COLS, p, pidx,
                   threadIdx.x, THREADS);
}

}  // namespace

// The n_jobs prediction units (int32 job rows, ipred_core.cuh) of one
// level of the (H, W) int32 canvas, ph rows a plane, in place; resid: the
// residual canvas of the same shape.  Returns cudaError_t.
DTPU_API int dtpu_ipred(int* canvas, const int* resid, int H, int W, int ph,
                        const int* jobs, int n_jobs, int bitdepth,
                        void* stream) {
    if (n_jobs <= 0) return (int)cudaSuccess;
    const ip::Plane p{canvas, resid, H, W, ph, bitdepth};
    ipred_kernel<<<n_jobs, THREADS, 0, (cudaStream_t)stream>>>(jobs, p);
    return (int)cudaGetLastError();
}

// The CFL units of one level; luma: the finished (YH, YW) int32 luma
// canvas.
DTPU_API int dtpu_ipred_cfl(int* canvas, const int* luma, const int* resid,
                            int H, int W, int ph, int YH, int YW,
                            const int* jobs, int n_jobs, int ss_hor,
                            int ss_ver, int bitdepth, void* stream) {
    if (n_jobs <= 0) return (int)cudaSuccess;
    const ip::Plane p{canvas, resid, H, W, ph, bitdepth};
    ipred_cfl_kernel<<<n_jobs, THREADS, 0, (cudaStream_t)stream>>>(
        jobs, p, luma, YH, YW, ss_hor, ss_ver);
    return (int)cudaGetLastError();
}

// The palette units of one level; pidx: the frame's uint8 index maps.
DTPU_API int dtpu_ipred_pal(int* canvas, const int* resid, int H, int W,
                            const int* jobs, int n_jobs,
                            const unsigned char* pidx, int bitdepth,
                            void* stream) {
    if (n_jobs <= 0) return (int)cudaSuccess;
    const ip::Plane p{canvas, resid, H, W, H, bitdepth};
    ipred_pal_kernel<<<n_jobs, THREADS, 0, (cudaStream_t)stream>>>(jobs, p,
                                                                    pidx);
    return (int)cudaGetLastError();
}
