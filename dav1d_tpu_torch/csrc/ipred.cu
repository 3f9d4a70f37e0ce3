// Intra reconstruction in place on a plane's resident int32 canvas:
// every unit of a chain's wavefront levels in one launch (ipred_walk),
// and one level of one kind in one launch (prediction units ipred,
// chroma-from-luma units ipred_cfl, palette units ipred_pal); per unit
// the edge gather from the canvas, the prediction, the residual added
// and the clip (ipred_core.cuh).
//
// Replaces the TPU programs of dav1d_tpu/recon/device_intra.py:
// _unit_program (:230) and _multi_run_program (:260), which gathered the
// edges of every unit of a (w, h) key, evaluated all fourteen modes on
// them (ops/ipred.py _build / _build_rt, through _allmode_pred :198) and
// selected one per unit, and scattered the windows back, padding each
// key's batch to a power of two and fusing up to 64 levels into one
// program for XLA's launch cost; _cfl_program (:320, ops/ipred.py:644)
// and _pal_program (:406, ops/ipred.py:685).  Here one CTA takes one
// unit of any size, mode and kind (its job row and tag carry them), so a
// chain is one walk launch (a level one launch per kind in the per-level
// kernels) whatever its sizes, and only the unit's own mode runs.
//
// In place is legal: no unit reads a cell that a unit of its own level
// writes (recon/device_intra._LevelMap), and a level starts after the
// one below it has finished (the walk) or was launched after it on the
// same stream (the per-level kernels).
//
// What bounds it on the H100: neither bytes nor operations but latency.
// A level holds a few dozen units (a few hundred for palette), a few KB
// of pixels, and the levels of a chain depend on each other, so a
// chain costs its level count times one level's latency: with a launch
// per level and kind that was the launch (PERF.md, PR 7).  The walk
// replaces the launches with a handoff through L2: a persistent grid of
// CTAs takes units in tag order from a ticket counter; thread 0 spins
// (acquire, __nanosleep backoff, __trap after 2^26 polls) until the
// level below is done, and after the unit's last phase adds one to its
// own level's counter (release).  Tickets go out in level order, so a
// CTA only ever waits on units held by CTAs that are already running:
// no deadlock, no cooperative launch.  The grid is the resident CTAs,
// capped at the units and at the caller's max_ctas (the most units two
// consecutive levels hold: more CTAs would only spin).  The reference
// fused up to 64 levels into one XLA program (_multi_run_program) for
// XLA's launch cost; the walk takes every level of the chain.
//
// What remains is a level's critical path: the handoff (~1.3 us with the
// smallest unit) and the slowest unit's serial phases, one barrier each.
// So the walk's CTAs are 256 wide (a 32x32 unit's output in 4 steps, not
// 8), and each unit stages its read-only inputs (residual window, index
// map) in shared memory while it waits: the acquire that ends the wait
// invalidates the SM's L1, and a residual read from L2 after it cost one
// L2 round trip per output step (PERF.md, PR 8).
//
// Shared memory: ~6.6 KB a CTA (the job, the edge vector, the processed
// edge, the filter-intra canvas or the CFL AC, the filter taps), static;
// the walk adds its 20 KB stage and its ticket.
#include "common.cuh"
#include "ipred_core.cuh"

namespace {

constexpr int THREADS = 128;
// the walk's CTAs: a unit's phases loop over its pixels or edge entries
// in steps of this many threads
constexpr int WALK_THREADS = 256;

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
    const int* job = jobs + (long long)blockIdx.x * ip::JOB_COLS;
    ip::pal_output(job, p, pidx + (unsigned)__ldg(job + 4), nullptr,
                   threadIdx.x, THREADS);
}

__device__ __forceinline__ void wait_level(const ip::Walk& w, int level) {
    unsigned polls = 0, ns = 16;
    while (!ip::level_ready(w, level)) {
        if (++polls >= (1u << 26)) __trap();  // a broken table: fail loudly
        __nanosleep(ns);
        if (ns < 64) ns <<= 1;
    }
}

__global__ void __launch_bounds__(WALK_THREADS)
    ipred_walk_kernel(ip::Plane p, ip::Walk w, int* next) {
    __shared__ ip::Shared s;
    __shared__ ip::Stage st;
    __shared__ int ticket;
    const int tid = threadIdx.x;
    for (;;) {
        if (tid == 0) ticket = atomicAdd(next, 1);
        __syncthreads();
        const int t = ticket;
        if (t >= w.n) return;
        const int tag = __ldg(w.tags + t);
        const int level = ip::tag_level(tag), kind = ip::tag_kind(tag);
        // the job row, the residuals and the index maps are read-only:
        // load them while the level below runs
        const int* job = w.jobs + (long long)t * ip::JOB_COLS;
        ip::load(s, job, tid, WALK_THREADS);
        ip::stage_unit(s, st, p, w, job, kind, tid, WALK_THREADS);
        if (tid == 0) wait_level(w, level);
        __syncthreads();
        const int phases = ip::unit_phases(s, kind);
        for (int k = 0; k < phases; k++) {
            ip::unit_phase(s, p, w, kind, k, tid, WALK_THREADS);
            __syncthreads();
        }
        if (tid == 0) ip::level_finish(w, level);
    }
}

}  // namespace

// Every unit of one chain, in place on the (H, W) int32 canvas (ph rows
// a plane): jobs / tags (n_jobs rows, sorted by tag = level << 2 | kind),
// counts (n_levels units a level); sync: n_levels + 1 int32 of scratch
// (the ticket counter, then the done counters), zeroed here on the
// stream before the launch; luma: the finished (YH, YW) luma canvas (CFL
// units); pidx: the index maps (palette units); at most max_ctas CTAs
// (<= 0: no cap).  Returns cudaError_t.
DTPU_API int dtpu_ipred_walk(int* canvas, const int* luma, const int* resid,
                             int H, int W, int ph, int YH, int YW,
                             const int* jobs, const int* tags,
                             const int* counts, int* sync, int n_jobs,
                             int n_levels, int max_ctas,
                             const unsigned char* pidx, int ss_hor,
                             int ss_ver, int bitdepth, void* stream) {
    if (n_jobs <= 0) return (int)cudaSuccess;
    static int resident[64];  // resident CTAs of the device, once
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= 64) return (int)cudaErrorInvalidDevice;
    if (resident[dev] == 0) {
        int per_sm = 0, sms = 0;
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, ipred_walk_kernel, WALK_THREADS, 0);
        if (e == cudaSuccess)
            e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       dev);
        if (e != cudaSuccess) return (int)e;
        resident[dev] = per_sm * sms;
    }
    int grid = resident[dev] < n_jobs ? resident[dev] : n_jobs;
    if (max_ctas > 0 && max_ctas < grid) grid = max_ctas;
    const cudaStream_t st = (cudaStream_t)stream;
    e = cudaMemsetAsync(sync, 0, sizeof(int) * (size_t)(n_levels + 1), st);
    if (e != cudaSuccess) return (int)e;
    const ip::Plane p{canvas, resid, H, W, ph, bitdepth};
    const ip::Walk w{jobs, tags, counts, sync + 1, n_jobs, luma, YH, YW,
                     ss_hor, ss_ver, pidx};
    ipred_walk_kernel<<<grid, WALK_THREADS, 0, st>>>(p, w, sync);
    return (int)cudaGetLastError();
}

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
