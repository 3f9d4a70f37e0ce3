// Super-res horizontal resample (8-tap, 1/64-pel phases) of up to six
// resident planes in one launch, each into a new allocation-sized plane.
//
// Replaces the TPU program dav1d_tpu/ops/resize.py _program, which the
// JAX chain applies to each resident plane (dav1d_tpu/recon/
// device_chain.py _resize_resident) as a static gather of 8 source
// columns per output column, a multiply by the column's filter row and a
// sum, then places the result in a zeroed allocation-sized array.
//
// What bounds it on the H100: the bytes, the source rows read once and
// the output planes written once (39.6 MB for a 1080p 4:2:0 frame and its
// pre-CDEF snapshot coded 960 wide: 11.8 us at 3.35 TB/s); the
// operations are ~20 a pixel.  The kernel it replaces (one launch a
// plane, a thread a column of 8 rows, 64 scalar 4-byte reads a thread,
// the filter in __constant__ memory) took 0.048 ms a frame in six
// launches, four of them on ~2 MB chroma planes where a launch's fixed
// cost dominates; lanes with different phases serialised on the constant
// cache.
//
// Here one launch takes the frame's planes and the snapshot's (rs::Batch,
// a __grid_constant__ parameter read in place at a dynamic plane index:
// no table upload), cut into strips of 128 columns.  The grid is the
// card's resident CTAs (cudaOccupancy*: 4 an SM at <= 64 registers and
// 36 KB of dynamic shared memory), and the strips' rows are dealt to
// them in runs of equal length (to one row), which each CTA walks in
// tiles of up to 32 rows within one strip, deriving each column's source
// offset and taps once a strip.  Its tiles go through two raw buffers:
// the cp.async copies of the next tile's source rows (16 bytes a group
// of 4 columns where no clamp bites) are in flight while a tile is
// filtered, one barrier pair a tile.  The 512-byte filter table is in
// shared memory, so lanes with different phases read it without
// serialising.  A lane takes two pairs of adjacent columns: a pair's
// windows start 0 or 1 word apart, so 9 shared reads feed its 17
// multiply-adds (the second column's 8 taps placed in 9), lanes 2
// columns apart read words 1 to 1.8 apart (at most 2-way bank
// conflicts), and a warp's 8-byte stores make whole 256-byte rows.
// Pixels outside the resampled rectangle are written 0 by the same
// launch, so the outputs need no memset.  The arithmetic and the phases
// are in resize_core.cuh.
//
// What holds it (an H100 at 700 W, chip_smoke.py and
// tools/torch_fg_lr_probe.py): the frame call sits at about half its
// byte bound, a 1080p luma plane alone at about a third.  A CTA stages,
// then derives its taps, then filters, in step with the other CTAs of its
// SM, so the staging's DRAM round trip is paid once a CTA and the taps
// and the filtering, each bound by the SM's instruction issue while its
// 32 warps run the same phase, follow it in series; a CTA's run holds
// one or two tiles of a plane alone, too few for the buffers to overlap
// them.  Deeper rings, shorter tiles, other CTA counts and column
// layouts, and taps derived while the copies fly did not beat this
// design.
#include "common.cuh"
#include "resize_core.cuh"

namespace {

// Dynamic shared memory of a CTA: the raw buffers, then the filter words.
constexpr int SMEM_BYTES =
    (rs::NBUF * rs::TR * rs::SW + rs::FILTER_WORDS) * (int)sizeof(int);

__global__ void __launch_bounds__(rs::THREADS, 4)
    resize_kernel(const __grid_constant__ rs::Batch b) {
    extern __shared__ __align__(16) int smem[];
    int(*raw)[rs::TR * rs::SW] =
        reinterpret_cast<int(*)[rs::TR * rs::SW]>(smem);
    int* filt = smem + rs::NBUF * rs::TR * rs::SW;
    const int tid = threadIdx.x;
    int u, u1;
    rs::run_of(b, blockIdx.x, &u, &u1);
    rs::load_filter(filt, tid);
    rs::Tile T;
    // the copies of the CTA's first NBUF - 1 tiles, a group each; us: the
    // strip row of the next tile to stage
    int us = u;
#pragma unroll
    for (int k = 0; k < rs::NBUF - 1; k++) {
        if (us < u1) {
            rs::tile_of(b, us, u1, T);
            rs::stage(b.p[T.k], T, raw[k], tid);
            us += T.ny;
        }
        RS_CP_COMMIT();
    }
    rs::Taps tp;
    int strip = -1;  // plane and strip of tp
    for (int i = 0; u < u1; i++) {
        // the next tile into the buffer the previous one was filtered in
        if (us < u1) {
            rs::tile_of(b, us, u1, T);
            rs::stage(b.p[T.k], T, raw[(i + rs::NBUF - 1) % rs::NBUF], tid);
            us += T.ny;
        }
        RS_CP_COMMIT();
        RS_CP_WAIT(rs::NBUF - 1);  // the tile at u has landed
        __syncthreads();
        rs::tile_of(b, u, u1, T);
        const rs::Plane& p = b.p[T.k];
        if (T.k * 65536 + T.tx != strip) {
            strip = T.k * 65536 + T.tx;
            rs::taps_of(p, T, filt, tp, tid);
        }
        rs::compute(p, T, tp, raw[i % rs::NBUF], b.maxp, tid);
        __syncthreads();  // before its buffer takes the tile after next
        u += T.ny;
    }
}

// CTAs of the kernel resident on the current device (0 on an error),
// after allowing the kernel its dynamic shared memory.
int resident_ctas(cudaError_t* e) {
    static int resident[64];
    int dev = 0;
    *e = cudaGetDevice(&dev);
    if (*e != cudaSuccess) return 0;
    if (dev >= 64) {
        *e = cudaErrorInvalidDevice;
        return 0;
    }
    if (resident[dev] == 0) {
        int per_sm = 0, sms = 0;
        *e = cudaFuncSetAttribute(resize_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  SMEM_BYTES);
        if (*e == cudaSuccess)
            *e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, resize_kernel, rs::THREADS, SMEM_BYTES);
        if (*e == cudaSuccess)
            *e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                        dev);
        if (*e != cudaSuccess) return 0;
        resident[dev] = per_sm * sms;
    }
    return resident[dev];
}

}  // namespace

// Resample the n (1..6) int32 planes srcs[k] into the int32 planes
// outs[k], plane k's geometry in geo[k * 8 ..] (src_stride, src_w, h,
// out_w, out_rows, out_stride, step, mx0): rows [0, h) x columns
// [0, src_w) of the source to columns [0, out_w) of the (out_rows,
// out_stride) output, every other output pixel 0.  Returns cudaError_t.
DTPU_API int dtpu_resize(const int* const* srcs, int* const* outs,
                         const int* geo, int n, int bitdepth, void* stream) {
    cudaError_t e;
    const int resident = resident_ctas(&e);
    if (e != cudaSuccess) return (int)e;
    rs::Batch b;
    if (!rs::make_batch(b, srcs, outs, geo, n, bitdepth, resident))
        return (int)cudaErrorInvalidValue;
    if (b.total == 0) return (int)cudaSuccess;
    resize_kernel<<<b.ctas, rs::THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
        b);
    return (int)cudaGetLastError();
}

// Registers, shared bytes (dynamic) and resident CTAs per SM of the
// kernel into out[3].  Returns cudaError_t.
DTPU_API int dtpu_resize_attrs(int* out) {
    cudaError_t e;
    resident_ctas(&e);
    if (e != cudaSuccess) return (int)e;
    cudaFuncAttributes a;
    e = cudaFuncGetAttributes(&a, resize_kernel);
    if (e != cudaSuccess) return (int)e;
    out[0] = a.numRegs;
    out[1] = (int)a.sharedSizeBytes + SMEM_BYTES;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], resize_kernel,
                                                      rs::THREADS, SMEM_BYTES);
    return (int)e;
}
