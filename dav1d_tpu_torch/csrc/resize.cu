// Super-res horizontal resample of one resident plane (8-tap, 1/64-pel
// phases), into a new allocation-sized plane.
//
// Replaces the TPU program dav1d_tpu/ops/resize.py _program, which the
// JAX chain applies to each resident plane (dav1d_tpu/recon/
// device_chain.py _resize_resident) as a static gather of 8 source
// columns per output column, a multiply by the column's filter row and a
// sum, then places the result in a zeroed allocation-sized array.  Here
// one thread computes one output column over 8 rows: its source columns
// and filter row once, from the closed form of the stepping, then eight
// clamped reads of each source row (neighbouring threads read
// neighbouring columns, so the reads coalesce and the overlap between
// threads hits L1; a thread issues all its rows' reads before its first
// store, so they are in flight together), the filter in __constant__
// memory.  Pixels outside the resampled rectangle are written 0 by the
// same launch, so the output needs no memset.  The arithmetic is in
// resize_core.cuh.
//
// On an H100 at 700 W (PERF.md) a thread a pixel took 0.0152 ms on a
// 1080p luma plane, four times the byte bound (9 waves of threads, each
// waiting on one round of loads); 8 rows a thread with each row's reads
// after the previous row's store took 0.0128 ms, this form 0.0123.
//
// What bounds it on the H100: the bytes, the source rows read once and
// the output plane written once (12.5 MB for a 1080p luma plane coded
// 960 wide, 3.7 us at 3.35 TB/s); the operations are ~20 a pixel.
#include "common.cuh"
#include "resize_core.cuh"

namespace {

__global__ void __launch_bounds__(256)
    resize_kernel(rs::Params p, int out_rows, int* __restrict__ out) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int y0 = blockIdx.y * rs::ROWS;
    if (x >= p.out_stride) return;
    const int n = out_rows - y0 < rs::ROWS ? out_rows - y0 : rs::ROWS;
    rs::column(p, x, y0, n, out + (long long)y0 * p.out_stride + x);
}

}  // namespace

// Resample rows [0, h) x columns [0, src_w) of the int32 plane src (row
// stride src_stride) to columns [0, out_w) of the (out_rows, out_stride)
// int32 plane out; every other output pixel is 0.  Returns cudaError_t.
DTPU_API int dtpu_resize(const int* src, int src_stride, int src_w, int h,
                         int* out, int out_rows, int out_stride, int out_w,
                         int step, int mx0, int bitdepth, void* stream) {
    if (out_rows <= 0 || out_stride <= 0) return (int)cudaSuccess;
    const rs::Params p{src, src_stride, src_w, h, out_w, out_stride,
                       step, mx0, (1 << bitdepth) - 1};
    const int threads = 256;
    const dim3 grid(dtpu_blocks(out_stride, threads),
                    dtpu_blocks(out_rows, rs::ROWS));
    resize_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(p, out_rows,
                                                             out);
    return (int)cudaGetLastError();
}
