// Film grain of one plane in one launch: every pixel's grain value
// assembled from the plane's grain LUT at its block's random offset with
// the overlap blends, its scaling index, the scaled and clipped add, into
// a new plane (fg_core.cuh).
//
// Replaces the TPU program dav1d_tpu/ops/fg.py _jit_apply / _jit_apply_pw
// (the per-pixel scale, round and clip over a whole plane) and the host
// work before it in dav1d_tpu/recon/filmgrain.py apply_grain:382-460,
// where Python loops assembled every 32-row stripe's grain from the LUT
// block by block, computed the chroma index planes, and uploaded the
// grain, index and pixel planes to the device each frame.  Here only the
// LUT (74 x 82), the scaling LUT and the offsets (one byte pair per 32x32
// block) go up; the pixels are the frame's resident planes.
//
// A CTA takes one block row (32 >> ss_y rows) of 128 columns: it stages
// the scaling LUT (1 << bd entries, int16) in shared memory, then each
// thread walks one column over the rows.  The grain LUT (24 KB) is read
// through the read-only cache.
//
// What bounds it on the H100: the bytes, the plane read and written
// once (plus the luma under a chroma plane): 5 us for a 1080p luma plane
// at 3.35 TB/s.
#include "common.cuh"
#include "fg_core.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int COLS = 128;

__global__ void __launch_bounds__(THREADS)
    fg_kernel(const int* __restrict__ src, long long ss,
              const int* __restrict__ luma, long long ls, int lw,
              int* __restrict__ out, int w, int h,
              const int* __restrict__ lut, const int* __restrict__ scaling,
              const int* __restrict__ offs, int n_blocks, fg::Params p) {
    __shared__ short s_sc[4096];
    const int n_sc = 1 << p.bd;
    for (int i = threadIdx.x; i < n_sc; i += THREADS)
        s_sc[i] = (short)__ldg(scaling + i);
    __syncthreads();
    const int bszy = fg::BLOCK >> p.ss_y;
    const int x = blockIdx.x * COLS + (threadIdx.x % COLS);
    if (x >= w) return;
    const int y0 = blockIdx.y * bszy;
    const int y1 = min(h, y0 + bszy);
    for (int y = y0 + threadIdx.x / COLS; y < y1; y += THREADS / COLS) {
        const int s = __ldg(src + (long long)y * ss + x);
        const int g = fg::grain(lut, offs, n_blocks, x, y, p);
        const int idx = fg::index(s, luma, ls, lw, x, y, p);
        out[(long long)y * w + x] = fg::apply(s, s_sc[idx], g, p);
    }
}

}  // namespace

// Film grain of the top-left w x h pixels of the int32 plane src (row
// stride ss) into out (h x w int32).  luma: the grain-free luma plane
// (row stride ls, cropped width lw) for a chroma plane; lut: the plane's
// 74 x 82 grain LUT; scaling: 1 << bd entries; offs: (rows, n_blocks, 2)
// block offsets; prm: fg::N_PARAMS host ints (ops/fg.py PlaneParams).
// Returns cudaError_t.
DTPU_API int dtpu_fg(const int* src, long long ss, const int* luma,
                     long long ls, int lw, int* out, int w, int h,
                     const int* lut, const int* scaling, const int* offs,
                     int n_blocks, const int* prm, void* stream) {
    if (w <= 0 || h <= 0) return (int)cudaSuccess;
    const fg::Params p{prm[0], prm[1], prm[2], prm[3], prm[4], prm[5],
                       prm[6], prm[7], prm[8], prm[9], prm[10], prm[11]};
    const int bszy = fg::BLOCK >> p.ss_y;
    const dim3 grid(dtpu_blocks(w, COLS), dtpu_blocks(h, bszy));
    fg_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        src, ss, luma, ls, lw, out, w, h, lut, scaling, offs, n_blocks, p);
    return (int)cudaGetLastError();
}
