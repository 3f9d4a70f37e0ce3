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
// What bounds it on the H100: the bytes, the plane read and written
// once (plus the luma under a chroma plane): 5 us for a 1080p luma plane
// at 3.35 TB/s.  Little's law at that rate and ~0.75 us of DRAM latency
// asks for ~2.5 MB in flight.  So a CTA of 256 threads covers 128
// columns by 8 x ROWS rows, each thread one 4-pixel group (a 16-byte load
// where the row allows it) on ROWS rows, and issues every row's loads
// and its block's offset byte before the CTA stages the scaling LUT
// (int16, up to 8 KB) behind its one barrier.  A luma thread takes
// fg::ROWS_LUMA = 4 rows (64 B in flight, the whole 1080p plane's 8.3 MB
// at once); a chroma thread, whose rows also bring the luma under them,
// fg::ROWS_CHROMA = 1 (48 B: at 4 rows a 1080p chroma plane made one CTA
// an SM, 30% slower at 8-bit).  The grain LUT (24 KB) is read through
// the read-only cache, every row's four words before the first is used.
#include "common.cuh"
#include "fg_core.cuh"

namespace {

// rows a thread takes
template <bool CHROMA>
constexpr int ROWS = CHROMA ? fg::ROWS_CHROMA : fg::ROWS_LUMA;

template <bool CHROMA>
__global__ void __launch_bounds__(fg::THREADS)
    fg_kernel(fg::Planes pl, const int* __restrict__ lut,
              const int* __restrict__ scaling, const int* __restrict__ offs,
              int n_blocks, fg::Params p) {
    __shared__ short s_sc[4096];
    const int x0 = fg::group_x(blockIdx.x, threadIdx.x);
    const int y0 = fg::group_y<ROWS<CHROMA>>(blockIdx.y, threadIdx.x);
    fg::Regs<CHROMA, ROWS<CHROMA>> r;
    fg::load(r, pl, offs, n_blocks, x0, y0, p);
    fg::stage_scaling(s_sc, scaling, p.bd, threadIdx.x, fg::THREADS);
    __syncthreads();
    fg::finish(r, s_sc, pl, lut, offs, n_blocks, x0, y0, p);
}

template <bool CHROMA>
cudaError_t launch(const fg::Planes& pl, const int* lut, const int* scaling,
                   const int* offs, int n_blocks, const fg::Params& p,
                   cudaStream_t st) {
    const dim3 grid(dtpu_blocks(pl.w, fg::GX * 4),
                    dtpu_blocks(pl.h, fg::GY * ROWS<CHROMA>));
    fg_kernel<CHROMA><<<grid, fg::THREADS, 0, st>>>(
        pl, lut, scaling, offs, n_blocks, p);
    return cudaGetLastError();
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
    const fg::Planes pl{src, ss, luma, ls, lw, out, w, h};
    cudaStream_t st = (cudaStream_t)stream;
    return p.pl ? (int)launch<true>(pl, lut, scaling, offs, n_blocks, p, st)
                : (int)launch<false>(pl, lut, scaling, offs, n_blocks, p, st);
}

// Registers and static shared bytes of the luma and the chroma fg kernel
// into out[4].  Returns cudaError_t.
DTPU_API int dtpu_fg_attrs(int* out) {
    const void* fns[2] = {(const void*)fg_kernel<false>,
                          (const void*)fg_kernel<true>};
    for (int i = 0; i < 2; i++) {
        cudaFuncAttributes a;
        const cudaError_t e = cudaFuncGetAttributes(&a, fns[i]);
        if (e != cudaSuccess) return (int)e;
        out[2 * i] = a.numRegs;
        out[2 * i + 1] = (int)a.sharedSizeBytes;
    }
    return (int)cudaSuccess;
}
