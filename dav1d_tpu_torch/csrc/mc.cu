// Batched translational motion compensation (put_8tap) of one frame,
// straight from the resident reference planes.
//
// Replaces the TPU kernel dav1d_tpu/ops/pallas_mc.py _gather_put_prog
// (body _kernel), which DMAs each block's (h+7)x(w+7) window from a
// stack of reference planes padded with a replicated MC_PAD border
// (dav1d_tpu/pipeline.py _stack_prog), slides it into place with lane
// rolls and filters BB blocks per grid step; together with the XLA
// clamped-gather program for windows beyond the border
// (ops/mc._put_8tap_resident_prog) and the host-gathered windows
// (ops/mc._put_8tap_prog).  Those tiers exist for the TPU's aligned-DMA
// contract.  Here one launch covers every job of the frame, whatever
// its plane, reference or block size, and every read is clamped to the
// reference's coded size in the kernel (emu_edge, src/mc_tmpl.c).
//
// Jobs: int32 rows of JOB_COLS (ops/mc.py job_table): table entry,
// block origin dy/dx (signed), w, h, the job's first pixel in the flat
// numbering of all jobs' pixels (a prefix sum in job order), output
// offset and row stride of its block, 8 horizontal and 8 vertical taps.
// Table: int64 (base pointer, row stride, vh, vw) per reference plane.
// The output buffer holds the current frame's planes (narrow), so each
// block lands in place.
//
// One thread computes one predicted pixel: it finds its job by binary
// search over the prefix sums, then forms the 8 horizontal
// intermediates of its column (rounded by 6-ib) and their vertical sum
// (rounded by 6+ib), all in int32, and clips to the bit depth.
//
// Bound on the H100: the reads.  Each pixel reads 64 reference pixels
// (8 rows x 8 taps); neighbouring threads of a block row read
// neighbouring addresses, so the 8x reuse across the threads of a job
// is served by L1.  The minimal work is (h+7)*w horizontal and h*w
// vertical 8-tap sums per block; this kernel recomputes the horizontal
// pass for each output row (8x the minimal multiply-adds), which keeps
// it free of shared memory and synchronisation.
#include "common.cuh"

namespace {

constexpr int JOB_COLS = 24;
constexpr int J_ENTRY = 0, J_DY = 1, J_DX = 2, J_W = 3, J_PIX = 5,
              J_OUT = 6, J_OSTRIDE = 7, J_FH = 8, J_FV = 16;

template <typename T>
__global__ void mc_put_8tap_kernel(const long long* __restrict__ table,
                                   const int* __restrict__ jobs,
                                   int n_jobs, int n_pix,
                                   T* __restrict__ out, int ib, int maxp) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= n_pix) return;
    // the last job whose first pixel is <= p
    int lo = 0, hi = n_jobs - 1;
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (__ldg(jobs + (long long)mid * JOB_COLS + J_PIX) <= p)
            lo = mid;
        else
            hi = mid - 1;
    }
    const int* J = jobs + (long long)lo * JOB_COLS;
    const long long* tb = table + 4 * __ldg(J + J_ENTRY);
    const int* base = reinterpret_cast<const int*>(__ldg(tb));
    const long long stride = __ldg(tb + 1);
    const int vh = (int)__ldg(tb + 2), vw = (int)__ldg(tb + 3);
    const int w = __ldg(J + J_W);
    const int q = p - __ldg(J + J_PIX);
    const int y = q / w, x = q - y * w;
    const int y0 = __ldg(J + J_DY) + y - 3, x0 = __ldg(J + J_DX) + x - 3;

    int fh[8], xs[8];
#pragma unroll
    for (int t = 0; t < 8; t++) {
        fh[t] = __ldg(J + J_FH + t);
        xs[t] = dtpu_clip(x0 + t, 0, vw - 1);
    }
    const int sh = 6 - ib, sv = 6 + ib;
    const int rh = (1 << sh) >> 1, rv = 1 << (sv - 1);
    int acc = 0;
#pragma unroll
    for (int r = 0; r < 8; r++) {
        const int* row = base + (long long)dtpu_clip(y0 + r, 0, vh - 1) *
                                    stride;
        int m = 0;
#pragma unroll
        for (int t = 0; t < 8; t++) m += fh[t] * __ldg(row + xs[t]);
        acc += __ldg(J + J_FV + r) * ((m + rh) >> sh);
    }
    out[__ldg(J + J_OUT) + (long long)y * __ldg(J + J_OSTRIDE) + x] =
        (T)dtpu_clip((acc + rv) >> sv, 0, maxp);
}

}  // namespace

DTPU_API int dtpu_mc_put_8tap(const long long* table, const int* jobs,
                              int n_jobs, int n_pix, void* out,
                              int bitdepth, void* stream) {
    const int threads = 256;
    const int ib = bitdepth == 8 ? 4 : 14 - bitdepth;
    const int maxp = (1 << bitdepth) - 1;
    cudaStream_t s = (cudaStream_t)stream;
    if (bitdepth == 8)
        mc_put_8tap_kernel<unsigned char>
            <<<dtpu_blocks(n_pix, threads), threads, 0, s>>>(
                table, jobs, n_jobs, n_pix, (unsigned char*)out, ib, maxp);
    else
        mc_put_8tap_kernel<short>
            <<<dtpu_blocks(n_pix, threads), threads, 0, s>>>(
                table, jobs, n_jobs, n_pix, (short*)out, ib, maxp);
    return (int)cudaGetLastError();
}
