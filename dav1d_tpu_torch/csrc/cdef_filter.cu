// CDEF filter of one plane, with the unit parameters derived in-kernel.
//
// Replaces the TPU kernel dav1d_tpu/ops/pallas_cdef.py _build (band
// kernel, tail _filter_tail) with the resident derivation of
// _jit_plane_resident.  The TPU version replicates the unit maps to
// per-pixel planes and selects each tap's offset with one-hot masks
// over 8 statically shifted views; here one thread owns one output
// pixel, looks up its unit in the (nbands, ncols) strength grids and
// the (H/8, W/8) direction/variance maps, and reads its 12 taps
// directly.  Output goes to a separate plane: CDEF reads unfiltered
// neighbours.
//
// Semantics (pallas_cdef, reference src/cdef_tmpl.c:106):
// * luma: pri = (pm * (4 + min(ilog2(var >> 6), 12)) + 8) >> 4 where
//   pm > 0 and var != 0, else 0; dir = pm > 0 ? dmap : 0;
//   chroma: pri = pm; dir = pm > 0 ? uv_dirs[dmap] : 0;
// * pixels whose unit has pri == sec == 0, and pixels outside the
//   (ph, pw) filtered region, pass through;
// * taps outside (ph, pw) read the sentinel -28672: the min ignores it,
//   the max does not;
// * primary weights 4/3 (k=0) and 2/3 (k=1) by strength parity,
//   secondary weights 2 and 1; out = px + ((sum - (sum < 0) + 8) >> 4),
//   clipped to [min, max] only when pri and sec are both nonzero.
// Tap offsets (dir_dy, dir_dx: (2, 12)) and the chroma direction table
// (uv_dirs: (8,)) are device tables from dav1d_tpu_torch/state.py.
//
// Bound on the H100: memory.  Per pixel: one read, one write, 12 taps
// that neighbouring threads share through L1/L2, 4 small map reads.
// Design: 32x8 thread blocks so a warp reads 32 consecutive pixels of
// a row.
#include "common.cuh"

namespace {

constexpr int SENT = -28672;

__device__ __forceinline__ int constrain(int diff, int thr, int shift) {
    const int adiff = dtpu_abs(diff);
    const int v = min(adiff, max(0, thr - (adiff >> shift)));
    return diff < 0 ? -v : v;
}

__global__ void cdef_filter_kernel(
    const int* __restrict__ src, int* __restrict__ dst, int H, int W,
    int ph, int pw, const int* __restrict__ pm, const int* __restrict__ sm,
    int ncols, const int* __restrict__ dmap, const int* __restrict__ vmap,
    int R8, int W8, int uw, int uh, int damping, int bd_m8, int luma,
    const int* __restrict__ dir_dy, const int* __restrict__ dir_dx,
    const int* __restrict__ uv_dirs) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= W || y >= H) return;
    const long long o = (long long)y * W + x;
    const int px = src[o];
    if (y >= ph || x >= pw) {
        dst[o] = px;
        return;
    }
    const int ub = y / uh, uc = x / uw;
    const int p = pm[ub * ncols + uc];
    const int sec = sm[ub * ncols + uc];
    const bool in_map = ub < R8 && uc < W8;
    const int d = in_map ? dmap[ub * W8 + uc] : 0;
    int pri, dir;
    if (luma) {
        const int v = in_map ? vmap[ub * W8 + uc] : 0;
        const int v6 = v >> 6;
        const int lg = min(v6 > 0 ? dtpu_ulog2(v6) : 0, 12);
        pri = (p > 0 && v != 0) ? (p * (4 + lg) + 8) >> 4 : 0;
        dir = p > 0 ? d : 0;
    } else {
        pri = p;
        dir = p > 0 ? uv_dirs[d] : 0;
    }
    if (pri <= 0 && sec <= 0) {
        dst[o] = px;
        return;
    }

    auto tap = [&](int dy, int dx) -> int {
        const int yy = y + dy, xx = x + dx;
        return (yy >= 0 && yy < ph && xx >= 0 && xx < pw)
                   ? src[(long long)yy * W + xx] : SENT;
    };
    const int pri_shift = max(0, damping - dtpu_ulog2(max(pri, 1)));
    const int sec_shift = damping - dtpu_ulog2(max(sec, 1));
    const bool par = (pri >> bd_m8) & 1;

    int sum = 0, mn = px, mx = px;
    auto minmax = [&](int v) {
        mn = min(mn, v == SENT ? 0x7FFF0000 : v);
        mx = max(mx, v);
    };
#pragma unroll
    for (int k = 0; k < 2; k++) {
        const int dy = dir_dy[k * 12 + 2 + dir];
        const int dx = dir_dx[k * 12 + 2 + dir];
        const int t0 = tap(dy, dx), t1 = tap(-dy, -dx);
        if (pri > 0) {
            const int w = par ? 3 : (k == 0 ? 4 : 2);
            sum += w * (constrain(t0 - px, pri, pri_shift) +
                        constrain(t1 - px, pri, pri_shift));
        }
        minmax(t0);
        minmax(t1);
#pragma unroll
        for (int s = 0; s < 2; s++) {
            const int off = s == 0 ? 4 : 0;
            const int sy = dir_dy[k * 12 + off + dir];
            const int sx = dir_dx[k * 12 + off + dir];
#pragma unroll
            for (int sgn = 1; sgn >= -1; sgn -= 2) {
                const int t = tap(sgn * sy, sgn * sx);
                if (sec > 0)
                    sum += (2 - k) * constrain(t - px, sec, sec_shift);
                minmax(t);
            }
        }
    }
    int out = px + ((sum - (sum < 0) + 8) >> 4);
    if (pri > 0 && sec > 0) out = dtpu_clip(out, mn, mx);
    dst[o] = out;
}

}  // namespace

// CDEF over an (H, W) int32 plane into dst.  pm/sm: (nbands, ncols) unit
// strength grids, nbands = ceil(ph / uh), ncols = ceil(pw / uw); dmap /
// vmap: (R8, W8) direction / variance maps of the luma plane.  Returns
// cudaError_t.
DTPU_API int dtpu_cdef_filter(const int* src, int* dst, int H, int W, int ph,
                              int pw, const int* pm, const int* sm,
                              int ncols, const int* dmap, const int* vmap,
                              int R8, int W8, int uw, int uh, int damping,
                              int bitdepth, int luma, const int* dir_dy,
                              const int* dir_dx, const int* uv_dirs,
                              void* stream) {
    const dim3 threads(32, 8);
    const dim3 blocks(dtpu_blocks(W, 32), dtpu_blocks(H, 8));
    cdef_filter_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        src, dst, H, W, ph, pw, pm, sm, ncols, dmap, vmap, R8, W8, uw, uh,
        damping, bitdepth - 8, luma, dir_dy, dir_dx, uv_dirs);
    return (int)cudaGetLastError();
}
