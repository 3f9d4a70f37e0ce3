// CDEF filter of one plane, with the unit parameters derived in-kernel.
//
// Replaces the TPU kernel dav1d_tpu/ops/pallas_cdef.py _build (band
// kernel, tail _filter_tail) with the resident derivation of
// _jit_plane_resident.  The TPU version replicates the unit maps to
// per-pixel planes and selects each tap's offset with one-hot masks
// over 8 statically shifted views.  Output goes to a separate plane:
// CDEF reads unfiltered neighbours.  The semantics and the phases are
// those of cdef_core.cuh.
//
// What bounds it on the H100.  The byte bound is the int32 plane read
// once and written once: 17.7 MB for a 1152 x 1920 luma plane, 5.3 us at
// 3.35 TB/s.  The first design (one thread per pixel) made ~29 global
// loads a pixel: the pixel, 12 bounds-checked taps, four unit-map reads
// and 12 tap-offset reads from global tables, with two integer
// divisions and the unit's derivation repeated for each of its 16 or 64
// pixels; it ran at 12% of the bound.  This design removes those loads:
//
// * one CTA of 256 threads per 16 x 64 tile; one thread per unit
//   derives its strengths, direction, shifts and weights once into
//   shared memory (16 to 64 units a tile), while the others stage the
//   tile and its 2-pixel halo once (16-byte loads), with the sentinel
//   where a tap leaves (ph, pw); one barrier, whose
//   __syncthreads_or says whether any unit is active;
// * a tile with no active unit, or beyond (ph, pw), is a 16-byte copy;
// * otherwise each thread filters 4 neighbouring pixels of one unit row
//   from shared memory, with the tap offsets from __constant__ tables,
//   and stores them as one 16-byte vector.
//
// What bounds it is not the bytes but instruction throughput (an
// ablation on the card, PERF.md): the tiles' loads, barrier and stores
// alone come near the byte bound, and the 12 constraints and the [min,
// max] of 13 values a pixel take most of the time, their min/max on the
// SM's 64-lane integer pipe (ptxas puts them on Hopper's 3-input
// min/max).  One filter body for every strength pair beat one body per
// pair (less code); forcing 6 or 8 CTAs an SM spilled and lost.
//
// ptxas (sm_90a, CUDA 12.8): 48 registers, 7,392 B of shared memory, no
// spills.
#include "common.cuh"
#include "cdef_core.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) cdef_filter_kernel(cdef::Plane p) {
    __shared__ cdef::Tile s;
    const int y0 = blockIdx.y * cdef::TILE_H, x0 = blockIdx.x * cdef::TILE_W;
    const int tid = threadIdx.x;
    if (y0 < p.ph && x0 < p.pw) {
        const bool active = cdef::units(s, p, y0, x0, tid, THREADS);
        cdef::stage(s, p, y0, x0, tid, THREADS);
        if (__syncthreads_or(active)) {
            cdef::filter(s, p, y0, x0, tid, THREADS);
            return;
        }
    }
    cdef::copy(p, y0, x0, tid, THREADS);
}

int log2_unit(int v) { return v == 4 ? 2 : (v == 8 ? 3 : -1); }

}  // namespace

// CDEF of the H rows of a band of an int32 plane into dst (H, W).  src:
// the band's canvas of top + H + bot rows, its top and bot halo rows
// around the band's (0 or 2 each; 0 and 0 for a whole plane).  pm/sm:
// (nbands, ncols) unit strength grids, nbands = ceil(ph / uh), ncols =
// ceil(pw / uw), units 4 or 8 on a side; dmap / vmap: (R8, W8) direction
// / variance maps of the luma plane, from the band's first unit row;
// layout_422 picks the chroma direction remap.  Returns cudaError_t.
DTPU_API int dtpu_cdef_filter(const int* src, int* dst, int H, int W, int ph,
                              int pw, int top, int bot, const int* pm,
                              const int* sm, int ncols, const int* dmap,
                              const int* vmap, int R8, int W8, int uw,
                              int uh, int damping, int bitdepth, int luma,
                              int layout_422, void* stream) {
    const int lw = log2_unit(uw), lh = log2_unit(uh);
    if (lw < 0 || lh < 0 || top < 0 || top > cdef::HALO || bot < 0 ||
        bot > cdef::HALO || (bot && ph != H))
        return (int)cudaErrorInvalidValue;
    src += (long long)top * W;
    const bool aligned = ((uintptr_t)src | (uintptr_t)dst) % 16 == 0;
    const cdef::Plane p{src, dst, H, W, ph, pw, top, bot, pm, sm,
                        (ph + uh - 1) / uh, ncols, dmap, vmap, R8, W8, lw,
                        lh, damping, bitdepth - 8, luma,
                        layout_422 ? 1 : 0,
                        (W % 4 == 0 && aligned) ? 1 : 0};
    const dim3 blocks(dtpu_blocks(W, cdef::TILE_W), dtpu_blocks(H, cdef::TILE_H));
    cdef_filter_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}
