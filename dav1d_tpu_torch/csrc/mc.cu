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
// Inputs: the job rows and tile rows of mc_core.cuh (ops/mc.py
// job_table, tile_list); the table, int64 (base pointer, row stride,
// vh, vw) per reference plane.  The output buffer holds the current
// frame's planes (narrow), so each block lands in place.
//
// What bounds it on the H100: the bytes, the reference pixels under the
// clamped windows (~12 MB a 1080p inter frame) read once and the
// predictions written once, a few microseconds at 3.35 TB/s.  The first
// design (one thread per pixel, a binary search over the jobs, 64
// gathered loads per pixel) made ~190 M loads a frame and ran at 4% of
// that bound.  This one stages each tile's window once:
//
// * one warp per tile, four warps per CTA; a tile is at most 16 x 32
//   pixels of one job (ops/mc.py tile_list splits the 128 x 128 blocks
//   into 32 tiles), so a small 4x4 chroma job takes one warp instead of
//   idling a CTA;
// * the warp copies its job row to shared memory once, then loads its
//   (th+7) x (tw+7) clamped window (4 loads in flight a thread; 1.75
//   loads per predicted pixel for a 16 x 32 tile instead of 64), runs
//   the horizontal pass once per window row and the vertical pass over
//   the int32 intermediate, each thread making 4 outputs from 11 shared
//   reads; __syncwarp between the phases;
// * a compound job (two references, an average or distance-weighted
//   blend: the reference's prep_8tap_c of each, then avg_c / w_avg_c)
//   runs the stage and the horizontal pass once per reference through
//   the same shared arrays; its reference-0 vertical sums stay in the
//   thread's registers (an mc::Acc, 16 ints at the largest tile) until
//   the reference-1 pass blends them, so a compound tile costs one more
//   window and no more shared memory.  The branch is per job, and a
//   warp is one tile of one job, so no warp diverges on it;
// * 6.5 KB of shared memory a warp (26 KB a CTA): 8 CTAs, 32 warps,
//   per SM.
//
// ptxas (sm_90a, CUDA 12.8): 63 registers (both output types), 26,832 B
// of shared memory, no spills (single-reference only: 52 / 54, 26,496
// B); 8 CTAs an SM still fit the register file.  On the H100 (700 W) a
// launch over a 1080p inter frame (2,037 jobs, 6,418 tiles) took 0.019
// ms, a quarter of it the byte bound: what remains is the stage's load
// latency and the tiles' integer multiply-adds.
#include "common.cuh"
#include "mc_core.cuh"

namespace {

constexpr int WARPS = 4;

__device__ inline mc::Ref ref_of(const long long* table, int entry) {
    const long long* tb = table + 4 * entry;
    return mc::Ref{reinterpret_cast<const int*>(__ldg(tb)), __ldg(tb + 1),
                   (int)__ldg(tb + 2), (int)__ldg(tb + 3)};
}

template <typename T>
__global__ void __launch_bounds__(32 * WARPS)
    mc_put_8tap_kernel(const long long* __restrict__ table,
                       const int* __restrict__ jobs,
                       const int* __restrict__ tiles, int n_tiles,
                       T* __restrict__ out, int ib, int maxp) {
    __shared__ mc::Tile smem[WARPS];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int t = blockIdx.x * WARPS + warp;
    if (t >= n_tiles) return;  // the whole warp: only __syncwarp below
    mc::Tile& s = smem[warp];
    const int* tl = tiles + (long long)t * mc::TILE_COLS;
    const int ty = __ldg(tl + mc::T_Y), tx = __ldg(tl + mc::T_X);
    const int th = __ldg(tl + mc::T_H), tw = __ldg(tl + mc::T_W);

    mc::load_job(s, jobs + (long long)__ldg(tl + mc::T_JOB) * mc::JOB_COLS,
                 lane, 32);
    __syncwarp();
    mc::stage(s, ref_of(table, s.job[mc::J_ENTRY]), 0, ty, tx, th, tw, lane,
              32);
    __syncwarp();
    mc::hpass(s, 0, th, tw, ib, lane, 32);
    __syncwarp();
    if (s.job[mc::J_COMP] == mc::CT_NONE) {  // uniform: one job a warp
        mc::vpass<T>(s, out, ty, tx, th, tw, ib, maxp, lane, 32);
        return;
    }
    // compound: reference 0's prep values stay in registers while
    // reference 1's window replaces its window (hpass 0 is done) and
    // its intermediate replaces the intermediate (after the sync, every
    // vprep read is done)
    mc::Acc acc;
    mc::vprep(s, acc, th, tw, lane, 32);
    mc::stage(s, ref_of(table, s.job[mc::J_ENTRY1]), 1, ty, tx, th, tw,
              lane, 32);
    __syncwarp();
    mc::hpass(s, 1, th, tw, ib, lane, 32);
    __syncwarp();
    mc::vblend<T>(s, acc, out, ty, tx, th, tw, ib, maxp, lane, 32);
}

}  // namespace

DTPU_API int dtpu_mc_put_8tap(const long long* table, const int* jobs,
                              const int* tiles, int n_tiles, void* out,
                              int bitdepth, void* stream) {
    const int ib = bitdepth == 8 ? 4 : 14 - bitdepth;
    const int maxp = (1 << bitdepth) - 1;
    cudaStream_t s = (cudaStream_t)stream;
    if (n_tiles > 0) {
        const unsigned blocks = dtpu_blocks(n_tiles, WARPS);
        if (bitdepth == 8)
            mc_put_8tap_kernel<unsigned char><<<blocks, 32 * WARPS, 0, s>>>(
                table, jobs, tiles, n_tiles, (unsigned char*)out, ib, maxp);
        else
            mc_put_8tap_kernel<short><<<blocks, 32 * WARPS, 0, s>>>(
                table, jobs, tiles, n_tiles, (short*)out, ib, maxp);
    }
    return (int)cudaGetLastError();
}
