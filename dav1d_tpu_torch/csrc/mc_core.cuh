// The arithmetic of the motion-compensation kernel (csrc/mc.cu): the
// phases of one tile of one job, over the tile's shared arrays.
//
// A job is one block of one plane (ops/mc.py job_table): its reference
// entry, block origin (dy, dx) in that reference (signed: it may lie
// outside), size, output offset and row stride, and two 8-tap rows.  A
// tile (ops/mc.py tile_list) is an at most TILE_H x TILE_W piece of a
// job's output.  Its phases, each a loop that thread `tid` of `nt` runs
// over its share of the items:
//
//   load_job  the job row into shared memory;
//   stage     the (th + 7) x (tw + 7) reference window, every read
//             clamped to the reference's coded size (emu_edge);
//   hpass     the horizontal 8-tap sum of every window row, rounded by
//             6 - ib, into the int32 intermediate ((th + 7) x tw);
//   vpass     the vertical 8-tap sum of the intermediate, rounded by
//             6 + ib, clipped to the bit depth and stored narrow.
//
// A compound job (J_COMP = CT_AVG or CT_WEIGHTED_AVG) runs stage and
// hpass once per reference k (its window overwrites the first's); vprep
// keeps reference 0's prep values (the vertical sum rounded by 6,
// prep_8tap_c) in the thread's registers (an Acc), and vblend makes
// reference 1's, blends them (avg_c, w_avg_c of src/mc_tmpl.c), clips
// and stores.  PREP_BIAS (8192 above 8-bit) is left out of both prep
// values: the blends' rounding constants add back exactly what the
// two biases take away, so the sums are equal without it.
//
// The intermediate stays int32: random taps (chip_smoke.py) overflow
// int16.  Every job side is a multiple of 4 (ops/mc.py job_table checks
// it; every MC block of the codec is), so every tile side is too and a
// thread of hpass / vpass computes 4 neighbouring outputs from 11
// shared reads.  The vertical phases run with nt = WARP threads (the
// kernel's warp): a thread's items of a tile are at most ITEMS, which
// lets an Acc index them by unrolled loop counters, in registers.
//
// The header compiles as CUDA device code (included by mc.cu) and as
// plain C++ (a host build runs the same phases thread by thread), so
// nothing outside the MC_LDG macro uses a CUDA builtin.
#pragma once

#ifdef __CUDACC__
#define MC_FN __device__ inline
#define MC_LDG(p) __ldg(p)
#else
#define MC_FN inline
#define MC_LDG(p) (*(p))
#endif

namespace mc {

// Columns of a job row (int32, ops/mc.py job_table): reference 0's
// entry, origin and taps, the size and output; a compound job's
// reference 1, its blend and jnt weight.
constexpr int JOB_COLS = 44;
constexpr int J_ENTRY = 0, J_DY = 1, J_DX = 2, J_W = 3, J_H = 4, J_OUT = 5,
              J_OSTRIDE = 6, J_FH = 7, J_FV = 15;
constexpr int J_ENTRY1 = 23, J_DY1 = 24, J_DX1 = 25, J_FH1 = 26, J_FV1 = 34,
              J_COMP = 42, J_JW = 43;
constexpr int CT_NONE = 0, CT_WEIGHTED_AVG = 1, CT_AVG = 2;
// Columns of a tile row (int32, ops/mc.py tile_list): the job, the
// tile's origin inside the job's block, its size.
constexpr int TILE_COLS = 5;
constexpr int T_JOB = 0, T_Y = 1, T_X = 2, T_H = 3, T_W = 4;
constexpr int TILE_W = 32, TILE_H = 16;
constexpr int WIN_W = TILE_W + 7, WIN_H = TILE_H + 7;
constexpr int WARP = 32;
constexpr int ITEMS = TILE_H / 4 * TILE_W / WARP;

// One tile's shared arrays; row strides are the tile's own (tw + 7 for
// the window, tw for the intermediate).
struct Tile {
    int job[JOB_COLS];
    int win[WIN_H * WIN_W];
    int mid[WIN_H * TILE_W];
};

// A thread's reference-0 prep values of a compound tile: 4 outputs of
// each of its items.
struct Acc {
    int v[ITEMS][4];
};

// One reference plane (a row of the launch's table).
struct Ref {
    const int* base;
    long long stride;
    int vh, vw;
};

MC_FN int clip(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// i / d for 0 <= i < 1024 and 1 <= d <= 64, by a multiply: with
// m = ceil(2^16 / d) = (2^16 + e) / d and e < d, i * m / 2^16 exceeds
// i / d by i * e / (d * 2^16) < 1 / d, which keeps the floor.
struct Div {
    int m;
};
MC_FN Div divider(int d) { return Div{((1 << 16) + d - 1) / d}; }
MC_FN int quot(int i, Div d) { return (i * d.m) >> 16; }

MC_FN void load_job(Tile& s, const int* job, int tid, int nt) {
    for (int i = tid; i < JOB_COLS; i += nt) s.job[i] = MC_LDG(job + i);
}

// Reference k's window.  Reads go out four at a time before their
// shared stores, so four loads of a thread are in flight together.
MC_FN void stage(Tile& s, const Ref& ref, int k, int ty, int tx, int th,
                 int tw, int tid, int nt) {
    const int ww = tw + 7, n = (th + 7) * ww;
    const Div d = divider(ww);
    const int wy = s.job[k ? J_DY1 : J_DY] + ty - 3;
    const int wx = s.job[k ? J_DX1 : J_DX] + tx - 3;
    for (int i0 = tid; i0 < n; i0 += 4 * nt) {
        int v[4] = {0, 0, 0, 0};
#pragma unroll
        for (int q = 0; q < 4; q++) {
            const int i = i0 + q * nt;
            if (i < n) {
                const int r = quot(i, d), c = i - r * ww;
                v[q] = MC_LDG(ref.base +
                              (long long)clip(wy + r, 0, ref.vh - 1) *
                                  ref.stride +
                              clip(wx + c, 0, ref.vw - 1));
            }
        }
#pragma unroll
        for (int q = 0; q < 4; q++)
            if (i0 + q * nt < n) s.win[i0 + q * nt] = v[q];
    }
}

// Reference k's horizontal taps over the window.
MC_FN void hpass(Tile& s, int k, int th, int tw, int ib, int tid, int nt) {
    const int ww = tw + 7, nq = tw >> 2, n = (th + 7) * nq;
    const Div d = divider(nq);
    const int sh = 6 - ib, rnd = (1 << sh) >> 1;
    const int fc = k ? J_FH1 : J_FH;
    int f[8];
#pragma unroll
    for (int t = 0; t < 8; t++) f[t] = s.job[fc + t];
    for (int i = tid; i < n; i += nt) {
        const int r = quot(i, d), c = (i - r * nq) * 4;
        const int* w = s.win + r * ww + c;
        int x[11];
#pragma unroll
        for (int q = 0; q < 11; q++) x[q] = w[q];
#pragma unroll
        for (int q = 0; q < 4; q++) {
            int m = 0;
#pragma unroll
            for (int t = 0; t < 8; t++) m += f[t] * x[q + t];
            s.mid[r * tw + c + q] = (m + rnd) >> sh;
        }
    }
}

// Reference k's vertical taps over the intermediate: for item j (< ITEMS)
// of thread tid (< nt = WARP), a column x and the 4 rows from y, emit(j,
// y, x, a) with a[4] the unrounded sums.
template <typename Emit>
MC_FN void vsums(const Tile& s, int k, int th, int tw, int tid, int nt,
                 Emit emit) {
    const int n = (th >> 2) * tw;
    const Div d = divider(tw);
    const int fc = k ? J_FV1 : J_FV;
    int f[8];
#pragma unroll
    for (int t = 0; t < 8; t++) f[t] = s.job[fc + t];
#pragma unroll
    for (int j = 0; j < ITEMS; j++) {
        const int i = tid + j * nt;
        if (i < n) {
            const int q = quot(i, d), x = i - q * tw, y = q * 4;
            int m[11];
#pragma unroll
            for (int r = 0; r < 11; r++) m[r] = s.mid[(y + r) * tw + x];
            int a[4];
#pragma unroll
            for (int r = 0; r < 4; r++) {
                a[r] = 0;
#pragma unroll
                for (int t = 0; t < 8; t++) a[r] += f[t] * m[r + t];
            }
            emit(j, y, x, a);
        }
    }
}

// A single-reference tile's outputs: rounded by 6 + ib, clipped, stored.
template <typename T>
MC_FN void vpass(const Tile& s, T* out, int ty, int tx, int th, int tw,
                 int ib, int maxp, int tid, int nt) {
    const int sv = 6 + ib, rnd = 1 << (sv - 1);
    const long long ostride = s.job[J_OSTRIDE];
    T* o = out + s.job[J_OUT] + ty * ostride + tx;
    vsums(s, 0, th, tw, tid, nt, [&](int, int y, int x, const int* a) {
#pragma unroll
        for (int r = 0; r < 4; r++)
            o[(y + r) * ostride + x] = (T)clip((a[r] + rnd) >> sv, 0, maxp);
    });
}

// A compound tile's reference-0 prep values into the thread's Acc.
MC_FN void vprep(const Tile& s, Acc& acc, int th, int tw, int tid, int nt) {
    vsums(s, 0, th, tw, tid, nt, [&](int j, int, int, const int* a) {
#pragma unroll
        for (int r = 0; r < 4; r++) acc.v[j][r] = (a[r] + 32) >> 6;
    });
}

// A compound tile's outputs: reference 1's prep values blended with the
// Acc's, avg_c (weights 1, 1; shift ib + 1) or w_avg_c (jw, 16 - jw;
// shift ib + 4), rounded, clipped, stored.
template <typename T>
MC_FN void vblend(const Tile& s, const Acc& acc, T* out, int ty, int tx,
                  int th, int tw, int ib, int maxp, int tid, int nt) {
    const bool wtd = s.job[J_COMP] == CT_WEIGHTED_AVG;
    const int w0 = wtd ? s.job[J_JW] : 1, w1 = wtd ? 16 - w0 : 1;
    const int sh = wtd ? ib + 4 : ib + 1, rnd = 1 << (sh - 1);
    const long long ostride = s.job[J_OSTRIDE];
    T* o = out + s.job[J_OUT] + ty * ostride + tx;
    vsums(s, 1, th, tw, tid, nt, [&](int j, int y, int x, const int* a) {
#pragma unroll
        for (int r = 0; r < 4; r++) {
            const int p1 = (a[r] + 32) >> 6;
            o[(y + r) * ostride + x] =
                (T)clip((acc.v[j][r] * w0 + p1 * w1 + rnd) >> sh, 0, maxp);
        }
    });
}

}  // namespace mc
