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
// The intermediate stays int32: random taps (chip_smoke.py) overflow
// int16.  Every job side is a multiple of 4 (ops/mc.py job_table checks
// it; every MC block of the codec is), so every tile side is too and a
// thread of hpass / vpass computes 4 neighbouring outputs from 11
// shared reads.
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

// Columns of a job row (int32, ops/mc.py job_table).
constexpr int JOB_COLS = 23;
constexpr int J_ENTRY = 0, J_DY = 1, J_DX = 2, J_W = 3, J_H = 4, J_OUT = 5,
              J_OSTRIDE = 6, J_FH = 7, J_FV = 15;
// Columns of a tile row (int32, ops/mc.py tile_list): the job, the
// tile's origin inside the job's block, its size.
constexpr int TILE_COLS = 5;
constexpr int T_JOB = 0, T_Y = 1, T_X = 2, T_H = 3, T_W = 4;
constexpr int TILE_W = 32, TILE_H = 16;
constexpr int WIN_W = TILE_W + 7, WIN_H = TILE_H + 7;

// One tile's shared arrays; row strides are the tile's own (tw + 7 for
// the window, tw for the intermediate).
struct Tile {
    int job[JOB_COLS];
    int win[WIN_H * WIN_W];
    int mid[WIN_H * TILE_W];
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

// Reads go out four at a time before their shared stores, so four
// loads of a thread are in flight together.
MC_FN void stage(Tile& s, const Ref& ref, int ty, int tx, int th, int tw,
                 int tid, int nt) {
    const int ww = tw + 7, n = (th + 7) * ww;
    const Div d = divider(ww);
    const int wy = s.job[J_DY] + ty - 3, wx = s.job[J_DX] + tx - 3;
    for (int i0 = tid; i0 < n; i0 += 4 * nt) {
        int v[4] = {0, 0, 0, 0};
#pragma unroll
        for (int k = 0; k < 4; k++) {
            const int i = i0 + k * nt;
            if (i < n) {
                const int r = quot(i, d), c = i - r * ww;
                v[k] = MC_LDG(ref.base +
                              (long long)clip(wy + r, 0, ref.vh - 1) *
                                  ref.stride +
                              clip(wx + c, 0, ref.vw - 1));
            }
        }
#pragma unroll
        for (int k = 0; k < 4; k++)
            if (i0 + k * nt < n) s.win[i0 + k * nt] = v[k];
    }
}

MC_FN void hpass(Tile& s, int th, int tw, int ib, int tid, int nt) {
    const int ww = tw + 7, nq = tw >> 2, n = (th + 7) * nq;
    const Div d = divider(nq);
    const int sh = 6 - ib, rnd = (1 << sh) >> 1;
    int f[8];
#pragma unroll
    for (int t = 0; t < 8; t++) f[t] = s.job[J_FH + t];
    for (int i = tid; i < n; i += nt) {
        const int r = quot(i, d), c = (i - r * nq) * 4;
        const int* w = s.win + r * ww + c;
        int x[11];
#pragma unroll
        for (int k = 0; k < 11; k++) x[k] = w[k];
#pragma unroll
        for (int k = 0; k < 4; k++) {
            int m = 0;
#pragma unroll
            for (int t = 0; t < 8; t++) m += f[t] * x[k + t];
            s.mid[r * tw + c + k] = (m + rnd) >> sh;
        }
    }
}

template <typename T>
MC_FN void vpass(const Tile& s, T* out, int ty, int tx, int th, int tw,
                 int ib, int maxp, int tid, int nt) {
    const int n = (th >> 2) * tw;
    const Div d = divider(tw);
    const int sv = 6 + ib, rnd = 1 << (sv - 1);
    const long long ostride = s.job[J_OSTRIDE];
    T* o = out + s.job[J_OUT] + ty * ostride + tx;
    int f[8];
#pragma unroll
    for (int t = 0; t < 8; t++) f[t] = s.job[J_FV + t];
    for (int i = tid; i < n; i += nt) {
        const int q = quot(i, d), x = i - q * tw, y = q * 4;
        int m[11];
#pragma unroll
        for (int k = 0; k < 11; k++) m[k] = s.mid[(y + k) * tw + x];
#pragma unroll
        for (int k = 0; k < 4; k++) {
            int a = 0;
#pragma unroll
            for (int t = 0; t < 8; t++) a += f[t] * m[k + t];
            o[(y + k) * ostride + x] = (T)clip((a + rnd) >> sv, 0, maxp);
        }
    }
}

}  // namespace mc
