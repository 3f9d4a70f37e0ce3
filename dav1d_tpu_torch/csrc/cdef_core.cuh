// The arithmetic of the CDEF filter kernel (csrc/cdef_filter.cu): the
// phases of one TILE_H x TILE_W tile of a plane, over the tile's shared
// arrays.
//
// Semantics (dav1d_tpu/ops/pallas_cdef.py, reference
// src/cdef_tmpl.c:106; the plain version ops/cdef.filter_plane_plain):
// * a unit (uh x uw pixels: 8x8 luma and 4:4:4 chroma, 4x4 4:2:0 and
//   4x8 4:2:2 chroma) takes pm / sm from the (nbands, ncols) strength
//   grids; luma: pri = (pm * (4 + min(ilog2(var >> 6), 12)) + 8) >> 4
//   where pm > 0 and var != 0, else 0, dir = pm > 0 ? dmap : 0; chroma:
//   pri = pm, dir = pm > 0 ? uv_dirs[dmap] : 0 (units beyond the maps
//   read dir = var = 0);
// * pixels whose unit has pri == sec == 0, and pixels outside the
//   (ph, pw) filtered region, pass through;
// * a tap outside (ph, pw) reads the sentinel -28672 (pallas_cdef.py
//   _SENT16): the min ignores it, the max does not (it is below every
//   pixel, so it never wins the max either), and its constraint is that
//   of any tap (0 for every damping the codec allows);
// * band form (a row band of a plane, recon/mesh_cdef.py): src holds
//   `top` halo rows above the band's rows and `bot` below them, and
//   rows, units, maps and dst are in the band's own coordinates (src
//   points at the band's row 0); a tap in rows [-top, 0) or
//   [ph, ph + bot) reads the halo's pixel, and every other tap outside
//   (ph, pw) the sentinel.  The whole plane is the band with no halo;
// * constrain(d, s, sh) = sign(d) * min(|d|, max(0, s - (|d| >> sh)));
//   primary weights 4/3 (k=0) and 2/3 (k=1) by strength parity,
//   secondary weights 2 and 1; out = px + ((sum - (sum < 0) + 8) >> 4),
//   clipped to [min, max] of the pixel and its taps only when pri and
//   sec are both nonzero.
//
// The arithmetic is that of the plain version, int32 throughout, with
// the tile staged as int32 too: staged as int16 (the TPU kernel's
// storage, pallas_cdef.py:45-48), the filter came out wrong from ptxas
// (CUDA 12.8, -O3; right at -Xptxas -O0 and with int32 staging: PERF.md
// section 6).  The max ignores the sentinel as a signed max; the min ignores
// it as an unsigned min (the sentinel, negative, is then above every
// pixel), which needs the pixels >= 0, as the codec's [0, 2^bitdepth)
// are.  A zero strength's constraint is 0 for every tap, so every unit
// runs all 12 taps with one body.
//
// Phases, each a loop that thread `tid` of `nt` runs over its items:
//   units   one item per unit: its strengths, direction, shifts and
//           weights; returns whether any of the thread's units is active;
//   stage   the tile and a 2-pixel halo, the sentinel where a tap lies
//           outside (ph, pw) and the band's halo rows, with 16-byte loads
//           where the row allows;
//   filter  one item per 4 neighbouring pixels of a tile row (one unit:
//           units are 4 or 8 wide), taps from shared memory, a 16-byte
//           store where the row allows;
//   copy    a tile with no active unit, or beyond (ph, pw), as 16-byte
//           copies.
// units and stage share a barrier; filter or copy follows.
//
// The header compiles as CUDA device code (included by cdef_filter.cu)
// and as plain C++ (a host build runs the same phases thread by thread),
// so the CUDA builtins stay behind the helpers at the top.
#pragma once

#include <string.h>

#ifdef __CUDACC__
#define CDEF_FN __device__ inline
#define CDEF_CONST __constant__
#define CDEF_LDG(p) __ldg(p)
#else
#define CDEF_FN inline
#define CDEF_CONST static const
#define CDEF_LDG(p) (*(p))
#endif

namespace cdef {

constexpr int TILE_W = 64, TILE_H = 16, HALO = 2;
// staged row stride: TILE_W + 2 * HALO = 68 padded to 70 (a thread's 4
// pixels sit 4 words from its neighbour's: a warp's two rows then meet
// each bank at most twice)
constexpr int SW = 70, SH = TILE_H + 2 * HALO;
constexpr int CHUNKS = TILE_W / 4;                 // 4-pixel items a row
constexpr int MAX_UNITS = (TILE_W / 4) * (TILE_H / 4);
constexpr int SENT = -28672;                       // pallas_cdef _SENT16

// Tap offsets [pass k][2 + dir] (primary) and [k][dir], [k][4 + dir]
// (secondary): recon/cdef.py CDEF_DIRECTIONS; chroma direction remaps
// [4:2:0, 4:2:2]: recon/cdef.py UV_DIRS_420 / UV_DIRS_422.
CDEF_CONST signed char DIR_DY[2][12] = {
    {1, 1, -1, 0, 0, 0, 1, 1, 1, 1, -1, 0},
    {2, 2, -2, -1, 0, 1, 2, 2, 2, 2, -2, -1}};
CDEF_CONST signed char DIR_DX[2][12] = {
    {0, 0, 1, 1, 1, 1, 1, 0, 0, 0, 1, 1},
    {0, -1, 2, 2, 2, 2, 2, 1, 0, -1, 2, 2}};
CDEF_CONST signed char UV_DIRS[2][8] = {{0, 1, 2, 3, 4, 5, 6, 7},
                                        {7, 0, 2, 4, 5, 6, 6, 6}};

// One plane's launch parameters (the arguments of dtpu_cdef_filter).
struct Plane {
    const int* src;     // the band's row 0: rows -top .. H + bot - 1
    int* dst;           // (H, W)
    int H, W, ph, pw;
    int top, bot;       // halo rows above row 0 and below row ph - 1
    const int* pm;      // (nbands, ncols) unit strength grids
    const int* sm;
    int nbands, ncols;
    const int* dmap;    // (R8, W8) direction / variance maps
    const int* vmap;
    int R8, W8;
    int lw, lh;         // log2 of the unit width / height (2 or 3)
    int damping, bd_m8, luma, l422;
    int vec;            // rows 16-byte aligned: W % 4 == 0, aligned bases
};

// A unit's filter: the strengths, its direction, the shifts of
// constrain, and the primary weights of passes 0 and 1.
struct Unit {
    int pri, sec, dir, pri_sh, sec_sh, w0, w1;
};

struct Tile {
    int px[SH * SW];
    Unit u[MAX_UNITS];
};

CDEF_FN int ulog2(int v) {  // floor(log2(v)) for v >= 1
#ifdef __CUDACC__
    return 31 - __clz(v);
#else
    return 31 - __builtin_clz((unsigned)v);
#endif
}

CDEF_FN int imin(int a, int b) { return a < b ? a : b; }

// whether row y of the band (or of its halo) holds pixels
CDEF_FN bool row_in(const Plane& p, int y) {
    return y >= -p.top && y < p.ph + p.bot;
}
CDEF_FN int imax(int a, int b) { return a > b ? a : b; }
CDEF_FN unsigned umin(unsigned a, unsigned b) { return a < b ? a : b; }

CDEF_FN void load4(const int* p, int* v) {
#ifdef __CUDACC__
    const int4 q = __ldg(reinterpret_cast<const int4*>(p));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
#else
    memcpy(v, p, 16);
#endif
}

CDEF_FN void store4(int* p, const int* v) {
#ifdef __CUDACC__
    *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
#else
    memcpy(p, v, 16);
#endif
}

// sign(d) * min(|d|, max(0, s - (|d| >> sh))), as d clamped to +-l
CDEF_FN int constrain(int d, int s, int sh) {
    const int l = imax(s - ((d < 0 ? -d : d) >> sh), 0);
    return imin(imax(d, -l), l);
}

// The 4 pixels at (y, x..x+3) of src to dst: one 16-byte copy when the
// row allows, else pixel by pixel.
CDEF_FN void copy_chunk(const Plane& p, int y, int x) {
    const long long o = (long long)y * p.W + x;
    if (p.vec && x + 3 < p.W) {
        int v[4];
        load4(p.src + o, v);
        store4(p.dst + o, v);
    } else {
        for (int k = 0; k < 4 && x + k < p.W; k++)
            p.dst[o + k] = CDEF_LDG(p.src + o + k);
    }
}

// y0, x0: the tile's top-left pixel (multiples of TILE_H, TILE_W, so of
// the unit size).
CDEF_FN bool units(Tile& s, const Plane& p, int y0, int x0, int tid, int nt) {
    const int nux = TILE_W >> p.lw, n = nux * (TILE_H >> p.lh);
    bool any = false;
    for (int i = tid; i < n; i += nt) {
        const int ub = (y0 >> p.lh) + i / nux, uc = (x0 >> p.lw) + i % nux;
        Unit u = {0, 0, 0, 0, 0, 0, 0};
        if (ub < p.nbands && uc < p.ncols) {
            const int pm = CDEF_LDG(p.pm + ub * p.ncols + uc);
            u.sec = CDEF_LDG(p.sm + ub * p.ncols + uc);
            const bool in_map = ub < p.R8 && uc < p.W8;
            const int d = in_map ? CDEF_LDG(p.dmap + ub * p.W8 + uc) : 0;
            if (p.luma) {
                const int v = in_map ? CDEF_LDG(p.vmap + ub * p.W8 + uc) : 0;
                const int v6 = v >> 6;
                const int lg = v6 > 0 ? ulog2(v6) : 0;
                u.pri = (pm > 0 && v != 0)
                            ? (pm * (4 + (lg < 12 ? lg : 12)) + 8) >> 4 : 0;
                u.dir = pm > 0 ? d : 0;
            } else {
                u.pri = pm;
                u.dir = pm > 0 ? UV_DIRS[p.l422][d] : 0;
            }
        }
        if (u.pri > 0) {
            u.pri_sh = imax(p.damping - ulog2(u.pri), 0);
            const bool par = (u.pri >> p.bd_m8) & 1;
            u.w0 = par ? 3 : 4;
            u.w1 = par ? 3 : 2;
        }
        if (u.sec > 0) u.sec_sh = p.damping - ulog2(u.sec);
        any |= u.pri > 0 || u.sec > 0;
        s.u[i] = u;
    }
    return any;
}

// Items: SH rows x CHUNKS 4-pixel chunks of the tile's columns, then
// SH rows x the 4 halo columns.
CDEF_FN void stage(Tile& s, const Plane& p, int y0, int x0, int tid, int nt) {
    const int n_in = SH * CHUNKS, n = n_in + SH * 2 * HALO;
    for (int i = tid; i < n; i += nt) {
        if (i < n_in) {
            const int r = i / CHUNKS, x = x0 + (i % CHUNKS) * 4;
            const int y = y0 - HALO + r;
            int* d = s.px + r * SW + HALO + (x - x0);
            if (row_in(p, y) && p.vec && x + 3 < p.pw) {
                int v[4];
                load4(p.src + (long long)y * p.W + x, v);
                for (int k = 0; k < 4; k++) d[k] = v[k];
            } else {
                const bool row = row_in(p, y);
                for (int k = 0; k < 4; k++)
                    d[k] = row && x + k < p.pw
                               ? CDEF_LDG(p.src + (long long)y * p.W + x + k)
                               : SENT;
            }
        } else {
            const int j = i - n_in, r = j >> 2, c = j & 3;
            const int sc = c < HALO ? c : TILE_W + c;  // staged column
            const int y = y0 - HALO + r, x = x0 - HALO + sc;
            const bool in = row_in(p, y) && x >= 0 && x < p.pw;
            s.px[r * SW + sc] =
                in ? CDEF_LDG(p.src + (long long)y * p.W + x) : SENT;
        }
    }
}

// The pixels c[0..3] of one unit row (c points into the staged tile);
// po[k], so[k][s]: staged offsets of the primary and secondary taps of
// pass k.  Every unit runs all 12 taps (a zero strength's taps add 0),
// and [min, max] clips only where both strengths are nonzero.  (Bodies
// specialised per strength pair made the kernel slower: 3x the code.)
CDEF_FN void filter4(const int* c, const Unit& u, const int* po,
                     const int (*so)[2], int* out) {
    const bool clip = u.pri > 0 && u.sec > 0;
#pragma unroll
    for (int j = 0; j < 4; j++) {
        const int px = c[j];
        int sum = 0, mx = px;
        unsigned mn = (unsigned)px;
#pragma unroll
        for (int k = 0; k < 2; k++) {
            const int t0 = c[j + po[k]], t1 = c[j - po[k]];
            sum += (k == 0 ? u.w0 : u.w1) *
                   (constrain(t0 - px, u.pri, u.pri_sh) +
                    constrain(t1 - px, u.pri, u.pri_sh));
            mn = umin(mn, umin((unsigned)t0, (unsigned)t1));
            mx = imax(mx, imax(t0, t1));
#pragma unroll
            for (int s = 0; s < 2; s++) {
                const int t2 = c[j + so[k][s]], t3 = c[j - so[k][s]];
                sum += (2 - k) * (constrain(t2 - px, u.sec, u.sec_sh) +
                                  constrain(t3 - px, u.sec, u.sec_sh));
                mn = umin(mn, umin((unsigned)t2, (unsigned)t3));
                mx = imax(mx, imax(t2, t3));
            }
        }
        const int o = px + ((sum - (sum < 0) + 8) >> 4);
        out[j] = clip ? imin(imax(o, (int)mn), mx) : o;
    }
}

// Items: TILE_H rows x CHUNKS 4-pixel chunks.
CDEF_FN void filter(const Tile& s, const Plane& p, int y0, int x0, int tid,
                    int nt) {
    const int nux = TILE_W >> p.lw;
    for (int i = tid; i < TILE_H * CHUNKS; i += nt) {
        const int ty = i / CHUNKS, cx = (i % CHUNKS) * 4;
        const int y = y0 + ty, x = x0 + cx;
        if (y >= p.H || x >= p.W) continue;
        const Unit& u = s.u[(ty >> p.lh) * nux + (cx >> p.lw)];
        if (y >= p.ph || x >= p.pw || (u.pri <= 0 && u.sec <= 0)) {
            copy_chunk(p, y, x);
            continue;
        }
        int po[2], so[2][2];
#pragma unroll
        for (int k = 0; k < 2; k++) {
            po[k] = DIR_DY[k][2 + u.dir] * SW + DIR_DX[k][2 + u.dir];
            so[k][0] = DIR_DY[k][4 + u.dir] * SW + DIR_DX[k][4 + u.dir];
            so[k][1] = DIR_DY[k][u.dir] * SW + DIR_DX[k][u.dir];
        }
        const int* c = s.px + (ty + HALO) * SW + HALO + cx;
        const long long o = (long long)y * p.W + x;
        int v[4];
        filter4(c, u, po, so, v);
        for (int k = 0; k < 4; k++)  // pixels beyond pw pass through
            if (x + k >= p.pw && x + k < p.W) v[k] = CDEF_LDG(p.src + o + k);
        if (p.vec && x + 3 < p.W) {
            store4(p.dst + o, v);
        } else {
            for (int k = 0; k < 4 && x + k < p.W; k++) p.dst[o + k] = v[k];
        }
    }
}

// Items: TILE_H rows x CHUNKS 4-pixel chunks.
CDEF_FN void copy(const Plane& p, int y0, int x0, int tid, int nt) {
    for (int i = tid; i < TILE_H * CHUNKS; i += nt) {
        const int y = y0 + i / CHUNKS, x = x0 + (i % CHUNKS) * 4;
        if (y < p.H && x < p.W) copy_chunk(p, y, x);
    }
}

}  // namespace cdef
