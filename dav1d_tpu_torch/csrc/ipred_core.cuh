// The arithmetic of the intra-prediction kernels (csrc/ipred.cu): the
// phases of one prediction unit, over the unit's shared arrays.
//
// A unit is one job row (ops/ipred.py JOB_COLS int32): its origin (dy,
// dx) on the canvas, its size w x h (4..64), and per kind
//
//   pred  the edge availability (have_left, have_top, and the left,
//         bottom-left, top and top-right extents in pixels: the host half
//         of prepare_intra_edges, recon/device_intra._edge_meta), the
//         angle key (bit 9 smooth, bit 10 edge filter, low 9 bits the
//         angle, or the filter-intra set), Z2's clamped max_w / max_h,
//         Z2's top-left filter flag and the resolved mode (numbering of
//         dav1d_tpu_torch/levels.py: DC 0, V 1, H 2, LEFT_DC 3, TOP_DC 4,
//         DC_128 5, Z1 6, Z2 7, Z3 8, SMOOTH 9, SMOOTH_V 10, SMOOTH_H 11,
//         PAETH 12, FILTER 13);
//   cfl   the same availability, the luma origin, alpha, the right /
//         bottom padding and the resolved DC mode;
//   pal   the offset of its index map and its 8 colours.
//
// A CTA takes one unit.  Its phases, each a loop that thread `tid` of
// `nt` runs over its share, separated by barriers:
//
//   load     the job row into shared memory;
//   gather   the 257-entry edge vector from the canvas (the clamped-index
//            rules of recon/device_intra._edge_gather: replication is an
//            index clamp, cross-side fills and constants are selects, rows
//            clamp into the unit's own ph-row half of a stacked chroma
//            canvas; Z2's top-left filter), edge[128] the top-left, the
//            top row above it, the left column mirrored below;
//   prep     the mode's edge processing into `vec` (Z1 / Z3: the
//            filtered or upsampled edge; Z2: the top and left halves
//            around the top-left), the DC value (thread 0), the filter-
//            intra canvas's first row and column;
//   filter   FILTER only: the 4x2 blocks of the unit in anti-diagonal
//            steps (a block reads the blocks above, to the left and above
//            left of it), one barrier a step;
//   output   each pixel's prediction (reference ipred_tmpl.c; the port's
//            golden native/filters.c dtpu_ipred), plus the residual, clipped
//            to [0, 2^bd), written into the canvas in place.
//
// CFL units: load, gather, AC (the subsampled luma sums at each pixel,
// padding replicated, summed into a shared total) with the DC (thread
// 0), output (dc + sign(alpha ac) round(|alpha ac| / 64) with the mean
// removed).  Palette units: output only.
//
// The walk (csrc/ipred.cu ipred_walk) runs every unit of a chain in one
// launch: each unit carries a tag, level << 2 | kind (PRED, CFL, PAL),
// the levels numbered 0, 1, ... in order; a unit of level L > 0 starts
// once done[L - 1] == counts[L - 1] (level_ready), and its CTA adds one
// to done[L] after its last phase (level_finish).  stage_unit copies the
// unit's residual window and index map into shared memory while it
// waits; unit_phases / unit_phase give the phases after load of a unit of
// either kind, so the kernel and a host build run the same dispatch.
// Canvas reads go through IP_LDCG (L2, never the SM's L1, which another
// SM's writes do not invalidate); job rows, residuals and the luma
// canvas of an earlier launch are read-only and keep IP_LDG.
//
// Exactness: every intermediate fits int32 at 12-bit: edge filter sums
// <= 16 * 4095, SMOOTH sums <= 512 * 4095, angular blends <= 64 * 4095,
// filter-intra sums <= 7 * 127 * 4095, the CFL AC <= 32760 a pixel and
// 1024 * 32760 a unit, alpha * AC <= 16 * 65520.
//
// The header compiles as CUDA device code (included by ipred.cu) and as
// plain C++ (a host build runs the phases unit by unit, thread by
// thread), so nothing outside the IP_* macros uses a CUDA builtin.
#pragma once

#ifdef __CUDACC__
#define IP_FN __device__ inline
#define IP_CONST __constant__
#define IP_LDG(p) __ldg(p)
#define IP_LDCG(p) __ldcg(p)
#define IP_ATOMIC_ADD(p, v) atomicAdd(p, v)
#else
#define IP_FN inline
#define IP_CONST
#define IP_LDG(p) (*(p))
#define IP_LDCG(p) (*(p))
#define IP_ATOMIC_ADD(p, v) (*(p) += (v))
#endif

namespace ip {

constexpr int JOB_COLS = 16, OFS = 128, EDGE_LEN = 257;
constexpr int DC = 0, VERT = 1, HOR = 2, LEFT_DC = 3, TOP_DC = 4,
              DC_128 = 5, Z1 = 6, Z2 = 7, Z3 = 8, SMOOTH = 9, SMOOTH_V = 10,
              SMOOTH_H = 11, PAETH = 12, FILTER = 13;
// the filter-intra canvas (units up to 32x32) and the CFL AC (32x32)
constexpr int FC = 33;

// tables.sm_weights
IP_CONST const unsigned char SM_WEIGHTS[128] = {
    0, 0, 255, 128, 255, 149, 85, 64, 255, 197, 146, 105, 73, 50,
    37, 32, 255, 225, 196, 170, 145, 123, 102, 84, 68, 54, 43, 33,
    26, 20, 17, 16, 255, 240, 225, 210, 196, 182, 169, 157, 145, 133,
    122, 111, 101, 92, 83, 74, 66, 59, 52, 45, 39, 34, 29, 25,
    21, 17, 14, 12, 10, 9, 8, 8, 255, 248, 240, 233, 225, 218,
    210, 203, 196, 189, 182, 176, 169, 163, 156, 150, 144, 138, 133, 127,
    121, 116, 111, 106, 101, 96, 91, 86, 82, 77, 73, 69, 65, 61,
    57, 54, 50, 47, 44, 41, 38, 35, 32, 29, 27, 25, 22, 20,
    18, 16, 15, 13, 12, 10, 9, 8, 7, 6, 6, 5, 5, 4,
    4, 4
};
// tables.dr_intra_derivative
IP_CONST const unsigned short DR_DERIV[44] = {
    0, 1023, 0, 547, 372, 0, 0, 273, 215, 0, 178, 151, 0, 132, 116,
    0, 102, 0, 90, 80, 0, 71, 64, 0, 57, 51, 0, 45, 0, 40,
    35, 0, 31, 27, 0, 23, 19, 0, 15, 0, 11, 0, 7, 3
};
// tables.filter_intra_taps: [set][tap j * 8 + output]
IP_CONST const signed char FILTER_TAPS[5][64] = {
    {
     -6, -5, -3, -3, -4, -3, -3, -3, 10, 2, 1, 1, 6, 2, 2, 1,
     0, 10, 1, 1, 0, 6, 2, 2, 0, 0, 10, 2, 0, 0, 6, 2,
     0, 0, 0, 10, 0, 0, 0, 6, 12, 9, 7, 5, 2, 2, 2, 3,
     0, 0, 0, 0, 12, 9, 7, 5, 0, 0, 0, 0, 0, 0, 0, 0},
    {
     -10, -6, -4, -2, -10, -6, -4, -2, 16, 0, 0, 0, 16, 0, 0, 0,
     0, 16, 0, 0, 0, 16, 0, 0, 0, 0, 16, 0, 0, 0, 16, 0,
     0, 0, 0, 16, 0, 0, 0, 16, 10, 6, 4, 2, 0, 0, 0, 0,
     0, 0, 0, 0, 10, 6, 4, 2, 0, 0, 0, 0, 0, 0, 0, 0},
    {
     -8, -8, -8, -8, -4, -4, -4, -4, 8, 0, 0, 0, 4, 0, 0, 0,
     0, 8, 0, 0, 0, 4, 0, 0, 0, 0, 8, 0, 0, 0, 4, 0,
     0, 0, 0, 8, 0, 0, 0, 4, 16, 16, 16, 16, 0, 0, 0, 0,
     0, 0, 0, 0, 16, 16, 16, 16, 0, 0, 0, 0, 0, 0, 0, 0},
    {
     -2, -1, -1, 0, -1, -1, -1, -1, 8, 3, 2, 1, 4, 3, 2, 2,
     0, 8, 3, 2, 0, 4, 3, 2, 0, 0, 8, 3, 0, 0, 4, 3,
     0, 0, 0, 8, 0, 0, 0, 4, 10, 6, 4, 2, 3, 4, 4, 3,
     0, 0, 0, 0, 10, 6, 4, 3, 0, 0, 0, 0, 0, 0, 0, 0},
    {
     -12, -10, -9, -8, -10, -9, -8, -7, 14, 0, 0, 0, 12, 1, 0, 0,
     0, 14, 0, 0, 0, 12, 0, 0, 0, 0, 14, 0, 0, 0, 12, 1,
     0, 0, 0, 14, 0, 0, 0, 12, 14, 12, 11, 10, 0, 0, 1, 1,
     0, 0, 0, 0, 14, 12, 11, 9, 0, 0, 0, 0, 0, 0, 0, 0}
};

// One job row (ops/ipred.py column names).
struct Unit {
    int dy, dx, w, h, hl, ht, pxl, pxbl, pxt, pxtr, akey, kmw, kmh, z2f,
        mode, c15;
};

// The canvas a launch works on: (H, W) int32, the residual canvas of the
// same shape, ph rows a plane (H, or half of a stacked chroma canvas).
struct Plane {
    int* canvas;
    const int* resid;
    int H, W, ph, bd;
};

struct Shared {
    Unit u;
    int edge[EDGE_LEN];
    int vec[260];  // processed edge: Z1 / Z3 vector, Z2 buffer (top-left
                   // at 64)
    union {
        int fc[FC * FC];  // filter-intra canvas, row 0 / column 0 edges
        int ac[1024];     // CFL AC
    };
    int dc, sum;
    signed char taps[64];  // FILTER: the unit's filter set
    // the walk's staged inputs (stage_unit), null in the per-level
    // kernels: the residual window (w per row) and a palette unit's
    // index map
    const int* res;
    const unsigned char* idx;
};

IP_FN int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}
IP_FN int mini(int a, int b) { return a < b ? a : b; }
IP_FN int maxi(int a, int b) { return a > b ? a : b; }
IP_FN int ulog2(int v) {
    int r = 0;
    while (v > 1) v >>= 1, r++;
    return r;
}

// ---- load / gather -------------------------------------------------------

IP_FN void load(Shared& s, const int* job, int tid, int nt) {
    int* u = &s.u.dy;
    for (int i = tid; i < JOB_COLS; i += nt) u[i] = IP_LDG(job + i);
    if (tid == 0) {
        s.sum = 0;
        s.res = nullptr;
        s.idx = nullptr;
    }
}

IP_FN int rd(const Plane& p, const Unit& u, int r, int c) {
    const int lo = u.dy >= p.ph ? p.ph : 0;
    return IP_LDCG(p.canvas + (long long)clampi(r, lo, lo + p.ph - 1) * p.W +
                   clampi(c, 0, p.W - 1));
}

// edge[k] of unit u, without Z2's top-left filter
IP_FN int edge_at(const Plane& p, const Unit& u, int k) {
    const int half = (1 << p.bd) >> 1;
    if (k < OFS) {
        const int i = OFS - 1 - k;
        if (i >= 2 * u.h) return 0;
        if (!u.hl) return u.ht ? rd(p, u, u.dy - 1, u.dx) : half + 1;
        const int row = i < u.h ? u.dy + mini(i, u.pxl - 1)
                        : u.pxbl > 0 ? u.dy + u.h + mini(i - u.h, u.pxbl - 1)
                                     : u.dy + u.pxl - 1;
        return rd(p, u, row, u.dx - 1);
    }
    if (k > OFS) {
        const int j = k - OFS - 1;
        if (j >= 2 * u.w) return 0;
        if (!u.ht) return u.hl ? rd(p, u, u.dy, u.dx - 1) : half - 1;
        const int col = j < u.w ? u.dx + mini(j, u.pxt - 1)
                        : u.pxtr > 0 ? u.dx + u.w + mini(j - u.w, u.pxtr - 1)
                                     : u.dx + u.pxt - 1;
        return rd(p, u, u.dy - 1, col);
    }
    if (u.hl) return rd(p, u, u.dy - u.ht, u.dx - 1);
    return u.ht ? rd(p, u, u.dy - 1, u.dx) : half;
}

IP_FN void gather(Shared& s, const Plane& p, bool z2f, int tid, int nt) {
    const Unit& u = s.u;
    for (int k = tid; k < EDGE_LEN; k += nt) {
        int v = edge_at(p, u, k);
        if (k == OFS && z2f && u.z2f)
            v = ((edge_at(p, u, OFS - 1) + edge_at(p, u, OFS + 1)) * 5 +
                 v * 6 + 8) >> 4;
        s.edge[k] = v;
    }
}

// ---- edge processing (reference filter_edge / upsample_edge) -----------

IP_FN int filter_strength(int wh, int angle, int is_sm) {
    if (is_sm) {
        if (wh <= 8) {
            if (angle >= 64) return 2;
            if (angle >= 40) return 1;
        } else if (wh <= 16) {
            if (angle >= 48) return 2;
            if (angle >= 20) return 1;
        } else if (wh <= 24) {
            if (angle >= 4) return 3;
        } else {
            return 3;
        }
    } else {
        if (wh <= 8) {
            if (angle >= 56) return 1;
        } else if (wh <= 16) {
            if (angle >= 40) return 1;
        } else if (wh <= 24) {
            if (angle >= 32) return 3;
            if (angle >= 16) return 2;
            if (angle >= 8) return 1;
        } else if (wh <= 32) {
            if (angle >= 32) return 3;
            if (angle >= 4) return 2;
            return 1;
        } else {
            return 3;
        }
    }
    return 0;
}

IP_FN int upsample_flag(int wh, int angle, int is_sm) {
    return angle < 40 && wh <= (16 >> is_sm);
}

// inp[base + clamp(i, frm, to - 1)]
IP_FN int inp_at(const int* inp, int base, int i, int frm, int to) {
    return inp[base + clampi(i, frm, to - 1)];
}

// output i of filter_edge over sz entries
IP_FN int filter_edge(const int* inp, int base, int frm, int to, int i,
                      int sz, int lim_from, int lim_to, int strength) {
    if (i < mini(sz, lim_from) || i >= mini(lim_to, sz))
        return inp_at(inp, base, i, frm, to);
    const int k0 = strength == 3 ? 2 : 0;
    const int k1 = strength == 1 ? 4 : strength == 2 ? 5 : 4;
    const int k2 = strength == 1 ? 8 : strength == 2 ? 6 : 4;
    const int s = k0 * (inp_at(inp, base, i - 2, frm, to) +
                        inp_at(inp, base, i + 2, frm, to)) +
                  k1 * (inp_at(inp, base, i - 1, frm, to) +
                        inp_at(inp, base, i + 1, frm, to)) +
                  k2 * inp_at(inp, base, i, frm, to);
    return (s + 8) >> 4;
}

// output k of upsample_edge over hsz input entries
IP_FN int upsample_edge(const int* inp, int base, int frm, int to, int k,
                        int maxp) {
    const int i = k >> 1;
    if (!(k & 1)) return inp_at(inp, base, i, frm, to);
    const int s = -inp_at(inp, base, i - 1, frm, to) +
                  9 * inp_at(inp, base, i, frm, to) +
                  9 * inp_at(inp, base, i + 1, frm, to) -
                  inp_at(inp, base, i + 2, frm, to);
    return clampi((s + 8) >> 4, 0, maxp);
}

// The angular parameters of a unit (the reference's per-mode decisions).
struct Ang {
    int ups_a, ups_l, str_a, str_l, dx, dy, max_base, vec_top;
};

IP_FN Ang angular(const Unit& u) {
    Ang a{};
    const int is_sm = (u.akey >> 9) & 1, en = u.akey >> 10;
    const int angle = u.akey & 511;
    const int n = u.w + u.h;
    if (u.mode == Z1) {
        a.dx = DR_DERIV[angle >> 1];
        a.ups_a = en ? upsample_flag(n, 90 - angle, is_sm) : 0;
        a.str_a = en && !a.ups_a ? filter_strength(n, 90 - angle, is_sm) : 0;
        if (a.ups_a) {
            a.max_base = 2 * n - 2;
            a.dx <<= 1;
        } else {
            a.max_base = a.str_a ? n - 1 : u.w + mini(u.w, u.h) - 1;
        }
    } else if (u.mode == Z3) {
        a.dy = DR_DERIV[(270 - angle) >> 1];
        a.ups_l = en ? upsample_flag(n, angle - 180, is_sm) : 0;
        a.str_l = en && !a.ups_l ? filter_strength(n, angle - 180, is_sm)
                                 : 0;
        if (a.ups_l) {
            a.max_base = a.vec_top = 2 * n - 2;
            a.dy <<= 1;
        } else {
            a.vec_top = n - 1;
            a.max_base = a.str_l ? n - 1 : u.h + mini(u.w, u.h) - 1;
        }
    } else if (u.mode == Z2) {
        a.dy = DR_DERIV[(angle - 90) >> 1];
        a.dx = DR_DERIV[(180 - angle) >> 1];
        a.ups_l = en ? upsample_flag(n, 180 - angle, is_sm) : 0;
        a.ups_a = en ? upsample_flag(n, angle - 90, is_sm) : 0;
        a.str_a = en && !a.ups_a ? filter_strength(n, angle - 90, is_sm) : 0;
        a.str_l = en && !a.ups_l ? filter_strength(n, 180 - angle, is_sm)
                                 : 0;
        if (a.ups_a) a.dx <<= 1;
        if (a.ups_l) a.dy <<= 1;
    }
    return a;
}

IP_FN int dc_value(const int* edge, int mode, int w, int h, int bd) {
    if (mode == DC_128) return (1 << bd) >> 1;
    int top = 0, left = 0;
    if (mode != LEFT_DC)
        for (int i = 0; i < w; i++) top += edge[OFS + 1 + i];
    if (mode != TOP_DC)
        for (int i = 0; i < h; i++) left += edge[OFS - 1 - i];
    if (mode == TOP_DC) return (top + (w >> 1)) >> ulog2(w);
    if (mode == LEFT_DC) return (left + (h >> 1)) >> ulog2(h);
    int dc = (((w + h) >> 1) + top + left) >> ulog2((w + h) & -(w + h));
    if (w != h) {
        const bool wide = w > h * 2 || h > w * 2;
        // (dc * m) >> 16 / 17 exceeds int32 above 2^15 * 2^16
        const long long m = bd == 8 ? (wide ? 0x3334 : 0x5556)
                                    : (wide ? 0x6667 : 0xAAAB);
        dc = (int)(((long long)dc * m) >> (bd == 8 ? 16 : 17));
    }
    return dc;
}

// ---- prep ----------------------------------------------------------------

IP_FN void prep(Shared& s, int bd, int tid, int nt) {
    const Unit& u = s.u;
    const int maxp = (1 << bd) - 1;
    const int w = u.w, h = u.h, n = w + h;
    const int* e = s.edge;
    if (u.mode == Z1 || u.mode == Z3) {
        const Ang a = angular(u);
        const bool z1 = u.mode == Z1;
        const int ups = z1 ? a.ups_a : a.ups_l;
        const int str = z1 ? a.str_a : a.str_l;
        // Z1 reads top_in = edge + OFS ([0] the top-left) from 1; Z3 reads
        // edge + OFS - n from 0, its [n] the top-left
        const int base = z1 ? 1 : 0, frm = z1 ? -1 : maxi(w - h, 0);
        const int to = z1 ? w + mini(w, h) : n + 1;
        const int* inp = z1 ? e + OFS : e + OFS - n;
        if (ups) {
            for (int k = tid; k < 2 * n - 1; k += nt)
                s.vec[k] = upsample_edge(inp, base, frm, to, k, maxp);
        } else if (str) {
            for (int i = tid; i < n; i += nt)
                s.vec[i] = filter_edge(inp, base, frm, to, i, n, 0, n, str);
        } else {
            for (int i = tid; i < n; i += nt)
                s.vec[i] = z1 ? e[OFS + 1 + i] : e[OFS - n + i];
        }
    } else if (u.mode == Z2) {
        const Ang a = angular(u);
        const int TL = 64;
        // top: buf[TL + 1 + i]; with upsampling buf[TL + k], k <= 2w
        const int* top_in = e + OFS;
        const int* left_in = e + OFS - h;  // [h] the top-left
        for (int k = tid; k < 129; k += nt) {
            int v = 0;
            const int t = k - TL;
            if (t == 0) {
                v = e[OFS];
            } else if (t > 0) {
                if (a.ups_a) {
                    if (t <= 2 * w)
                        v = upsample_edge(top_in, 0, 0, w + 1, t, maxp);
                } else if (t <= w) {
                    v = a.str_a ? filter_edge(top_in, 1, -1, w, t - 1, w, 0,
                                              u.kmw, a.str_a)
                                : top_in[t];
                }
            } else {
                if (a.ups_l) {
                    if (t >= -2 * h)
                        v = upsample_edge(left_in, 0, 0, h + 1, t + 2 * h,
                                          maxp);
                } else if (t >= -h) {
                    v = a.str_l ? filter_edge(left_in, 0, 0, h + 1, t + h, h,
                                              h - u.kmh, h, a.str_l)
                                : left_in[t + h];
                }
            }
            s.vec[k] = v;
        }
    } else if (u.mode == FILTER) {
        const signed char* f = FILTER_TAPS[clampi(u.akey & 511, 0, 4)];
        for (int i = tid; i < 64; i += nt) s.taps[i] = f[i];
        for (int i = tid; i <= w; i += nt) s.fc[i] = e[OFS + i];
        for (int i = tid; i < h; i += nt) s.fc[(1 + i) * FC] = e[OFS - 1 - i];
    } else if (tid == 0 && (u.mode == DC || u.mode == TOP_DC ||
                            u.mode == LEFT_DC || u.mode == DC_128)) {
        s.dc = dc_value(e, u.mode, w, h, bd);
    }
}

// FILTER step st: the 4x2 blocks (by, bx) with by + bx == st
IP_FN void filter_step(Shared& s, int bd, int st, int tid, int nt) {
    const Unit& u = s.u;
    const int nbx = u.w >> 2, nby = u.h >> 1;
    // the set's taps from shared memory: lanes reading different taps of
    // the constant bank would serialise
    const signed char* f = s.taps;
    const int bx_lo = maxi(0, st - (nby - 1)), bx_hi = mini(nbx - 1, st);
    const int n = (bx_hi - bx_lo + 1) * 8;
    for (int t = tid; t < n; t += nt) {
        const int bx = bx_lo + (t >> 3), by = st - bx, fi = t & 7;
        const int y = 2 * by, x = 4 * bx;
        const int* r0 = s.fc + y * FC + x;
        const int acc = f[fi] * r0[0] + f[fi + 8] * r0[1] +
                        f[fi + 16] * r0[2] + f[fi + 24] * r0[3] +
                        f[fi + 32] * r0[4] + f[fi + 40] * r0[FC] +
                        f[fi + 48] * r0[2 * FC];
        s.fc[(y + 1 + (fi >> 2)) * FC + x + 1 + (fi & 3)] =
            clampi((acc + 8) >> 4, 0, (1 << bd) - 1);
    }
}

IP_FN int filter_steps(const Unit& u) {
    return u.mode == FILTER ? (u.w >> 2) + (u.h >> 1) - 1 : 0;
}

// ---- output --------------------------------------------------------------

IP_FN int predict(const Shared& s, const Ang& a, int x, int y) {
    const Unit& u = s.u;
    const int* e = s.edge;
    const int w = u.w, h = u.h;
    switch (u.mode) {
    case VERT:
        return e[OFS + 1 + x];
    case HOR:
        return e[OFS - 1 - y];
    case PAETH: {
        const int tl = e[OFS], l = e[OFS - 1 - y], t = e[OFS + 1 + x];
        const int base = l + t - tl;
        const int ld = base > l ? base - l : l - base;
        const int td = base > t ? base - t : t - base;
        const int tld = base > tl ? base - tl : tl - base;
        return (ld <= td && ld <= tld) ? l : (td <= tld ? t : tl);
    }
    case SMOOTH: {
        const int wv = SM_WEIGHTS[h + y], wh = SM_WEIGHTS[w + x];
        return (wv * e[OFS + 1 + x] + (256 - wv) * e[OFS - h] +
                wh * e[OFS - 1 - y] + (256 - wh) * e[OFS + w] + 256) >> 9;
    }
    case SMOOTH_V: {
        const int wv = SM_WEIGHTS[h + y];
        return (wv * e[OFS + 1 + x] + (256 - wv) * e[OFS - h] + 128) >> 8;
    }
    case SMOOTH_H: {
        const int wh = SM_WEIGHTS[w + x];
        return (wh * e[OFS - 1 - y] + (256 - wh) * e[OFS + w] + 128) >> 8;
    }
    case Z1: {
        const int xpos = a.dx * (y + 1), frac = xpos & 0x3E;
        const int base = (xpos >> 6) + (1 + a.ups_a) * x;
        if (base >= a.max_base) return s.vec[a.max_base];
        return (s.vec[base] * (64 - frac) + s.vec[base + 1] * frac + 32) >>
               6;
    }
    case Z3: {
        const int ypos = a.dy * (x + 1), frac = ypos & 0x3E;
        const int base = (ypos >> 6) + (1 + a.ups_l) * y;
        if (base >= a.max_base) return s.vec[a.vec_top - a.max_base];
        return (s.vec[a.vec_top - base] * (64 - frac) +
                s.vec[a.vec_top - base - 1] * frac + 32) >> 6;
    }
    case Z2: {
        const int TL = 64;
        const int xpos = ((1 + a.ups_a) << 6) - a.dx * (y + 1);
        const int base_x = (xpos >> 6) + (1 + a.ups_a) * x;
        if (base_x >= 0) {
            const int fx = xpos & 0x3E;
            return (s.vec[TL + base_x] * (64 - fx) +
                    s.vec[TL + base_x + 1] * fx + 32) >> 6;
        }
        const int ypos = (y << (6 + a.ups_l)) - a.dy * (x + 1);
        const int base_y = ypos >> 6, fy = ypos & 0x3E;
        const int lb = TL - (1 + a.ups_l);
        return (s.vec[lb - base_y] * (64 - fy) +
                s.vec[lb - base_y - 1] * fy + 32) >> 6;
    }
    case FILTER:
        return s.fc[(1 + y) * FC + 1 + x];
    default:  // the DC family
        return s.dc;
    }
}

// pred plus the residual (staged `res`, w per row, or the plane's),
// clipped, into the canvas
IP_FN void write(const Plane& p, const Unit& u, const int* res, int x, int y,
                 int pred) {
    const long long o = (long long)(u.dy + y) * p.W + u.dx + x;
    const int r = res ? res[y * u.w + x] : IP_LDG(p.resid + o);
    p.canvas[o] = clampi(pred + r, 0, (1 << p.bd) - 1);
}

IP_FN void output(const Shared& s, const Plane& p, int tid, int nt) {
    const Unit& u = s.u;
    const Ang a = angular(u);
    for (int i = tid; i < u.w * u.h; i += nt) {
        const int y = i / u.w, x = i % u.w;
        write(p, u, s.res, x, y, predict(s, a, x, y));
    }
}

// ---- CFL -----------------------------------------------------------------

// The AC phase (with the DC, thread 0): ac (before the mean) of every
// pixel into s.ac, summed into s.sum.
IP_FN void cfl_ac(Shared& s, const Plane& p, const int* luma, int YH,
                  int YW, int ss_hor, int ss_ver, int tid, int nt) {
    const Unit& u = s.u;
    // cfl rows: J_Y0 = 10, J_X0 = 11, J_WPAD = 13, J_HPAD = 15
    const int y0 = u.akey, x0 = u.kmw, w_pad = u.z2f, h_pad = u.c15;
    const int core_w = u.w - 4 * w_pad, core_h = u.h - 4 * h_pad;
    const int shift = 1 + !ss_ver + !ss_hor;
    int local = 0;
    for (int i = tid; i < u.w * u.h; i += nt) {
        const int y = mini(i / u.w, core_h - 1), x = mini(i % u.w,
                                                           core_w - 1);
        const int sy = y0 + (y << ss_ver), sx = x0 + (x << ss_hor);
        int v = 0;
        for (int dy = 0; dy <= ss_ver; dy++)
            for (int dx = 0; dx <= ss_hor; dx++)
                v += IP_LDG(luma + (long long)clampi(sy + dy, 0, YH - 1) * YW +
                            clampi(sx + dx, 0, YW - 1));
        s.ac[i] = v << shift;
        local += v << shift;
    }
    IP_ATOMIC_ADD(&s.sum, local);
    if (tid == 0) s.dc = dc_value(s.edge, u.mode, u.w, u.h, p.bd);
}

IP_FN void cfl_output(const Shared& s, const Plane& p, int tid, int nt) {
    const Unit& u = s.u;
    const int log2sz = ulog2(u.w) + ulog2(u.h);
    const int mean = (s.sum + ((1 << log2sz) >> 1)) >> log2sz;
    const int alpha = u.kmh;  // J_ALPHA = 12
    const int maxp = (1 << p.bd) - 1;
    for (int i = tid; i < u.w * u.h; i += nt) {
        const int diff = alpha * (s.ac[i] - mean);
        const int adj = ((diff < 0 ? -diff : diff) + 32) >> 6;
        const int pred = clampi(s.dc + (diff < 0 ? -adj : diff > 0 ? adj : 0),
                                0, maxp);
        write(p, u, s.res, i % u.w, i / u.w, pred);
    }
}

// ---- palette -------------------------------------------------------------

// the palette unit of job row `job` (global, or its shared copy): colour
// job[8 + idx] of each pixel's index in its map `idx`; `res` its staged
// residuals or null
IP_FN void pal_output(const int* job, const Plane& p, const unsigned char* idx,
                      const int* res, int tid, int nt) {
    Unit u;
    u.dy = job[0];
    u.dx = job[1];
    u.w = job[2];
    const int h = job[3];
    for (int i = tid; i < u.w * h; i += nt) {
        const int c = job[8 + (idx[i] & 7)];
        write(p, u, res, i % u.w, i / u.w, c);
    }
}

// ---- the walk ------------------------------------------------------------

constexpr int PRED = 0, CFL = 1, PAL = 2;

IP_FN int tag_level(int tag) { return tag >> 2; }
IP_FN int tag_kind(int tag) { return tag & 3; }

// What a walk launch reads besides its Plane: the chain's job rows and
// tags sorted by tag, the units of each level, the per-level done
// counters (zeroed before the launch), the finished luma canvas (CFL
// units) and the index maps (palette units).
struct Walk {
    const int* jobs;
    const int* tags;
    const int* counts;
    int* done;
    int n;
    const int* luma;
    int YH, YW, ss_hor, ss_ver;
    const unsigned char* pidx;
};

#ifdef __CUDACC__
// the acquire / release pair of CUTLASS's arch/barrier.h at device scope
IP_FN int load_acquire(const int* p) {
    int v;
    asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
                 : "=r"(v) : "l"(p) : "memory");
    return v;
}
IP_FN void release_add(int* p) {
    asm volatile("fence.acq_rel.gpu;\n\tred.relaxed.gpu.global.add.s32 "
                 "[%0], %1;" :: "l"(p), "r"(1) : "memory");
}
#else
inline int load_acquire(const int* p) { return *p; }
inline void release_add(int* p) { ++*p; }
#endif

// whether every unit below `level` has finished (each level's units
// started after the level below it had finished, so level - 1 suffices)
IP_FN bool level_ready(const Walk& w, int level) {
    return level == 0 ||
           load_acquire(w.done + level - 1) == IP_LDG(w.counts + level - 1);
}

IP_FN void level_finish(const Walk& w, int level) {
    release_add(w.done + level);
}

// The walk's staging of a loaded unit, before its level is ready: its
// residual window (read-only during a walk) and a palette unit's index
// map into shared memory, so that its output phase does not go to L2 for
// them after the handoff (the acquire that ends the wait invalidates the
// SM's L1).
struct Stage {
    int res[64 * 64];
    unsigned char idx[64 * 64];
};

IP_FN void stage_unit(Shared& s, Stage& st, const Plane& p, const Walk& w,
                      const int* job, int kind, int tid, int nt) {
    const int dy = IP_LDG(job), dx = IP_LDG(job + 1), uw = IP_LDG(job + 2),
              uh = IP_LDG(job + 3);
    for (int i = tid; i < uw * uh; i += nt)
        st.res[i] = IP_LDG(p.resid + (long long)(dy + i / uw) * p.W + dx +
                           i % uw);
    if (kind == PAL) {
        const unsigned char* m = w.pidx + (unsigned)IP_LDG(job + 4);
        for (int i = tid; i < uw * uh; i += nt) st.idx[i] = IP_LDG(m + i);
    }
    if (tid == 0) {
        s.res = st.res;
        s.idx = st.idx;
    }
}

// phases of a loaded unit after load: pred gather, prep, the filter
// steps, output; CFL gather, AC, output; palette output
IP_FN int unit_phases(const Shared& s, int kind) {
    return kind == PAL ? 1 : kind == CFL ? 3 : 3 + filter_steps(s.u);
}

// phase k of a unit of kind `kind`, its row loaded and its inputs staged
// into s
IP_FN void unit_phase(Shared& s, const Plane& p, const Walk& w, int kind,
                      int k, int tid, int nt) {
    if (kind == PAL) {
        pal_output(&s.u.dy, p, s.idx, s.res, tid, nt);
    } else if (k == 0) {
        gather(s, p, kind == PRED, tid, nt);
    } else if (kind == CFL) {
        if (k == 1)
            cfl_ac(s, p, w.luma, w.YH, w.YW, w.ss_hor, w.ss_ver, tid, nt);
        else
            cfl_output(s, p, tid, nt);
    } else if (k == 1) {
        prep(s, p.bd, tid, nt);
    } else if (k < 2 + filter_steps(s.u)) {
        filter_step(s, p.bd, k - 2, tid, nt);
    } else {
        output(s, p, tid, nt);
    }
}

}  // namespace ip
