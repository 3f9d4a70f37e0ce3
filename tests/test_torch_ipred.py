"""dav1d_tpu_torch intra prediction (ops/ipred.py, recon/device_intra.py)
vs the JAX package, bit-exact.

* the plain predictors (:func:`predict_units`: every resolved mode,
  batched over the units of one (w, h) with per-unit mode, angle, flags
  and Z2 clamps) against dav1d_tpu/recon/device_intra._allmode_pred at
  four sizes (one small enough to upsample, one 64x64) and 8/10/12-bit,
  with the angles of tests/test_ops_ipred.py:50,58,69 under every flag
  combination, both Z2 clamp settings and the five filter-intra sets;
* CFL: the plain AC (:func:`cfl_ac_units`) against the port's golden
  recon/ipred.cfl_ac (every padding and subsampling), the plain
  prediction (:func:`cfl_pred_units`) against dav1d_tpu/ops/ipred.
  cfl_pred_batch; palette (:func:`pal_units`) against pal_pred_batch;
* one level of the port's unit step (:func:`pred_level_plain`: edge
  gather from the canvas, prediction, residual, clip, write-back)
  against dav1d_tpu/recon/device_intra._unit_program on a 64x64 canvas
  with every edge-availability combination and on a stacked chroma
  canvas, at 8/10/12-bit; the CFL and palette level steps against its
  _cfl_program and _pal_program;
* the schedule (recon/device_intra._enumerate_units): on the streams of
  tests/test_device_intra.CASES, no unit reads a cell written at its own
  level or later (the invariant that lets the kernels write in place);
* the kernels' arithmetic, ``csrc/ipred_core.cuh`` built as host C++ and
  run unit by unit, thread by thread (``-k host``), against the plain
  level steps, 12-bit extremes included;
* the walk (every level of a chain in one launch): its dispatch,
  staging and level bookkeeping built as host C++ and run one ticket at
  a time, in ticket order and permuted within each level, against
  :func:`walk_plain` on six-level schedules mixing prediction, CFL and
  palette units at 8/10/12-bit and on the walks of
  tests/test_device_intra.CASES decodes; a unit taken before its level
  is ready is caught; :func:`walk_plain` against the reference's fused
  run of levels (dav1d_tpu/recon/device_intra._multi_run_program); the
  wrapper refuses a table out of level order, with counts that do not
  sum or a kind outside 0..2.

Tolerance: exact (integer codec)."""

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dav1d_tpu.levels import IntraPredMode as M
from dav1d_tpu_torch.ops import ipred as tip

CSRC = Path(tip.__file__).resolve().parent.parent / "csrc"
sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

# reference meta columns (dav1d_tpu/recon/device_intra.py:55-73)
R_AKEY, R_KMW, R_KMH, R_Z2F, R_MODE, R_PREDROW = 8, 9, 10, 11, 12, 13

STATIC = [M.DC_PRED, M.DC_128_PRED, M.TOP_DC_PRED, M.LEFT_DC_PRED,
          M.VERT_PRED, M.HOR_PRED, M.PAETH_PRED, M.SMOOTH_PRED,
          M.SMOOTH_V_PRED, M.SMOOTH_H_PRED]
Z1_ANGLES = [3, 23, 45, 64, 87]
Z2_ANGLES = [93, 113, 135, 157, 177]
Z3_ANGLES = [183, 203, 225, 247, 267]
FLAGS = [0, 512, 1024, 1536]


def unit_params(w, h):
    """[(mode, akey, kmw, kmh)] covering every mode, angle and flag."""
    rows = [(int(m), 0, 0, 0) for m in STATIC]
    for a in Z1_ANGLES:
        rows += [(int(M.Z1_PRED), a | f, 0, 0) for f in FLAGS]
    for a in Z3_ANGLES:
        rows += [(int(M.Z3_PRED), a | f, 0, 0) for f in FLAGS]
    for a in Z2_ANGLES:
        for f in FLAGS:
            rows += [(int(M.Z2_PRED), a | f, w, h),
                     (int(M.Z2_PRED), a | f, max(4, w // 2),
                      max(4, h // 2))]
    if w <= 32 and h <= 32:
        rows += [(int(M.FILTER_PRED), i, 0, 0) for i in range(5)]
    return rows


def _jobs(params, w, h):
    J = np.zeros((len(params), tip.JOB_COLS), np.int32)
    J[:, tip.J_W], J[:, tip.J_H] = w, h
    for i, (mode, akey, kmw, kmh) in enumerate(params):
        J[i, [tip.J_MODE, tip.J_AKEY, tip.J_KMW, tip.J_KMH]] = \
            mode, akey, kmw, kmh
    return J


def _ref_meta(J):
    """The reference's (B, 13) pred meta of port job rows."""
    m = np.zeros((len(J), R_PREDROW), np.int32)
    for src, dst in ((tip.J_DY, 0), (tip.J_DX, 1), (tip.J_HL, 2),
                     (tip.J_HT, 3), (tip.J_PXL, 4), (tip.J_PXBL, 5),
                     (tip.J_PXT, 6), (tip.J_PXTR, 7), (tip.J_AKEY, R_AKEY),
                     (tip.J_KMW, R_KMW), (tip.J_KMH, R_KMH),
                     (tip.J_Z2F, R_Z2F), (tip.J_MODE, R_MODE)):
        m[:, dst] = J[:, src]
    return m


@pytest.mark.parametrize("bitdepth", [8, 10, 12])
@pytest.mark.parametrize("w,h", [(4, 4), (8, 16), (32, 8), (64, 64)])
def test_predict_units_match_jax(w, h, bitdepth):
    import jax.numpy as jnp

    from dav1d_tpu.recon.device_intra import _allmode_pred

    rng = np.random.default_rng(w * 7 + h + bitdepth)
    J = _jobs(unit_params(w, h), w, h)
    edges = rng.integers(0, 1 << bitdepth, (len(J), 257)).astype(np.int32)
    want = np.asarray(_allmode_pred(w, h, bitdepth)(
        jnp.asarray(edges), jnp.asarray(_ref_meta(J))))
    got = tip.predict_units(torch.from_numpy(edges), torch.from_numpy(J),
                            w, h, bitdepth)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("ss", [(1, 1), (1, 0), (0, 0)])
@pytest.mark.parametrize("w,h,w_pad,h_pad", [(4, 4, 0, 0), (8, 16, 1, 2),
                                             (16, 8, 3, 1), (32, 32, 2, 5)])
def test_cfl_ac_units_match_golden(w, h, w_pad, h_pad, ss):
    from dav1d_tpu_torch.recon.ipred import cfl_ac

    ss_hor, ss_ver = ss
    rng = np.random.default_rng(w + h * 3 + w_pad)
    luma = rng.integers(0, 4096, (96, 96)).astype(np.int32)
    J = np.zeros((3, tip.JOB_COLS), np.int32)
    J[:, tip.J_Y0] = rng.integers(0, 96 - (h << ss_ver), 3)
    J[:, tip.J_X0] = rng.integers(0, 96 - (w << ss_hor), 3)
    got = tip.cfl_ac_units(torch.from_numpy(luma), torch.from_numpy(J),
                           w, h, w_pad, h_pad, ss_hor, ss_ver).numpy()
    for i in range(3):
        want = cfl_ac(luma, J[i, tip.J_Y0], J[i, tip.J_X0], w_pad, h_pad,
                      w, h, ss_hor, ss_ver)
        np.testing.assert_array_equal(got[i], want)


@pytest.mark.parametrize("bitdepth", [8, 10, 12])
@pytest.mark.parametrize("mode", [M.DC_PRED, M.TOP_DC_PRED,
                                  M.LEFT_DC_PRED, M.DC_128_PRED])
@pytest.mark.parametrize("w,h", [(4, 4), (8, 16), (32, 32)])
def test_cfl_pred_units_match_jax(w, h, mode, bitdepth):
    from dav1d_tpu.ops.ipred import cfl_pred_batch

    rng = np.random.default_rng(w * 31 + h + bitdepth + int(mode))
    n = 4
    edges = rng.integers(0, 1 << bitdepth, (n, 257)).astype(np.int32)
    ac = rng.integers(-(1 << (bitdepth + 5)), 1 << (bitdepth + 5),
                      (n, h, w)).astype(np.int32)
    alpha = rng.integers(-16, 17, n).astype(np.int32)
    want = np.asarray(cfl_pred_batch(int(mode), edges, w, h, ac, alpha,
                                     bitdepth))
    got = tip.cfl_pred_units(torch.from_numpy(edges), torch.from_numpy(ac),
                             torch.from_numpy(alpha), int(mode), w, h,
                             bitdepth)
    np.testing.assert_array_equal(got.numpy(), want)


def test_pal_units_match_jax():
    from dav1d_tpu.ops.ipred import pal_pred_batch

    rng = np.random.default_rng(5)
    n, w, h = 6, 16, 8
    pal = rng.integers(0, 4096, (n, 8)).astype(np.int32)
    idx = rng.integers(0, 8, (n, h, w)).astype(np.int32)
    want = np.asarray(pal_pred_batch(pal, idx, w, h))
    got = tip.pal_units(torch.from_numpy(pal), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)


# ---- level steps ---------------------------------------------------------

def level_units(rng, H, W, ph_unit, sizes):
    """Job rows of one level of units on the (H, W) canvas, with random
    sizes, modes and every edge-availability combination (have_left /
    have_top, partial left / top extents, bottom-left and top-right
    spans).  Units sit in grid rows, 4 columns apart, each grid row
    followed by a gap as tall as its tallest unit plus 4: every cell a
    unit's edges read (down to 2h below its top, 2w right of its left,
    clamped into its own ``ph_unit`` half) lies in a gap, as in a
    schedule's level."""
    rows = []
    y = 4
    while True:
        row, x = [], 4
        while True:
            w, h = sizes[rng.integers(0, len(sizes))]
            if x + w > W - 4:
                break
            row.append((x, w, h))
            x += w + 4 + 4 * int(rng.integers(0, 3))
        hmax = max(h for _, _, h in row)
        half_end = (y // ph_unit + 1) * ph_unit
        if half_end > H:
            break
        if y + 2 * hmax + 4 > half_end:
            y = half_end + 4
            continue
        for x, w, h in row:
            mode, akey, kmw, kmh = unit_params(w, h)[
                rng.integers(0, len(unit_params(w, h)))]
            hl, ht = int(rng.integers(0, 2)), int(rng.integers(0, 2))
            pxl = int(rng.integers(1, h + 1)) if hl else 0
            pxt = int(rng.integers(1, w + 1)) if ht else 0
            pxbl = int(rng.integers(0, h + 1)) if pxl == h else 0
            pxtr = int(rng.integers(0, w + 1)) if pxt == w else 0
            rows.append([y, x, w, h, hl, ht, pxl, pxbl, pxt, pxtr, akey,
                         kmw, kmh,
                         int(mode == M.Z2_PRED and rng.integers(0, 2)),
                         mode, 0])
        y += 2 * hmax + 4
    return np.asarray(rows, np.int32).reshape(-1, tip.JOB_COLS)


def _canvas(rng, H, W, bitdepth, extremes=False):
    hi = (1 << bitdepth) - 1
    if extremes:
        return rng.choice(np.array([0, 1, hi - 1, hi]), (H, W)).astype(
            np.int32)
    return rng.integers(0, hi + 1, (H, W)).astype(np.int32)


def _resid(rng, H, W, bitdepth):
    r = 1 << bitdepth
    return rng.integers(-r, r, (H, W)).astype(np.int32)


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("bitdepth", [8, 10, 12])
def test_pred_level_matches_jax(bitdepth, stacked):
    import jax.numpy as jnp

    from dav1d_tpu.recon.device_intra import _unit_program

    H, W = 64, 64
    ph_unit = 32 if stacked else H
    sizes = [(4, 4), (8, 4), (4, 8), (8, 8)] if stacked else \
        [(4, 4), (8, 8), (16, 8), (4, 16)]
    for seed in range(4):
        rng = np.random.default_rng(seed * 31 + bitdepth + 3 * stacked)
        canvas = _canvas(rng, H, W, bitdepth)
        resid = _resid(rng, H, W, bitdepth)
        J = level_units(rng, H, W, ph_unit, sizes)
        got = tip.pred_level_plain(
            torch.from_numpy(canvas.copy()), torch.from_numpy(resid),
            torch.from_numpy(J), ph_unit, bitdepth).numpy()
        want = canvas.copy()
        for w, h in sorted({tuple(r) for r in J[:, [tip.J_W, tip.J_H]]}):
            g = _ref_meta(J[(J[:, tip.J_W] == w) & (J[:, tip.J_H] == h)])
            # padded to one batch size with the reference's sentinel rows
            # (dy = H: their scatter drops), one compile per size
            meta = np.zeros((32, R_PREDROW), np.int32)
            meta[:, 0], meta[:, 4], meta[:, 6] = H, 1, 1
            meta[:len(g)] = g
            prog = _unit_program((H, W), ph_unit, int(w), int(h), bitdepth,
                                 32)
            # no unit reads a cell another writes: one program per size
            # on the evolving plane is the level
            want = np.asarray(prog(jnp.asarray(want), jnp.asarray(resid),
                                   jnp.asarray(meta)))
        np.testing.assert_array_equal(got, want)


def cfl_units_rows(rng, H, W, ph_unit, YH, YW, ss_hor, ss_ver, sizes):
    """CFL job rows of one level (the pred layout's geometry, DC modes,
    luma origins inside the luma canvas, random alpha and padding)."""
    J = level_units(rng, H, W, ph_unit, sizes)
    for r in J:
        w, h = int(r[tip.J_W]), int(r[tip.J_H])
        r[tip.J_MODE] = rng.choice([int(M.DC_PRED), int(M.TOP_DC_PRED),
                                    int(M.LEFT_DC_PRED),
                                    int(M.DC_128_PRED)])
        r[tip.J_Y0] = rng.integers(0, YH - (h << ss_ver) + 1)
        r[tip.J_X0] = rng.integers(0, YW - (w << ss_hor) + 1)
        r[tip.J_ALPHA] = rng.integers(-16, 17)
        r[tip.J_WPAD] = rng.integers(0, w // 4)
        r[tip.J_HPAD] = rng.integers(0, h // 4)
    return J


def pal_rows(rng, H, W, sizes, bitdepth):
    """Palette job rows of one level and their index buffer."""
    J = level_units(rng, H, W, H, sizes)
    maps, off = [], 0
    for r in J:
        n = int(r[tip.J_W] * r[tip.J_H])
        r[tip.J_IDX] = off
        r[tip.J_PAL:tip.J_PAL + 8] = rng.integers(0, 1 << bitdepth, 8)
        maps.append(rng.integers(0, 8, n).astype(np.uint8))
        off += n
    return J, np.concatenate(maps + [np.zeros(1, np.uint8)])


@pytest.mark.parametrize("bitdepth", [8, 10, 12])
@pytest.mark.parametrize("ss", [(1, 1), (1, 0), (0, 0)])
def test_cfl_level_matches_jax(ss, bitdepth):
    import jax.numpy as jnp

    from dav1d_tpu.recon.device_intra import _cfl_program

    ss_hor, ss_ver = ss
    rng = np.random.default_rng(bitdepth + 5 * ss_hor + 7 * ss_ver)
    H, W, ph = 64, 64, 32
    YH, YW = 64 << ss_ver, 64 << ss_hor
    canvas = _canvas(rng, H, W, bitdepth)
    luma = _canvas(rng, YH, YW, bitdepth, extremes=bitdepth == 12)
    resid = _resid(rng, H, W, bitdepth)
    J = cfl_units_rows(rng, H, W, ph, YH, YW, ss_hor, ss_ver,
                       [(4, 4), (8, 8), (16, 8), (8, 16)])
    got = tip.cfl_level_plain(torch.from_numpy(canvas.copy()),
                              torch.from_numpy(luma), torch.from_numpy(resid),
                              torch.from_numpy(J), ph, ss_hor, ss_ver,
                              bitdepth).numpy()
    want = canvas.copy()
    for r in J:
        key = [int(r[c]) for c in (tip.J_MODE, tip.J_W, tip.J_H, tip.J_WPAD,
                                   tip.J_HPAD)]
        meta = np.zeros((1, 11), np.int32)
        meta[0, :8] = _ref_meta(r[None])[0, :8]
        meta[0, 8:] = r[tip.J_Y0], r[tip.J_X0], r[tip.J_ALPHA]
        prog = _cfl_program((H, W), ph, (YH, YW), key[0], *key[1:],
                            ss_hor, ss_ver, bitdepth, 1)
        want = np.asarray(prog(jnp.asarray(want), jnp.asarray(luma),
                               jnp.asarray(resid), jnp.asarray(meta)))
    np.testing.assert_array_equal(got, want)


def test_pal_level_matches_jax():
    import jax.numpy as jnp

    from dav1d_tpu.recon.device_intra import _pal_program

    rng = np.random.default_rng(9)
    H, W, bd = 64, 64, 10
    canvas = _canvas(rng, H, W, bd)
    resid = _resid(rng, H, W, bd)
    J, pidx = pal_rows(rng, H, W, [(8, 8), (16, 8), (4, 16)], bd)
    got = tip.pal_level_plain(torch.from_numpy(canvas.copy()),
                              torch.from_numpy(resid), torch.from_numpy(J),
                              torch.from_numpy(pidx), bd).numpy()
    want = canvas.copy()
    for r in J:
        w, h = int(r[tip.J_W]), int(r[tip.J_H])
        meta = np.zeros((1, 8), np.int32)
        meta[0, :2] = r[tip.J_DY], r[tip.J_DX]
        idx = pidx[r[tip.J_IDX]:r[tip.J_IDX] + w * h].reshape(1, h, w)
        prog = _pal_program((H, W), w, h, bd, 1)
        want = np.asarray(prog(jnp.asarray(want), jnp.asarray(resid),
                               jnp.asarray(meta),
                               jnp.asarray(r[None, tip.J_PAL:tip.J_PAL + 8]),
                               jnp.asarray(idx.astype(np.int32))))
    np.testing.assert_array_equal(got, want)


# ---- the kernels' arithmetic on the host ---------------------------------

_HOST_SRC = r"""
#include <vector>

#include "ipred_core.cuh"

// csrc/ipred.cu's kernels, unit after unit, each phase thread by thread
// (nt threads) with the barriers between phases
extern "C" void ipred_host(int* canvas, const int* resid, int H, int W,
                           int ph, const int* jobs, int n, int bd, int nt) {
    const ip::Plane p{canvas, resid, H, W, ph, bd};
    for (int j = 0; j < n; j++) {
        static ip::Shared s;
        for (int t = 0; t < nt; t++) ip::load(s, jobs + j * 16, t, nt);
        for (int t = 0; t < nt; t++) ip::gather(s, p, true, t, nt);
        for (int t = 0; t < nt; t++) ip::prep(s, bd, t, nt);
        for (int st = 0; st < ip::filter_steps(s.u); st++)
            for (int t = 0; t < nt; t++) ip::filter_step(s, bd, st, t, nt);
        for (int t = 0; t < nt; t++) ip::output(s, p, t, nt);
    }
}

extern "C" void cfl_host(int* canvas, const int* luma, const int* resid,
                         int H, int W, int ph, int YH, int YW,
                         const int* jobs, int n, int ss_hor, int ss_ver,
                         int bd, int nt) {
    const ip::Plane p{canvas, resid, H, W, ph, bd};
    for (int j = 0; j < n; j++) {
        static ip::Shared s;
        for (int t = 0; t < nt; t++) ip::load(s, jobs + j * 16, t, nt);
        for (int t = 0; t < nt; t++) ip::gather(s, p, false, t, nt);
        for (int t = 0; t < nt; t++)
            ip::cfl_ac(s, p, luma, YH, YW, ss_hor, ss_ver, t, nt);
        for (int t = 0; t < nt; t++) ip::cfl_output(s, p, t, nt);
    }
}

extern "C" void pal_host(int* canvas, const int* resid, int H, int W,
                         const int* jobs, int n, const unsigned char* pidx,
                         int bd, int nt) {
    const ip::Plane p{canvas, resid, H, W, H, bd};
    for (int j = 0; j < n; j++)
        for (int t = 0; t < nt; t++)
            ip::pal_output(jobs + j * 16, p, pidx + jobs[j * 16 + 4],
                           nullptr, t, nt);
}

// csrc/ipred.cu's walk kernel, one ticket at a time in `order` (the
// tickets, permuted or not), each unit's phases thread by thread with the
// kernel's dispatch and level bookkeeping; returns 0, or 1 + the
// position in `order` of a unit whose level was not ready (the kernel's
// CTA would wait there), or -1 when a level's count was not reached
extern "C" int walk_host(int* canvas, const int* luma, const int* resid,
                         int H, int W, int ph, int YH, int YW,
                         const int* jobs, const int* tags, const int* counts,
                         int n, int n_levels, const int* order,
                         const unsigned char* pidx, int ss_hor, int ss_ver,
                         int bd, int nt) {
    std::vector<int> done(n_levels, 0);
    const ip::Plane p{canvas, resid, H, W, ph, bd};
    const ip::Walk w{jobs, tags, counts, done.data(), n, luma, YH, YW,
                     ss_hor, ss_ver, pidx};
    static ip::Shared s;
    static ip::Stage st;
    for (int i = 0; i < n; i++) {
        const int t = order[i];
        const int level = ip::tag_level(tags[t]), kind = ip::tag_kind(tags[t]);
        for (int th = 0; th < nt; th++) ip::load(s, jobs + t * 16, th, nt);
        for (int th = 0; th < nt; th++)
            ip::stage_unit(s, st, p, w, jobs + t * 16, kind, th, nt);
        if (!ip::level_ready(w, level)) return 1 + i;
        const int phases = ip::unit_phases(s, kind);
        for (int k = 0; k < phases; k++)
            for (int th = 0; th < nt; th++)
                ip::unit_phase(s, p, w, kind, k, th, nt);
        ip::level_finish(w, level);
    }
    for (int l = 0; l < n_levels; l++)
        if (done[l] != counts[l]) return -1;
    return 0;
}

extern "C" const unsigned char* sm_weights_host() { return ip::SM_WEIGHTS; }
extern "C" const unsigned short* dr_deriv_host() { return ip::DR_DERIV; }
extern "C" const signed char* filter_taps_host() {
    return &ip::FILTER_TAPS[0][0];
}
"""


@pytest.fixture(scope="module")
def kernel_on_host(tmp_path_factory):
    """ipred_core.cuh built as host C++ (ctypes)."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no C++ compiler")
    d = tmp_path_factory.mktemp("ipred_host")
    (d / "ipred_host.cc").write_text(_HOST_SRC)
    so = d / "libipred_host.so"
    r = subprocess.run([cxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                        "-I", str(CSRC), "-o", str(so),
                        str(d / "ipred_host.cc")],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    lib = ctypes.CDLL(str(so))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ipred_host.argtypes = [P, P, I, I, I, P, I, I, I]
    lib.cfl_host.argtypes = [P, P, P, I, I, I, I, I, P, I, I, I, I, I]
    lib.pal_host.argtypes = [P, P, I, I, P, I, P, I, I]
    lib.walk_host.argtypes = [P, P, P, I, I, I, I, I, P, P, P, I, I, P, P,
                              I, I, I, I]
    lib.walk_host.restype = ctypes.c_int
    for f in (lib.ipred_host, lib.cfl_host, lib.pal_host):
        f.restype = None
    lib.sm_weights_host.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.dr_deriv_host.restype = ctypes.POINTER(ctypes.c_uint16)
    lib.filter_taps_host.restype = ctypes.POINTER(ctypes.c_int8)
    return lib


def test_kernel_tables_on_host(kernel_on_host):
    from dav1d_tpu_torch import tables

    for fn, ref in ((kernel_on_host.sm_weights_host, tables.sm_weights),
                    (kernel_on_host.dr_deriv_host,
                     tables.dr_intra_derivative),
                    (kernel_on_host.filter_taps_host,
                     tables.filter_intra_taps)):
        got = np.ctypeslib.as_array(fn(), (ref.size,))
        np.testing.assert_array_equal(got, ref.reshape(-1))


SIZES_ALL = [(4, 4), (8, 4), (4, 8), (8, 8), (16, 8), (8, 16), (16, 16),
             (32, 8), (4, 16), (16, 4), (32, 32), (64, 16), (64, 64),
             (16, 64), (32, 64)]


@pytest.mark.parametrize("content", ["random", "extremes"])
@pytest.mark.parametrize("bitdepth", [8, 10, 12])
@pytest.mark.parametrize("stacked", [False, True])
def test_kernel_source_on_host(kernel_on_host, stacked, bitdepth, content):
    """Prediction units of every size 4..64, mode, angle and edge
    combination, on a canvas and a stacked chroma canvas."""
    H, W = 256, 256
    ph = 128 if stacked else H
    for seed in range(3):
        rng = np.random.default_rng(seed * 17 + bitdepth + 2 * stacked)
        canvas = _canvas(rng, H, W, bitdepth, content == "extremes")
        resid = _resid(rng, H, W, bitdepth)
        J = level_units(rng, H, W, ph, SIZES_ALL)
        want = tip.pred_level_plain(
            torch.from_numpy(canvas.copy()), torch.from_numpy(resid),
            torch.from_numpy(J), ph, bitdepth).numpy()
        got = canvas.copy()
        kernel_on_host.ipred_host(got.ctypes.data, resid.ctypes.data, H, W,
                                  ph, J.ctypes.data, len(J), bitdepth, 128)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bitdepth", [8, 10, 12])
@pytest.mark.parametrize("ss", [(1, 1), (1, 0), (0, 0)])
def test_cfl_kernel_source_on_host(kernel_on_host, ss, bitdepth):
    ss_hor, ss_ver = ss
    rng = np.random.default_rng(bitdepth * 3 + ss_hor + 2 * ss_ver)
    H, W, ph = 128, 128, 64
    YH, YW = 64 << ss_ver, 128 << ss_hor
    canvas = _canvas(rng, H, W, bitdepth)
    luma = _canvas(rng, YH, YW, bitdepth, extremes=True)
    resid = _resid(rng, H, W, bitdepth)
    J = cfl_units_rows(rng, H, W, ph, YH, YW, ss_hor, ss_ver,
                       [(4, 4), (8, 8), (16, 16), (32, 32), (16, 8),
                        (8, 32)])
    want = tip.cfl_level_plain(torch.from_numpy(canvas.copy()),
                               torch.from_numpy(luma),
                               torch.from_numpy(resid), torch.from_numpy(J),
                               ph, ss_hor, ss_ver, bitdepth).numpy()
    got = canvas.copy()
    kernel_on_host.cfl_host(got.ctypes.data, luma.ctypes.data,
                            resid.ctypes.data, H, W, ph, YH, YW,
                            J.ctypes.data, len(J), ss_hor, ss_ver, bitdepth,
                            128)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bitdepth", [8, 12])
def test_pal_kernel_source_on_host(kernel_on_host, bitdepth):
    rng = np.random.default_rng(bitdepth)
    H, W = 128, 128
    canvas = _canvas(rng, H, W, bitdepth)
    resid = _resid(rng, H, W, bitdepth)
    J, pidx = pal_rows(rng, H, W, [(8, 8), (16, 16), (64, 32), (32, 64),
                                   (4, 4)], bitdepth)
    want = tip.pal_level_plain(torch.from_numpy(canvas.copy()),
                               torch.from_numpy(resid), torch.from_numpy(J),
                               torch.from_numpy(pidx), bitdepth).numpy()
    got = canvas.copy()
    kernel_on_host.pal_host(got.ctypes.data, resid.ctypes.data, H, W,
                            J.ctypes.data, len(J), pidx.ctypes.data,
                            bitdepth, 128)
    np.testing.assert_array_equal(got, want)


# ---- the walk ------------------------------------------------------------

DC_MODES = [int(M.DC_PRED), int(M.TOP_DC_PRED), int(M.LEFT_DC_PRED),
            int(M.DC_128_PRED)]


def walk_schedule(rng, H, W, ph, YH, YW, n_levels, sizes, bitdepth,
                  kinds=(tip.KIND_PRED, tip.KIND_CFL, tip.KIND_PAL)):
    """A chain's walk table of ``n_levels`` levels on an (H, W) canvas of
    ph-row planes: each level a :func:`level_units` layout (no unit reads
    a cell another unit of its level writes; the layouts of successive
    levels overlap, so a level reads what the levels below it wrote),
    each unit of a kind drawn from ``kinds`` (CFL, up to 32x32: a DC
    variant, an origin in the (YH, YW) luma canvas, alpha, padding;
    palette: colours and an index map), sorted by kind within its level.
    Returns (jobs, tags, counts, pidx)."""
    rows, tags, counts, maps, off = [], [], [], [], 0
    for level in range(n_levels):
        J = level_units(rng, H, W, ph, sizes)
        kind = rng.choice(np.asarray(kinds), len(J))
        kind[(kind == tip.KIND_CFL)
             & (np.maximum(J[:, tip.J_W], J[:, tip.J_H]) > 32)] = \
            tip.KIND_PRED
        order = np.argsort(kind, kind="stable")
        for r, k in zip(J[order], kind[order]):
            w, h = int(r[tip.J_W]), int(r[tip.J_H])
            if k == tip.KIND_CFL:
                r[tip.J_MODE] = rng.choice(DC_MODES)
                r[tip.J_Y0] = rng.integers(0, YH)
                r[tip.J_X0] = rng.integers(0, YW)
                r[tip.J_ALPHA] = rng.integers(-16, 17)
                r[tip.J_WPAD] = rng.integers(0, w // 4)
                r[tip.J_HPAD] = rng.integers(0, h // 4)
            elif k == tip.KIND_PAL:
                r[tip.J_IDX] = off
                r[tip.J_PAL:tip.J_PAL + 8] = rng.integers(0, 1 << bitdepth,
                                                          8)
                maps.append(rng.integers(0, 8, w * h).astype(np.uint8))
                off += w * h
            rows.append(r)
            tags.append(level << 2 | int(k))
        counts.append(len(J))
    return (np.asarray(rows, np.int32).reshape(-1, tip.JOB_COLS),
            np.asarray(tags, np.int32), np.asarray(counts, np.int32),
            np.concatenate(maps + [np.zeros(1, np.uint8)]))


def _tickets(tags, rng=None):
    """The walk's tickets in order or, with ``rng``, permuted within each
    level."""
    t = np.arange(len(tags), dtype=np.int32)
    if rng is None:
        return t
    lvl = np.asarray(tags) >> 2
    return np.concatenate([rng.permutation(t[lvl == v])
                           for v in np.unique(lvl)]).astype(np.int32)


def _walk_host(lib, canvas, luma, resid, jobs, tags, counts, pidx, ph,
               ss_hor, ss_ver, bitdepth, order):
    """The host build's walk on a copy of ``canvas``: (rc, canvas)."""
    got = np.ascontiguousarray(canvas).copy()
    luma = np.ascontiguousarray(luma)
    resid, jobs, tags, counts, pidx = (
        np.ascontiguousarray(a) for a in (resid, jobs, tags, counts, pidx))
    rc = lib.walk_host(got.ctypes.data, luma.ctypes.data, resid.ctypes.data,
                       got.shape[0], got.shape[1], ph, luma.shape[0],
                       luma.shape[1], jobs.ctypes.data, tags.ctypes.data,
                       counts.ctypes.data, len(jobs), len(counts),
                       order.ctypes.data, pidx.ctypes.data, ss_hor, ss_ver,
                       bitdepth, 256)  # csrc/ipred.cu WALK_THREADS
    return rc, got


@pytest.mark.parametrize("order", ["tickets", "permuted"])
@pytest.mark.parametrize("bitdepth", [8, 10, 12])
@pytest.mark.parametrize("stacked", [False, True])
def test_walk_source_on_host(kernel_on_host, stacked, bitdepth, order):
    """The walk's dispatch and level bookkeeping (csrc/ipred_core.cuh
    unit_phases / unit_phase / level_ready / level_finish), built as host
    C++, one ticket at a time in ticket order and permuted within each
    level, against :func:`walk_plain` on six levels mixing prediction,
    CFL and palette units."""
    H, W = 128, 128
    ph = 64 if stacked else H
    ss = 1 if stacked else 0
    YH, YW = H << ss, W << ss
    rng = np.random.default_rng(bitdepth * 5 + stacked)
    canvas = _canvas(rng, H, W, bitdepth)
    luma = _canvas(rng, YH, YW, bitdepth, extremes=True)
    resid = _resid(rng, H, W, bitdepth)
    sizes = [s for s in SIZES_ALL if 2 * s[1] + 8 <= ph]
    J, T, C, pidx = walk_schedule(rng, H, W, ph, YH, YW, 6, sizes,
                                  bitdepth)
    assert {int(k) for k in T & 3} == {0, 1, 2}
    want = tip.walk_plain(
        torch.from_numpy(canvas.copy()), torch.from_numpy(luma),
        torch.from_numpy(resid), torch.from_numpy(J), torch.from_numpy(T),
        torch.from_numpy(C), torch.from_numpy(pidx), ph, ss, ss,
        bitdepth).numpy()
    tickets = _tickets(T, np.random.default_rng(bitdepth) if
                       order == "permuted" else None)
    rc, got = _walk_host(kernel_on_host, canvas, luma, resid, J, T, C, pidx,
                         ph, ss, ss, bitdepth, tickets)
    assert rc == 0
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(want, canvas)


def test_walk_host_waits_for_the_level_below(kernel_on_host):
    """A unit taken before the level below it has finished is not ready
    (the kernel's CTA would wait), and a table whose counts exceed its
    units never completes a level."""
    rng = np.random.default_rng(4)
    H = W = 64
    canvas, resid = _canvas(rng, H, W, 8), _resid(rng, H, W, 8)
    J, T, C, pidx = walk_schedule(rng, H, W, H, H, W, 3, [(4, 4), (8, 8)],
                                  8)
    order = _tickets(T)
    first1 = int(np.flatnonzero(T >> 2 == 1)[0])
    order[[first1 - 1, first1]] = order[[first1, first1 - 1]]
    rc, _ = _walk_host(kernel_on_host, canvas, canvas, resid, J, T, C, pidx,
                       H, 0, 0, 8, order)
    assert rc == first1
    more = C.copy()
    more[-1] += 1
    rc, _ = _walk_host(kernel_on_host, canvas, canvas, resid, J, T, more,
                       pidx, H, 0, 0, 8, _tickets(T))
    assert rc == -1


@pytest.mark.parametrize("bitdepth,stacked", [(8, False), (10, True)])
def test_walk_plain_matches_jax_multi_run(bitdepth, stacked):
    """:func:`walk_plain` on three levels of prediction units against the
    reference's fused run of levels, dav1d_tpu/recon/device_intra.
    _multi_run_program: one (w, h) key per size, each level's units
    padded to a power of two with the reference's sentinel rows."""
    import jax.numpy as jnp

    from dav1d_tpu.recon.device_intra import _multi_run_program

    H, W = 64, 64
    ph = 32 if stacked else H
    sizes = [(4, 4), (8, 4), (4, 8), (8, 8)] if stacked else \
        [(4, 4), (8, 8), (16, 8), (4, 16)]
    rng = np.random.default_rng(bitdepth + stacked)
    canvas, resid = _canvas(rng, H, W, bitdepth), _resid(rng, H, W,
                                                         bitdepth)
    J, T, C, pidx = walk_schedule(rng, H, W, ph, H, W, 3, sizes, bitdepth,
                                  kinds=(tip.KIND_PRED,))
    got = tip.walk_plain(
        torch.from_numpy(canvas.copy()), None, torch.from_numpy(resid),
        torch.from_numpy(J), torch.from_numpy(T), torch.from_numpy(C), None,
        ph, 0, 0, bitdepth).numpy()
    ends = np.cumsum(C)
    levels = [J[e - n:e] for e, n in zip(ends, C)]
    keyspecs, parts = [], []
    for w, h in sorted({tuple(r) for r in J[:, [tip.J_W, tip.J_H]]}):
        per = [L[(L[:, tip.J_W] == w) & (L[:, tip.J_H] == h)]
               for L in levels]
        capg = 1 << max(0, (max(len(u) for u in per) - 1).bit_length())
        metas = np.zeros((len(levels), capg, R_PREDROW), np.int32)
        metas[:, :, 0], metas[:, :, 4], metas[:, :, 6] = H, 1, 1
        for g, u in enumerate(per):
            metas[g, :len(u)] = _ref_meta(u)
        keyspecs.append((int(w), int(h), capg))
        parts.append(metas)
    prog = _multi_run_program((H, W), ph, bitdepth, tuple(keyspecs),
                              len(levels))
    want = np.asarray(prog(jnp.asarray(canvas), jnp.asarray(resid),
                           jnp.asarray(np.concatenate(parts, axis=1))))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fault", ["unsorted", "counts", "kind", "tags"])
def test_walk_refuses_a_bad_table(fault):
    """The wrapper checks the table on CPU tensors (:func:`check_walk`):
    tags out of level order, counts that do not sum to the units, a kind
    outside 0..2, a tag count that is not the job count."""
    rng = np.random.default_rng(6)
    H = W = 64
    canvas, resid = _canvas(rng, H, W, 8), _resid(rng, H, W, 8)
    J, T, C, pidx = walk_schedule(rng, H, W, H, H, W, 3, [(4, 4), (8, 8)],
                                  8)
    tip.check_walk(T, C, len(J))
    T, C = T.copy(), C.copy()
    if fault == "unsorted":
        T[[0, -1]] = T[[-1, 0]]
    elif fault == "counts":
        C[-1] += 1
    elif fault == "kind":
        T[-1] |= 3
    else:
        T = T[:-1]
    match = {"unsorted": "not sorted", "counts": "counts",
             "kind": "kind outside", "tags": "tags"}[fault]
    with pytest.raises(ValueError, match=match):
        tip.walk(torch.from_numpy(canvas), None, torch.from_numpy(resid),
                 torch.from_numpy(J), torch.from_numpy(T),
                 torch.from_numpy(C), torch.from_numpy(pidx), H, 0, 0, 8)


def test_walk_ctas():
    assert tip.walk_ctas([7]) == 7
    assert tip.walk_ctas([3, 5, 2, 9]) == 11
    assert tip.walk_ctas([]) == 0


# ---- the schedule --------------------------------------------------------

def encode_intra_case(tmp_path, name):
    """A tests/test_device_intra.CASES stream, encoded as that file does;
    returns its bytes."""
    from aom_enc import AomEncoder, write_ivf_packets
    from test_device_intra import CASES

    kw = dict(CASES[name])
    n = kw.pop("n")
    w, h = kw.pop("w"), kw.pop("h")
    gen = kw.pop("frames")
    bitdepth = kw.pop("bitdepth", 8)
    fmt = kw.pop("fmt", "420")
    mono = kw.pop("monochrome", False)
    enc = AomEncoder(width=w, height=h, usage="good", kf_max_dist=1, lag=0,
                     bitdepth=bitdepth, monochrome=mono, fmt=fmt, **kw)
    frames = gen(n, w, h, bitdepth=bitdepth)
    if fmt == "444":
        frames = [[f[0], np.repeat(np.repeat(f[1], 2, 0), 2, 1)[:h, :w],
                   np.repeat(np.repeat(f[2], 2, 0), 2, 1)[:h, :w]]
                  for f in frames]
    if mono:
        frames = [[f[0]] for f in frames]
    pkts = enc.encode(frames)
    enc.close()
    path = tmp_path / f"{name}.ivf"
    write_ivf_packets(path, pkts, w, h)
    return path.read_bytes()


def _cells_read(r, kind, ph):
    """The canvas cells (row, col) a unit's prediction reads (the edge
    segments its mode needs, each read clamped into its own ph-row
    half)."""
    from dav1d_tpu_torch.recon.ipred import EDGE_NEEDS

    dy, dx, w, h, hl, ht, pxl, pxbl, pxt, pxtr = (int(v) for v in r[:10])
    if kind == "pal":
        return []
    needs = EDGE_NEEDS[int(r[tip.J_MODE])]
    cells = []
    if needs[0]:
        if hl:
            rows = list(range(dy, dy + pxl)) + list(range(dy + h,
                                                          dy + h + pxbl))
            cells += [(y, dx - 1) for y in rows]
        elif ht:
            cells.append((dy - 1, dx))
    if needs[1]:
        if ht:
            cols = list(range(dx, dx + pxt)) + list(range(dx + w,
                                                          dx + w + pxtr))
            cells += [(dy - 1, x) for x in cols]
        elif hl:
            cells.append((dy, dx - 1))
    if needs[2] or (kind == "pred" and r[tip.J_Z2F]):
        if hl or ht:
            cells.append((dy - ht, dx - hl))
    lo = (dy // ph) * ph
    return [(min(max(y, lo), lo + ph - 1), x) for y, x in cells]


@pytest.mark.parametrize("name", ["angular_cfl", "screen_palette",
                                  "i444_odd", "tiles"])
def test_levels_read_only_earlier_levels(tmp_path, name, monkeypatch):
    """No unit reads a cell written at its own level or later, on the
    schedules of the tests/test_device_intra.CASES streams: what lets
    each level's launch write the canvas in place."""
    from dav1d_tpu_torch.containers import read_ivf
    from dav1d_tpu_torch.decoder import Decoder, Settings
    from dav1d_tpu_torch.recon import device_intra

    seen = []
    enumerate_units = device_intra._enumerate_units

    def recording(f, glue, ranges):
        sched, maps = enumerate_units(f, glue, ranges)
        seen.append((sched, maps, [p.shape[0] for p in f.planes[:2]]))
        return sched, maps

    monkeypatch.setattr(device_intra, "_enumerate_units", recording)
    dec = Decoder(Settings(two_pass=True, max_frame_delay=4), device="cpu",
                  device_intra=True)
    for tu, _ in read_ivf(encode_intra_case(tmp_path, name)):
        dec.send_data(tu)
        while dec.get_picture() is not None:
            pass
    n_units = 0
    for sched, maps, heights in seen:
        assert sched is not None
        for ch, levels in enumerate(sched):
            ph = heights[ch]
            lvl = maps[ch].lvl
            for level, kinds in levels.items():
                for kind, units in kinds.items():
                    for r in units:
                        n_units += 1
                        for y, x in _cells_read(r, kind, ph):
                            if 0 <= y and 0 <= x < lvl.shape[1] * 4:
                                assert lvl[y >> 2, x >> 2] < level, (
                                    name, ch, kind, r, (y, x))
    assert n_units > 0


@pytest.mark.parametrize("name", ["angular_cfl", "screen_palette", "hbd10",
                                  "tiles"])
def test_walk_host_replays_the_decode(kernel_on_host, tmp_path, name,
                                      monkeypatch):
    """The walks of a tests/test_device_intra.CASES decode with device
    intra on the CPU (their output is what test_torch_decode holds
    against the JAX host tier): the host build of the walk, from each
    walk's input canvas, in ticket order and permuted within each level,
    gives the walk's output exactly."""
    from dav1d_tpu_torch.containers import read_ivf
    from dav1d_tpu_torch.decoder import Decoder, Settings

    seen = []
    walk = tip.walk

    def recording(canvas, luma, resid, jobs, tags, counts, pidx, *rest,
                  **kw):
        before = canvas.clone()
        lumac = (canvas if luma is None else luma).clone()
        out = walk(canvas, luma, resid, jobs, tags, counts, pidx, *rest,
                   **kw)
        # copies: on the CPU the uploads share the decoder's host buffers
        seen.append((before.numpy(), lumac.numpy(), resid.numpy().copy(),
                     jobs.numpy().copy(), tags.numpy().copy(),
                     counts.numpy().copy(),
                     np.zeros(1, np.uint8) if pidx is None else
                     pidx.numpy().copy(), *rest, out.clone().numpy()))
        return out

    monkeypatch.setattr(tip, "walk", recording)
    dec = Decoder(Settings(two_pass=True, max_frame_delay=4), device="cpu",
                  device_intra=True)
    for tu, _ in read_ivf(encode_intra_case(tmp_path, name)):
        dec.send_data(tu)
        while dec.get_picture() is not None:
            pass
    assert seen
    rng = np.random.default_rng(len(name))
    for *args, want in seen:
        tags = args[4]
        for order in (_tickets(tags), _tickets(tags, rng)):
            rc, got = _walk_host(kernel_on_host, *args, order)
            assert rc == 0
            np.testing.assert_array_equal(got, want)
