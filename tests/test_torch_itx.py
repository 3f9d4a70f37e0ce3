"""dav1d_tpu_torch inverse transforms (ops/itx.py) vs the JAX package,
bit-exact.

* the plain frame transform vs dav1d_tpu.ops.itx.itx_batch_np (numpy,
  the shared 1-D kernels) for every valid (tx, txtp) pair, WHT_WHT
  included, at bit depths 8/10/12; the coefficients are random within
  +-(1 << (bd + 7)) plus rows at the extremes, which drive the row and
  column clips (WHT_WHT, the lossless transform, gets coefficients whose
  residuals are pixel differences: +-(1 << (bd + 1)));
* the same vs dav1d_tpu.ops.itx.itx_batch (XLA on the CPU; at 12-bit the
  int32 split forms) for every size at a rotating bit depth with three
  types each, as tests/test_ops_itx.py samples them;
* the same vs the Pallas kernel (ops/pallas_itx.itx_batch_pallas in
  interpret mode, in a single-device subprocess) on a few (tx, txtp, bd);
* a frame-like job list mixing every pair, shuffled, through the wrapper
  itx_frame on CPU tensors: each block's residuals at its offset; the
  job table's checks; the arena is never written;
* the CUDA kernel's arithmetic (csrc/itx_core.cuh, which compiles as
  plain C++ too) built on the host with the C++ compiler and run thread
  by thread, phase by phase, against the plain version on the same job
  lists.  The kernel itself runs on the card in chip_smoke.py.

Tolerance: exact (integer codec)."""

import ctypes
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dav1d_tpu.ops import itx as ritx
from dav1d_tpu_torch.ops import itx as titx

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "dav1d_tpu_torch" / "csrc"
WHT = 16
PAIRS = [(tx, tp) for tx in range(titx.N_TX) for tp in range(titx.N_TXTP)
         if titx.valid_pair(tx, tp)]


def _coefs(rng, tx, txtp, bd, n):
    """(n, sw*sh) int32 coefficients: random, then rows at the extremes
    (all max, all min, mixed signs) and a DC-only row."""
    w, h, _, _ = titx._txinfo(tx)
    nc = min(w, 32) * min(h, 32)
    cmax = 1 << (bd + 1 if txtp == WHT else bd + 7)
    cf = rng.integers(-cmax, cmax, (n, nc)).astype(np.int32)
    cf[0] = cmax - 1
    cf[1] = -cmax
    cf[2] = np.where(rng.random(nc) < 0.5, cmax - 1, -cmax)
    cf[3, 1:] = 0
    return cf


def _plain(cfs, tx, txtp, bd):
    """(B, sw*sh) blocks of one pair through itx_frame_plain -> (B, h, w)
    in input order."""
    B, nc = cfs.shape
    arena = torch.from_numpy(cfs.reshape(-1).copy())
    order, jobs, n_out = titx.job_table(np.arange(B) * nc, np.full(B, tx),
                                        np.full(B, txtp), np.zeros(B),
                                        arena.numel())
    out = titx.itx_frame_plain(arena, torch.from_numpy(jobs), n_out, bd)
    w, h, _, _ = titx._txinfo(tx)
    res = np.empty((B, h, w), dtype=np.int64)
    res[order] = out.numpy().astype(np.int64).reshape(B, h, w)
    return res


def test_pairs():
    """194 valid pairs: 16 types at 4x4-16x16-class sizes where ADST
    reaches, identity up to 32, DCT alone at 64, WHT at 4x4 only."""
    assert len(PAIRS) == 194
    assert (0, WHT) in PAIRS and (1, WHT) not in PAIRS
    assert not titx.valid_pair(4, 9)       # IDTX 64x64
    assert not titx.valid_pair(3, 1)       # ADST_DCT 32x32
    assert titx.valid_pair(3, 9) and titx.valid_pair(4, 0)


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("tx", range(19))
def test_plain_matches_numpy(tx, bd):
    rng = np.random.default_rng(1000 * bd + tx)
    for t, txtp in PAIRS:
        if t != tx:
            continue
        cf = _coefs(rng, tx, txtp, bd, 7)
        orig = cf.copy()
        want = ritx.itx_batch_np(cf, tx, txtp, bd)
        got = _plain(cf, tx, txtp, bd)
        assert np.array_equal(cf, orig)
        assert np.array_equal(got, want), (tx, txtp, bd)
        if txtp != WHT:
            # the residual bound of the narrow storage
            assert np.abs(got).max() <= (8192 if bd <= 10 else 32768)


@pytest.mark.parametrize("tx", range(19))
def test_plain_matches_xla(tx):
    """Every size at a rotating bit depth with three types (first, middle,
    last valid), against the JAX device tier's XLA program."""
    rng = np.random.default_rng(50 + tx)
    bd = (8, 10, 12)[tx % 3]
    types = [tp for t, tp in PAIRS if t == tx and tp != WHT]
    for txtp in dict.fromkeys([types[0], types[len(types) // 2],
                               types[-1]]):
        cf = _coefs(rng, tx, txtp, bd, 5)
        want = np.asarray(ritx.itx_batch(cf, tx, txtp, bd)).astype(np.int64)
        assert np.array_equal(_plain(cf, tx, txtp, bd), want), (tx, txtp,
                                                                 bd)


_PALLAS = r"""
import sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from dav1d_tpu.ops.pallas_itx import itx_batch_pallas
from test_torch_itx import _coefs, _plain
rng = np.random.default_rng(9)
n = 0
for tx, txtp, bd in ((0, 0, 8), (0, 16, 8), (1, 9, 10), (5, 3, 8),
                     (7, 15, 10), (13, 12, 8)):
    cf = _coefs(rng, tx, txtp, bd, 9)
    got = np.asarray(itx_batch_pallas(cf, tx, txtp, bd, interpret=True))
    assert np.array_equal(_plain(cf, tx, txtp, bd), got), (tx, txtp, bd)
    n += 1
print(f"PALLAS_PARITY_OK {n}")
"""


def test_plain_matches_pallas_interpret():
    """Against the TPU kernel itself, in interpret mode on one CPU device
    (eight virtual devices make interpret mode very slow)."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _PALLAS, str(REPO)],
                       cwd=Path(__file__).resolve().parent, env=env,
                       capture_output=True, text=True, timeout=540)
    assert r.returncode == 0, r.stdout + r.stderr[-3000:]
    assert "PALLAS_PARITY_OK 6" in r.stdout, r.stdout


def _frame(rng, bd, per=3):
    """A frame-like job list: ``per`` blocks of every valid pair,
    shuffled, in an arena with gaps between blocks.  Returns (arena,
    (cf_off, tx, txtp, eob), expected residual blocks in input order)."""
    offs, txs, tps, eobs, want, chunks = [], [], [], [], [], []
    pos = 0
    for tx, txtp in PAIRS:
        cf = _coefs(rng, tx, txtp, bd, max(per, 4))[:per]
        want += list(ritx.itx_batch_np(cf, tx, txtp, bd))
        for row in cf:
            gap = int(rng.integers(0, 5))
            chunks += [np.zeros(gap, np.int32), row]
            offs.append(pos + gap)
            pos += gap + len(row)
            txs.append(tx)
            tps.append(txtp)
            eobs.append(int(rng.integers(0, len(row))))
    perm = rng.permutation(len(offs))
    cols = [np.asarray(c)[perm] for c in (offs, txs, tps, eobs)]
    return (np.concatenate(chunks), cols, [want[i] for i in perm])


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_frame_job_list(bd):
    rng = np.random.default_rng(77 + bd)
    arena, (offs, txs, tps, eobs), want = _frame(rng, bd)
    orig = arena.copy()
    order, jobs, n_out = titx.job_table(offs, txs, tps, eobs, len(arena))
    # sorted by (tx, txtp) then eob; offsets a prefix sum of h*w
    key = jobs[:, titx.J_TX].astype(np.int64) * 32 + jobs[:, titx.J_TXTP]
    assert (np.diff(key) >= 0).all()
    same = np.diff(key) == 0
    assert (np.diff(eobs[order])[same] >= 0).all()
    sizes = [titx._txinfo(t)[0] * titx._txinfo(t)[1] for t in txs[order]]
    assert np.array_equal(jobs[:, titx.J_OUT], np.cumsum(sizes) - sizes)
    assert n_out == sum(sizes)
    out = titx.itx_frame(torch.from_numpy(arena), torch.from_numpy(jobs),
                         n_out, bd)
    assert out.dtype == (torch.int16 if bd <= 10 else torch.int32)
    assert np.array_equal(arena, orig)
    flat = out.numpy()
    for j, i in enumerate(order):
        w, h, _, _ = titx._txinfo(int(txs[i]))
        o = int(jobs[j, titx.J_OUT])
        assert np.array_equal(flat[o:o + h * w].reshape(h, w), want[i]), (
            j, int(txs[i]), int(tps[i]))


def test_job_table_checks():
    ok = dict(cf_off=[0, 16], tx=[0, 0], txtp=[0, WHT], eob=[0, 3], n_cf=32)
    titx.job_table(**ok)
    with pytest.raises(ValueError, match=r"invalid .* \[\(1, 16\)\]"):
        titx.job_table(**{**ok, "tx": [0, 1], "n_cf": 100})  # WHT 8x8
    with pytest.raises(ValueError, match=r"invalid .* \[\(4, 9\)\]"):
        titx.job_table([0], [4], [9], [0], 4096)            # IDTX 64x64
    with pytest.raises(ValueError, match=r"invalid .* \[\(3, 1\)\]"):
        titx.job_table([0], [3], [1], [0], 4096)            # ADST 32
    with pytest.raises(ValueError, match="invalid"):
        titx.job_table([0], [19], [0], [0], 4096)
    with pytest.raises(ValueError, match="outside the arena"):
        titx.job_table(**{**ok, "n_cf": 31})
    with pytest.raises(ValueError, match="outside the arena"):
        titx.job_table(**{**ok, "cf_off": [-1, 16]})
    order, jobs, n_out = titx.job_table([], [], [], [], 0)
    assert jobs.shape == (0, titx.JOB_COLS) and n_out == 0


def test_wrapper_checks():
    cf = torch.zeros(64, dtype=torch.int32)
    _, jobs, n_out = titx.job_table([0], [0], [0], [0], 64)
    jobs = torch.from_numpy(jobs)
    with pytest.raises(ValueError, match="bitdepth"):
        titx.itx_frame(cf, jobs, n_out, 9)
    with pytest.raises(TypeError, match="cf"):
        titx.itx_frame(cf.long(), jobs, n_out, 8)
    with pytest.raises(ValueError, match="jobs"):
        titx.itx_frame(cf, jobs[:, :3].contiguous(), n_out, 8)
    with pytest.raises(ValueError, match="1-D"):
        titx.itx_frame(cf.reshape(8, 8), jobs, n_out, 8)
    assert titx.itx_frame(cf, jobs, n_out, 8).abs().max() == 0


_HARNESS = r"""
#include <stdint.h>
#include "itx_core.cuh"

template <typename T, typename O>
static void run_job(const int* cf, const int* J, O* out, int bitdepth) {
    static T tile[itx::TILE_ELEMS];
    const itx::Geom g = itx::geom(J[itx::J_TX], J[itx::J_TXTP]);
    itx::Clip<T> rcl, ccl;
    itx::clips<T>(bitdepth, rcl, ccl);
    const int nt = 64;  // the kernel's CTA; each loop is one phase
    for (int t = 0; t < nt; t++) itx::load<T>(tile, cf + J[itx::J_CF], g, t, nt);
    for (int t = 0; t < nt; t++) itx::rows<T>(tile, g, rcl, ccl, t, nt);
    for (int t = 0; t < nt; t++) itx::cols<T>(tile, g, ccl, t, nt);
    for (int t = 0; t < nt; t++)
        itx::store<T, O>(tile, out + J[itx::J_OUT], g, t, nt);
}

extern "C" void itx_frame_host(const int* cf, const int* jobs, int n_jobs,
                               void* out, int bitdepth) {
    for (int j = 0; j < n_jobs; j++) {
        const int* J = jobs + j * itx::JOB_COLS;
        if (bitdepth == 12)
            run_job<long long, int32_t>(cf, J, (int32_t*)out, bitdepth);
        else
            run_job<int, int16_t>(cf, J, (int16_t*)out, bitdepth);
    }
}
"""


@pytest.fixture(scope="module")
def kernel_on_host(tmp_path_factory):
    """The kernel's arithmetic header built as host C++ (a ctypes
    function running every job's four phases for 64 threads in turn)."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no C++ compiler")
    d = tmp_path_factory.mktemp("itx_host")
    (d / "harness.cpp").write_text(_HARNESS)
    so = d / "libitx_host.so"
    r = subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                        "-I", str(CSRC), "-o", str(so),
                        str(d / "harness.cpp")],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lib = ctypes.CDLL(str(so))
    lib.itx_frame_host.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_void_p,
                                   ctypes.c_int]
    lib.itx_frame_host.restype = None
    return lib


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_kernel_source_on_host(kernel_on_host, bd):
    rng = np.random.default_rng(300 + bd)
    arena, (offs, txs, tps, eobs), _ = _frame(rng, bd, per=2)
    order, jobs, n_out = titx.job_table(offs, txs, tps, eobs, len(arena))
    got = np.zeros(n_out, dtype=np.int16 if bd <= 10 else np.int32)
    kernel_on_host.itx_frame_host(arena.ctypes.data, jobs.ctypes.data,
                                  len(jobs), got.ctypes.data, bd)
    want = titx.itx_frame_plain(torch.from_numpy(arena),
                                torch.from_numpy(jobs), n_out, bd).numpy()
    assert np.array_equal(got, want)
