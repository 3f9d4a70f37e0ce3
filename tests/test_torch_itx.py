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
    order, jobs, _, n_out = titx.job_table(
        np.arange(B) * nc, np.full(B, tx), np.full(B, txtp), np.zeros(B),
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
    order, jobs, groups, n_out = titx.job_table(offs, txs, tps, eobs,
                                                len(arena))
    assert np.array_equal(groups, titx.group_list(jobs[:, titx.J_TX]))
    # sorted by (tx, txtp) then eob; offsets a prefix sum of h*w
    key = jobs[:, titx.J_TX].astype(np.int64) * 32 + jobs[:, titx.J_TXTP]
    assert (np.diff(key) >= 0).all()
    same = np.diff(key) == 0
    assert (np.diff(eobs[order])[same] >= 0).all()
    sizes = [titx._txinfo(t)[0] * titx._txinfo(t)[1] for t in txs[order]]
    assert np.array_equal(jobs[:, titx.J_OUT], np.cumsum(sizes) - sizes)
    assert n_out == sum(sizes)
    out = titx.itx_frame(torch.from_numpy(arena), torch.from_numpy(jobs),
                         torch.from_numpy(groups), n_out, bd)
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
    order, jobs, groups, n_out = titx.job_table([], [], [], [], 0)
    assert jobs.shape == (0, titx.JOB_COLS) and n_out == 0
    assert groups.shape == (0, titx.GROUP_COLS)


def test_wrapper_checks():
    cf = torch.zeros(64, dtype=torch.int32)
    _, jobs, groups, n_out = titx.job_table([0], [0], [0], [0], 64)
    jobs, groups = torch.from_numpy(jobs), torch.from_numpy(groups)
    with pytest.raises(ValueError, match="bitdepth"):
        titx.itx_frame(cf, jobs, groups, n_out, 9)
    with pytest.raises(TypeError, match="cf"):
        titx.itx_frame(cf.long(), jobs, groups, n_out, 8)
    with pytest.raises(ValueError, match="jobs"):
        titx.itx_frame(cf, jobs[:, :3].contiguous(), groups, n_out, 8)
    with pytest.raises(ValueError, match="groups"):
        titx.itx_frame(cf, jobs, groups[:, :2].contiguous(), n_out, 8)
    with pytest.raises(TypeError, match="groups"):
        titx.itx_frame(cf, jobs, groups.long(), n_out, 8)
    with pytest.raises(ValueError, match="1-D"):
        titx.itx_frame(cf.reshape(8, 8), jobs, groups, n_out, 8)
    assert titx.itx_frame(cf, jobs, groups, n_out, 8).abs().max() == 0


# group rows (first, count, tx) that group_list cannot make for the
# jobs of tx sizes 0, 0, 0, 1, 1 (4x4, 4x4, 4x4, 8x8, 8x8); the kernel
# stops on them and the wrapper's CPU path raises
BAD_GROUPS = {
    "tx of another size": [[0, 3, 0], [3, 2, 2]],
    "more than LANES / w": [[0, 3, 0], [3, 2, 4]],
    "crossing a tx size": [[0, 4, 0], [4, 1, 1]],
    "no jobs": [[0, 3, 0], [3, 0, 1], [3, 2, 1]],
    "a job left out": [[0, 2, 0], [3, 2, 1]],
    "a job twice": [[0, 3, 0], [2, 1, 0], [3, 2, 1]],
    "tx out of range": [[0, 3, 0], [3, 2, 19]],
}


@pytest.mark.parametrize("bad", list(BAD_GROUPS))
def test_wrapper_refuses_bad_groups(bad):
    cf = torch.zeros(5 * 64, dtype=torch.int32)
    _, jobs, groups, n_out = titx.job_table(np.arange(5) * 64,
                                            [0, 0, 0, 1, 1], [0] * 5,
                                            [0] * 5, len(cf))
    jobs = torch.from_numpy(jobs)
    assert groups.tolist() == [[0, 3, 0], [3, 2, 1]]
    titx.itx_frame(cf, jobs, torch.from_numpy(groups), n_out, 8)
    g = torch.tensor(BAD_GROUPS[bad], dtype=torch.int32)
    if bad == "more than LANES / w":  # 64-wide jobs: one a group
        g[1, titx.G_TX] = 4
        jobs[3:, titx.J_TX] = 4
    with pytest.raises(ValueError, match="groups"):
        titx.itx_frame(cf, jobs, g, n_out, 8)


_HARNESS = r"""
#include <stdint.h>
#include <string.h>
#include "itx_core.cuh"

template <typename T, typename O>
static void run_group(const int* cf, const int* jobs, const int* G, O* out,
                      int bitdepth) {
    static itx::Group<T> s;
    memset(&s, 0x5A, sizeof s);  // shared memory starts undefined
    const int first = G[itx::G_FIRST];
    const itx::Size z = itx::size_of(G[itx::G_TX], G[itx::G_COUNT]);
    itx::Clip<T> rcl, ccl;
    itx::clips<T>(bitdepth, rcl, ccl);
    const int nt = itx::LANES;  // the kernel's CTA; each loop is one phase
    for (int t = 0; t < nt; t++) itx::setup<T>(s, jobs, first, z, t, nt);
    for (int t = 0; t < nt; t++) itx::load<T>(s, cf, z, t, nt);
    for (int t = 0; t < nt; t++) itx::rows<T>(s, z, rcl, ccl, t, nt);
    for (int t = 0; t < nt; t++) itx::cols<T, O>(s, z, ccl, out, t, nt);
}

extern "C" void itx_frame_host(const int* cf, const int* jobs,
                               const int* groups, int n_groups, void* out,
                               int bitdepth) {
    for (int g = 0; g < n_groups; g++) {
        const int* G = groups + g * itx::GROUP_COLS;
        if (bitdepth == 12)
            run_group<long long, int32_t>(cf, jobs, G, (int32_t*)out,
                                          bitdepth);
        else
            run_group<int, int16_t>(cf, jobs, G, (int16_t*)out, bitdepth);
    }
}
"""


@pytest.fixture(scope="module")
def kernel_on_host(tmp_path_factory):
    """The kernel's arithmetic header built as host C++ (a ctypes
    function running every group's four phases for the CTA's 64 threads
    in turn)."""
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
                                   ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_void_p, ctypes.c_int]
    lib.itx_frame_host.restype = None
    return lib


def _host_vs_plain(lib, arena, cols, bd):
    """The job list through the host build of the kernel's phases and
    through the plain version; both residual buffers."""
    order, jobs, groups, n_out = titx.job_table(*cols, len(arena))
    titx.check_groups(jobs[:, titx.J_TX], groups)  # the kernel's invariant
    got = np.zeros(n_out, dtype=np.int16 if bd <= 10 else np.int32)
    lib.itx_frame_host(arena.ctypes.data, jobs.ctypes.data,
                       groups.ctypes.data, len(groups), got.ctypes.data, bd)
    want = titx.itx_frame_plain(torch.from_numpy(arena),
                                torch.from_numpy(jobs), n_out, bd).numpy()
    return got, want


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_kernel_source_on_host(kernel_on_host, bd):
    rng = np.random.default_rng(300 + bd)
    arena, cols, _ = _frame(rng, bd, per=2)
    got, want = _host_vs_plain(kernel_on_host, arena, cols, bd)
    assert np.array_equal(got, want)


SPARSE = ("rows 0, 1/3 and last", "last row, last column", "dc only",
          "one middle row")


def _sparse_frame(rng, bd, per=5):
    """Sparse blocks of every valid pair, ``per`` of each pattern of
    SPARSE (zero rows between nonzero rows; a lone coefficient in the last
    column of the last coded row; DC only; one nonzero row in the middle),
    shuffled, in an arena with gaps.  Per tx size the job count is no
    multiple of the group size, so the last group of each size is partly
    full and every size's last group ends where the tx size changes.
    Returns (arena, (cf_off, tx, txtp, eob))."""
    chunks, offs, txs, tps, eobs = [], [], [], [], []
    pos = 0
    for tx, txtp in PAIRS:
        w, h, _, _ = titx._txinfo(tx)
        sw, sh = min(w, 32), min(h, 32)
        cmax = 1 << (bd + 1 if txtp == WHT else bd + 7)
        for pat in range(len(SPARSE)):
            for _ in range(per + (tx % 3 == 0)):
                cf = np.zeros((sw, sh), np.int64)  # [x][y]
                vals = rng.integers(-cmax, cmax, (sw, sh))
                vals[vals == 0] = 1
                if pat == 0:
                    rows = [0, max(1, sh // 3), sh - 1]
                    cf[:, rows] = vals[:, rows]
                elif pat == 1:
                    cf[sw - 1, sh - 1] = vals[0, 0]
                elif pat == 2:
                    cf[0, 0] = vals[0, 0]
                else:
                    y = int(rng.integers(1, sh - 1))
                    cf[int(rng.integers(1, sw)), y] = vals[0, 0]
                    cf[:, y] *= rng.random(sw) < 0.5
                row = cf.reshape(-1).astype(np.int32)
                gap = int(rng.integers(0, 5))
                chunks += [np.zeros(gap, np.int32), row]
                offs.append(pos + gap)
                pos += gap + len(row)
                txs.append(tx)
                tps.append(txtp)
                eobs.append(int(np.flatnonzero(row).max(initial=0)))
    perm = rng.permutation(len(offs))
    return (np.concatenate(chunks),
            [np.asarray(c)[perm] for c in (offs, txs, tps, eobs)])


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_kernel_sparse_rows_on_host(kernel_on_host, bd):
    """The row flags: only the flagged rows are transformed, and rows
    after zero rows and coefficients beyond the first column flag their
    row."""
    rng = np.random.default_rng(500 + bd)
    arena, cols = _sparse_frame(rng, bd)
    got, want = _host_vs_plain(kernel_on_host, arena, cols, bd)
    assert np.array_equal(got, want), \
        f"mismatch at {np.flatnonzero(got != want)[:8]}"
    assert np.count_nonzero(want) > len(cols[0])  # not a trivial frame


def test_group_list_covers_jobs():
    """Each job lands in exactly one group, no group mixes tx sizes, a
    group holds at most LANES / w jobs and only the last group of a run
    of one size is partly full."""
    rng = np.random.default_rng(4)
    for n in (0, 1, 17, 300, 2000):
        tx = np.sort(rng.integers(0, titx.N_TX, n))
        if n == 300:  # one long run
            tx[:] = 0
        g = titx.group_list(tx)
        assert g.dtype == np.int32 and g.shape == (len(g), titx.GROUP_COLS)
        first, cnt = g[:, titx.G_FIRST], g[:, titx.G_COUNT]
        covered = np.repeat(first, cnt) + np.arange(cnt.sum()) \
            - np.repeat(np.cumsum(cnt) - cnt, cnt)
        assert np.array_equal(covered, np.arange(n))
        assert np.array_equal(g[:, titx.G_TX], tx[first])
        for f, c in zip(first.tolist(), cnt.tolist()):
            assert c >= 1 and len(set(tx[f:f + c].tolist())) == 1
            w = titx._txinfo(int(tx[f]))[0]
            assert c <= titx.LANES // w
            end = f + c
            if c < titx.LANES // w:
                assert end == n or tx[end] != tx[f]
    # on a frame's job table
    arena, cols, _ = _frame(np.random.default_rng(5), 8, per=3)
    _, jobs, groups, _ = titx.job_table(*cols, len(arena))
    assert groups[:, titx.G_COUNT].sum() == len(jobs)
    for f, c, t in groups.tolist():
        assert set(jobs[f:f + c, titx.J_TX].tolist()) == {t}


def _bank_ways(addrs):
    """Shared-memory wavefronts of one warp's 32-bit accesses: the most
    distinct words that fall in one of the 32 banks."""
    banks = {}
    for a in set(addrs):
        banks.setdefault(a % 32, set()).add(a)
    return max(len(v) for v in banks.values())


@pytest.mark.parametrize("tx", range(19))
def test_tile_bank_conflicts(tx):
    """The tile layout's bank conflicts, counted per warp of a full group
    at 32-bit elements (csrc/itx_core.cuh): the load's stores at most 2
    ways (1 when the coded height is 32), the row pass (every row
    flagged) at most 2, the column pass none."""
    w, h, _, _ = titx._txinfo(tx)
    sh = min(h, 32)
    S, n = sh + 1, titx.LANES // w

    def warps(count, addr):
        return [_bank_ways([addr(i) for i in range(b, min(b + 32, count))])
                for b in range(0, count, 32)]

    def load(i):
        j, k = divmod(i, w * sh)
        x, y = divmod(k, sh)
        return (j * w + x) * S + y

    def row(r):
        j, y = divmod(r, sh)
        return j * w * S + y

    assert max(warps(n * w * sh, load)) == (1 if sh == 32 else 2)
    assert max(warps(n * sh, row)) <= 2
    assert max(warps(n * w, lambda i: i * S)) == 1
