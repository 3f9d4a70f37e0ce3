"""dav1d_tpu_torch's multi-device decode (mesh.Mesh, Settings.mesh) on the
CPU, against the port's single-device decode and the JAX package.

* band units: recon/mesh_lf.deblock_plane_mesh and
  recon/mesh_cdef.filter_plane_mesh (with dir_maps_mesh) on random planes
  with random tx-tiling edges (tests/test_pallas_lf._gen_edges) and unit
  strengths equal the port's whole-plane plain versions
  (ops/lf.deblock_plane, ops/cdef.cdef_filter_plane_resident over
  ops/cdef.find_dir_maps, which tests/test_torch_lf.py and
  test_torch_cdef.py hold against the JAX package), with 1, 2, 3 and 8
  bands: a ragged last band (200 luma rows in 64-row bands) and bands
  wholly past the filtered rows and the allocation; luma, 4:2:0, 4:2:2
  and 4:4:4 chroma planes; bit depths 8, 10, 12;
* the itx shares (pipeline.itx_shares): the blocks cut by arena range,
  each share's job table transformed on its arena slice, equal the
  frame's one call block by block;
* decodes: tests/test_multichip.py's two 256x192 streams (2x2 tiles,
  inter; super-res + loop restoration), made here with tools/aom_enc.py,
  through the port with Mesh([cpu] * 2) and Mesh([cpu] * 8): md5 equal
  to the port's single-device decode and to the JAX package's host tier
  (DAV1D_TPU_DEVICE=0), and on the restoration stream to the JAX
  package's own mesh decode over conftest's 8 virtual CPU devices; the
  four committed layout streams (4:2:2, 4:4:4 10-bit, 12-bit,
  monochrome) with a 2-band mesh against md5.json;
* worker threads: the committed 10-bit stream at n_threads 0, 4 and 9,
  and with a 2-band mesh at n_threads 4, against md5.json;
* two processes (tests/test_multihost.py's form): two ranks form a gloo
  group, each with one CPU band, and decode the inter stream; both print
  the single-device md5.  Each first builds a mesh whose ranks disagree
  on the band count, which both refuse;
* refusals: a mesh whose first device is not the decoder's; a CUDA mesh
  without CUDA; a process-group mesh with worker threads;
* devrt.launch's count holds when more threads than cores launch at
  once (the decoder's worker threads launch kernels).

Tolerance: exact (md5s, array equality)."""

import hashlib
import json
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_pallas_lf import _edge_lists, _gen_edges
from test_torch_decode import _device_env

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
from aom_enc import AomEncoder, gradient_frames, write_ivf_packets  # noqa

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "dav1d_tpu_torch" / "data"
CPU = torch.device("cpu")
BANDS = [1, 2, 3, 8]
# (name, luma, ss_hor, ss_ver): the plane kinds of the layouts
KINDS = [("luma", True, 0, 0), ("420", False, 1, 1), ("422", False, 1, 0),
         ("444", False, 0, 0)]
# luma filtered rows and columns, and the allocation's rows
PH, PW, ALLOC_H = 200, 96, 208


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the suite's workers share the machine's cores
    (tests/test_torch_decode.py _port_md5)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh(n):
    from dav1d_tpu_torch.mesh import Mesh

    return Mesh([CPU] * n)


def _shape(kind):
    _, _, sh, sv = kind
    return PH >> sv, PW >> sh, ALLOC_H >> sv


@pytest.mark.parametrize("n", BANDS)
@pytest.mark.parametrize("bitdepth", [8, 10, 12])
@pytest.mark.parametrize("kind", KINDS, ids=lambda k: k[0])
def test_deblock_bands_match_whole_plane(kind, bitdepth, n):
    from dav1d_tpu.recon.lf import calc_eih
    from dav1d_tpu_torch.ops import lf as olf
    from dav1d_tpu_torch.recon.mesh_lf import deblock_plane_mesh
    from test_torch_lf import _smooth

    luma = kind[1]
    ph, pw, H = _shape(kind)
    rng = np.random.default_rng(bitdepth * 13 + n + ph)
    plane = np.zeros((H, pw), np.int32)
    plane[:ph] = _smooth(rng, ph, pw, bitdepth)
    plane[ph:] = rng.integers(0, 1 << bitdepth, (H - ph, pw))
    e_lut, i_lut = calc_eih(int(rng.integers(0, 8)))
    ed_v, ed_h = _gen_edges(rng, ph, pw, 2 if luma else 1)
    lv = _edge_lists(rng, ed_v, e_lut, i_lut)
    lh = _edge_lists(rng, ed_h, e_lut, i_lut)
    t = torch.from_numpy(plane)
    want = olf.deblock_plane(t, lv, lh, bitdepth, luma).numpy()
    got = deblock_plane_mesh(_mesh(n), t, lv, lh, ph, bitdepth,
                             luma).numpy()
    assert got.shape == plane.shape
    assert np.array_equal(got, want), \
        f"mismatch at {np.argwhere(got != want)[:6]}"
    assert not np.array_equal(want, plane)


@pytest.mark.parametrize("n", BANDS)
@pytest.mark.parametrize("bitdepth", [8, 10, 12])
@pytest.mark.parametrize("kind", KINDS, ids=lambda k: k[0])
def test_cdef_bands_match_whole_plane(kind, bitdepth, n):
    from dav1d_tpu_torch.ops import cdef as ocdef
    from dav1d_tpu_torch.recon.mesh_cdef import (dir_maps_mesh,
                                                 filter_plane_mesh)

    name, luma, sh, sv = kind
    ph, pw, H = _shape(kind)
    w, h = 8 >> sh, 8 >> sv
    rng = np.random.default_rng(bitdepth * 17 + n + ph + sh)
    s = bitdepth - 8
    luma_plane = rng.integers(0, 1 << bitdepth,
                              (ALLOC_H, PW)).astype(np.int32)
    plane = luma_plane if luma else \
        rng.integers(0, 1 << bitdepth, (H, pw)).astype(np.int32)
    nb, nc = -(-ph // h), -(-pw // w)
    on = rng.random((nb, nc)) < 0.7
    pri = (rng.integers(0, 16, (nb, nc)) * on) << s
    sec = (rng.integers(0, 5, (nb, nc)) * on) << s
    uy, ux = np.nonzero((pri | sec) != 0)
    damping = 3 + int(rng.integers(0, 4)) + s - (not luma)
    mesh = _mesh(n)
    lt = torch.from_numpy(luma_plane)
    dmap, vmap = ocdef.find_dir_maps(lt, bitdepth)
    maps = dir_maps_mesh(mesh, lt, PH, bitdepth)
    md, mv = maps[0]
    R8 = dmap.shape[0]
    assert md.shape[0] == n * mesh.band_rows(PH) // 8 >= R8
    assert torch.equal(md[:R8], dmap) and torch.equal(mv[:R8], vmap)
    assert not md[R8:].any() and not mv[R8:].any()
    args = (ph, pw, uy * h, ux * w, w, h, pri[uy, ux], sec[uy, ux],
            damping, bitdepth, luma, name == "422")
    t = torch.from_numpy(plane)
    want = ocdef.cdef_filter_plane_resident(t, dmap, vmap, *args).numpy()
    got = filter_plane_mesh(mesh, t, maps, *args).numpy()
    assert got.shape == plane.shape
    assert np.array_equal(got, want), \
        f"mismatch at {np.argwhere(got != want)[:6]}"
    assert not np.array_equal(want, plane)


@pytest.mark.parametrize("n", BANDS)
def test_itx_shares_match_one_call(n):
    """The blocks cut by arena range into shares (pipeline.itx_shares),
    each share's job table run on its own arena slice through
    ops/itx.itx_frame: every block's residuals equal those of the frame's
    one call, the shares hold every block once in arena ranges that
    tile the arena, and their coefficient words differ by at most one
    block's."""
    from dav1d_tpu_torch.ops import itx as oitx
    from dav1d_tpu_torch.pipeline import itx_shares

    rng = np.random.default_rng(n)
    valid = [(tx, tp) for tx in range(oitx.N_TX) for tp in range(oitx.N_TXTP)
             if oitx.valid_pair(tx, tp)]
    pick = rng.integers(0, len(valid), 300)
    tx = np.array([valid[i][0] for i in pick])
    txtp = np.array([valid[i][1] for i in pick])
    nc = oitx._luts()[2][tx]
    gap = rng.integers(0, 40, len(tx))
    off = np.cumsum(nc + gap) - nc
    n_cf = int(off[-1] + nc[-1] + 7)
    arena = (rng.integers(-300, 300, n_cf)
             * (rng.random(n_cf) < 0.2)).astype(np.int32)
    eob = rng.integers(0, 64, len(tx))
    perm = rng.permutation(len(tx))  # blocks in no arena order
    args = (off[perm], tx[perm], txtp[perm], eob[perm], n_cf)
    order, jobs, groups, n_out = oitx.job_table(*args)
    whole = oitx.itx_frame(torch.from_numpy(arena), torch.from_numpy(jobs),
                           torch.from_numpy(groups), n_out, 10).numpy()
    want = {}
    for j, row in enumerate(order):
        hw = oitx._luts()[1][jobs[j, oitx.J_TX]]
        o = jobs[j, oitx.J_OUT]
        want[row] = whole[o:o + hw]
    shares = itx_shares(*args, n)
    assert len(shares) == n
    assert [s[0] for s in shares][0] == 0 and shares[-1][1] == n_cf
    assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
    seen = []
    for lo, hi, rows, (o_b, jobs_b, groups_b, n_b) in shares:
        got = oitx.itx_frame(torch.from_numpy(arena[lo:hi]),
                             torch.from_numpy(jobs_b),
                             torch.from_numpy(groups_b), n_b, 10).numpy()
        for j, r in enumerate(rows[o_b]):
            hw = oitx._luts()[1][jobs_b[j, oitx.J_TX]]
            o = jobs_b[j, oitx.J_OUT]
            assert np.array_equal(got[o:o + hw], want[r])
            seen.append(r)
    assert sorted(seen) == list(range(len(tx)))
    words = [int(nc[perm][rows].sum()) for _, _, rows, _ in shares]
    assert max(words) - min(words) <= nc.max()


# tests/test_multichip.py's streams
STREAMS = {
    "tiles": dict(cpu_used=6, kf_max_dist=4,
                  options={"tile-columns": 1, "tile-rows": 1}),
    "superres_lr": dict(cpu_used=4, kf_max_dist=9999,
                        superres=(1, 16, 16, 63, 63)),
}


def _md5(dec, data):
    from dav1d_tpu_torch.containers import read_ivf

    h = hashlib.md5()
    n = 0
    for tu, _ in read_ivf(data):
        dec.send_data(tu)
        while (pic := dec.get_picture()) is not None:
            for pl in range(len(pic.planes)):
                h.update(pic.plane_bytes(pl))
            n += 1
    return n, h.hexdigest()


def _port_md5(data, mesh=None, n_threads=0):
    from dav1d_tpu_torch.decoder import Decoder, Settings

    dec = Decoder(Settings(two_pass=True, mesh=mesh, n_threads=n_threads),
                  device="cpu")
    got = _md5(dec, data)
    dec.close()
    return got


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """{name: (ivf path, JAX host-tier (frames, md5), port single-device
    (frames, md5))}."""
    from dav1d_tpu.decoder import Decoder, Settings

    d = tmp_path_factory.mktemp("mesh_streams")
    out = {}
    for name, kw in STREAMS.items():
        enc = AomEncoder(width=256, height=192, usage="good", q=40, lag=0,
                         **kw)
        pkts = enc.encode(gradient_frames(4, 256, 192))
        enc.close()
        path = d / f"{name}.ivf"
        write_ivf_packets(path, pkts, 256, 192)
        data = path.read_bytes()
        with _device_env(DAV1D_TPU_DEVICE="0"):
            host = _md5(Decoder(Settings(two_pass=True)), data)
        out[name] = (path, host, _port_md5(data))
    return out


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_mesh_decode_matches_single_and_jax(streams, name, n):
    from dav1d_tpu_torch import devrt

    path, host, single = streams[name]
    assert host[0] == 4
    assert single == host, f"{name}: the port's single-device decode"
    devrt.COUNTS.clear()
    assert _port_md5(path.read_bytes(), _mesh(n)) == host
    c = devrt.COUNTS
    # every kind of band work ran: 4 frames, itx in n shares each
    assert c["mesh_itx_shares"] == 4 * n, dict(c)
    for k in ("mesh_deblock_v_bands", "mesh_deblock_h_bands",
              "mesh_cdef_dir_bands", "mesh_cdef_bands", "halo_bytes"):
        assert c[k] > 0, (k, dict(c))
    if name == "superres_lr":
        assert c["mesh_lr_wiener_shares"] > 4, dict(c)


def test_jax_mesh_decode_matches(streams):
    """The JAX package's own mesh decode (Settings.mesh over conftest's 8
    virtual CPU devices: mesh deblock, mesh CDEF, sharded LR) gives the
    md5 that the port's mesh decodes give."""
    import jax
    from jax.sharding import Mesh as JaxMesh

    from dav1d_tpu.decoder import Decoder, Settings

    devices = jax.devices()
    assert len(devices) >= 8
    mesh = JaxMesh(np.array(devices[:8]), axis_names=("tiles",))
    path, host, _ = streams["superres_lr"]
    with _device_env():
        got = _md5(Decoder(Settings(two_pass=True, mesh=mesh)),
                   path.read_bytes())
    assert got == host


LAYOUTS = ["i422_8bit_256x192.ivf", "i444_10bit_256x192.ivf",
           "i420_12bit_256x192.ivf", "mono_8bit_256x192.ivf"]


@pytest.mark.parametrize("name", LAYOUTS)
def test_layout_stream_mesh_decode(name):
    want = json.loads((DATA / "md5.json").read_text())[name]
    got = _port_md5((DATA / name).read_bytes(), _mesh(2))
    assert got == (want["frames"], want["md5"])


@pytest.mark.parametrize("n_threads,bands", [(0, 0), (4, 0), (9, 0),
                                             (4, 2)])
def test_worker_threads(n_threads, bands):
    """Frames reconstructed on the decoder's worker pool (n_fc threads,
    frames in flight at once), alone and with a mesh."""
    name = "hbd10_128x96.ivf"
    want = json.loads((DATA / "md5.json").read_text())[name]
    got = _port_md5((DATA / name).read_bytes(),
                    _mesh(bands) if bands else None, n_threads)
    assert got == (want["frames"], want["md5"])


_WORKER = r"""
import hashlib, sys
import torch
import torch.distributed as dist

rank, port, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, sys.argv[4])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        world_size=2, rank=rank)
from dav1d_tpu_torch.containers import read_ivf
from dav1d_tpu_torch.decoder import Decoder, Settings
from dav1d_tpu_torch.mesh import Mesh

try:  # rank 0 holds one band, rank 1 two
    Mesh(["cpu"] * (1 + rank), group=dist.group.WORLD)
    print("REFUSED no", flush=True)
except ValueError as e:
    print("REFUSED", e, flush=True)
mesh = Mesh(["cpu"], group=dist.group.WORLD)
assert (mesh.n, mesh.local) == (2, [rank])
dec = Decoder(Settings(two_pass=True, mesh=mesh), device="cpu")
h = hashlib.md5()
n = 0
for tu, _ in read_ivf(open(path, "rb").read()):
    dec.send_data(tu)
    while (p := dec.get_picture()) is not None:
        n += 1
        for pl in range(len(p.planes)):
            h.update(p.plane_bytes(pl))
dec.close()
dist.destroy_process_group()
print(f"RESULT {rank} {n} {h.hexdigest()}", flush=True)
"""


def test_two_process_mesh_decode(streams):
    path, host, _ = streams["tiles"]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(port), str(path),
         str(REPO)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
        lines = out.splitlines()
        assert any(ln.startswith("REFUSED the ranks disagree")
                   for ln in lines), out[-2000:]
        _, got_r, n, digest = [ln for ln in lines
                               if ln.startswith("RESULT")][-1].split()
        assert (int(got_r), int(n), digest) == (r, *host), \
            f"rank {r} diverges"


def test_refusals(monkeypatch):
    from dav1d_tpu_torch.decoder import Decoder, Settings
    from dav1d_tpu_torch.mesh import Mesh

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Mesh(["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="at least one device"):
        Mesh([])
    # a mesh on another device than the decoder's (a CUDA mesh built as if
    # a card were there; nothing touches it)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cuda_mesh = Mesh(["cuda:0"] * 2)
    with pytest.raises(ValueError, match="not the decoder's device"):
        Decoder(Settings(mesh=cuda_mesh), device="cpu")

    class Group:  # what a process-group mesh carries
        devices, group = [CPU], object()

    with pytest.raises(ValueError, match="n_threads"):
        Decoder(Settings(mesh=Group(), n_threads=4), device="cpu")


def test_launch_counts_from_threads():
    """devrt.LAUNCHES loses no launch when 16 threads launch at once with
    a short switch interval (each launch a read-modify-write under
    devrt's lock)."""
    import threading

    from dav1d_tpu_torch import devrt

    tag, per, n = "threads_probe", 2000, 16
    devrt.LAUNCHES.pop(tag, None)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per):
                devrt.launch(tag, lambda: 0)

        threads = [threading.Thread(target=work) for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert devrt.LAUNCHES.pop(tag) == n * per
