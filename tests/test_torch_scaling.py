"""The port's scaling tool (dav1d_tpu_torch/scaling.py) on the CPU:

* part A at 1 and 2 bands on the committed 10-bit stream: every mesh
  decode byte-equal to the one-device decode (the equality flag, and the
  committed md5), with the decomposition's keys per band count;
* part A at 2 bands on the 4:2:2 stream, whose frames deblock, CDEF- and
  restoration-filter across the band boundary: halo bytes counted, at
  most the geometry's bytes between bands, and none moved between
  devices (both bands on the CPU);
* part B at 1 and 2 bands on the 10-bit stream (the host clock): a row
  per band kernel and band count with the efficiency
  t(full) / (n * t(share));
* a mesh whose bands end before the plane's allocation (one band, or
  three, of a 256x192 stream coded in 128x128 superblocks: 192 or
  3 x 64 band rows in a 256-row allocation, the case of a one-band mesh
  on the 1080p streams) decodes to the JAX host tier's md5 (it raised in
  the stitch before: Queue 3 of ROADMAP.md);
* ``python -m dav1d_tpu_torch.scaling`` on its default device exits
  non-zero without CUDA."""

import hashlib
import json
import os
import sys
from pathlib import Path

import pytest
import torch

DATA = Path(__file__).resolve().parent.parent / "dav1d_tpu_torch" / "data"


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_part_a_hbd10():
    from dav1d_tpu_torch import scaling

    want = json.loads((DATA / "md5.json").read_text())["hbd10_128x96.ivf"]
    a = scaling.part_a("hbd10_128x96.ivf", (1, 2), "cpu")
    assert a["byte_equal_all"] is True
    assert (a["frames"], a["md5"]) == (want["frames"], want["md5"])
    assert [r["bands"] for r in a["runs"]] == [1, 2]
    for r in a["runs"]:
        assert r["byte_equal"] and r["md5"] == want["md5"]
        assert set(r) >= {"planes", "halo_bytes_per_frame",
                          "band_work_per_frame",
                          "launches_per_band_per_frame",
                          "bytes_between_bands_per_frame", "wall_fps"}
        # no kernel launches on the CPU: the wrappers run plain versions
        assert r["launches_per_band_per_frame"] == {}
        assert r["band_work_per_frame"]["mesh_itx_shares"] == r["bands"]
        assert [p["band_rows"] for p in r["planes"]] == \
            ([128, 64, 64] if r["bands"] == 1 else [64, 64, 64])
    json.dumps(a)


def test_part_a_halo_bytes_within_geometry():
    from dav1d_tpu_torch import scaling

    a = scaling.part_a("i422_8bit_256x192.ivf", (2,), "cpu")
    assert a["byte_equal_all"] is True
    (r,) = a["runs"]
    moved = r["bytes_between_bands_per_frame"]
    assert 0 < moved["halo_counted"] <= moved["geometry"]
    assert moved["moved_between_devices"] == 0
    assert r["band_work_per_frame"]["mesh_deblock_h_bands"] > 0


def test_part_b_hbd10():
    from dav1d_tpu_torch import scaling

    b = scaling.part_b(("hbd10_128x96.ivf",), (1, 2), "cpu", reps=1)
    assert b["clock"] == "host"
    kernels = {(r["kernel"], r["bands"]) for r in b["rows"]}
    assert {("itx", 1), ("itx", 2), ("cdef_filter", 2)} <= kernels
    for r in b["rows"]:
        assert r["share_wrapper_ms_per_frame"] > 0
        assert r["wrapper_efficiency"] > 0 and r["efficiency"] is None
    json.dumps(b)


def test_mesh_bands_end_before_allocation(tmp_path):
    sys.path.insert(0, str(DATA.parent.parent / "tools"))
    from aom_enc import AomEncoder, gradient_frames, write_ivf_packets

    from dav1d_tpu.containers import read_ivf
    from dav1d_tpu.decoder import Decoder, Settings
    from dav1d_tpu.dispatch import use_device

    from dav1d_tpu_torch import scaling

    enc = AomEncoder(width=256, height=192, usage="good", cpu_used=6, q=40,
                     kf_max_dist=9999, lag=0, options={"sb-size": 128})
    pkts = enc.encode(gradient_frames(3, 256, 192))
    enc.close()
    write_ivf_packets(tmp_path / "sb128.ivf", pkts, 256, 192)
    data = (tmp_path / "sb128.ivf").read_bytes()
    saved = os.environ.get("DAV1D_TPU_DEVICE")
    os.environ["DAV1D_TPU_DEVICE"] = "0"
    use_device.cache_clear()
    try:
        dec = Decoder(Settings(two_pass=True, max_frame_delay=4))
        h = hashlib.md5()
        n = 0
        for tu, _ in read_ivf(data):
            dec.send_data(tu)
            while (pic := dec.get_picture()) is not None:
                n += 1
                for pl in range(len(pic.planes)):
                    h.update(pic.plane_bytes(pl))
    finally:
        if saved is None:
            os.environ.pop("DAV1D_TPU_DEVICE")
        else:
            os.environ["DAV1D_TPU_DEVICE"] = saved
        use_device.cache_clear()
    for bands in (1, 3):
        got = scaling._decode(data, torch.device("cpu"), bands)
        # the allocation (128-row superblocks) outlasts the bands
        assert got[2][0] == (256, 256)
        assert got[:2] == (n, h.hexdigest()) and n == 3


def test_cuda_without_cuda():
    from test_torch_cli import cuda_without_cuda

    cuda_without_cuda("scaling")
