"""``roofline.py`` against a count by hand, one call of each kernel."""

from __future__ import annotations

import types

import pytest
import torch

import roofline as rf

i32 = torch.int32


def t(rows):
    return torch.tensor(rows, dtype=i32)


def test_deblock():
    src = torch.zeros((16, 32), dtype=i32)
    cells = t([[1, 0, 2], [0, 0, 3]])
    for vertical, name in ((True, "deblock_v"), (False, "deblock_h")):
        args = (src, cells, vertical, 8, True)
        assert rf.kernel_of("deblock", args) == name
        # the plane read and written, the cells read; 20 operations on
        # each of an edge's 4 lines, 3 edges
        assert rf.work(name, args) == (2 * 512 * 4 + 6 * 4, 20 * 4 * 3)


def test_cdef_dir():
    plane = torch.zeros((16, 24), dtype=i32)
    # 2 x 3 blocks of 8x8
    assert rf.work("cdef_dir", (plane, 8)) == (384 * 4 + 2 * 6 * 4,
                                               6 * (640 + 290))


def test_cdef_filter():
    plane = torch.zeros((16, 16), dtype=i32)
    pm, sm = t([[1, 0], [0, 0]]), t([[0, 0], [0, 2]])
    dmap = torch.zeros((2, 2), dtype=i32)
    args = (plane, pm, sm, dmap, dmap, 16, 16, 8, 8, 3, 8, True, False)
    # plane in and out, both grids, a direction and a variance a unit;
    # 2 active 8x8 units, 100 operations a pixel
    assert rf.work("cdef_filter", args) == ((2 * 256 + 4 + 4 + 8) * 4,
                                            2 * 64 * 100)
    band = args + (2, 1)  # halo rows read, not written
    assert rf.work("cdef_filter_band", band)[0] == (
        (2 * 256 - 3 * 16 + 16) * 4)


def test_mc():
    # one 8x4 block at (10, 20) of reference 0, inside its 64x64 plane:
    # its window is 8 + 7 wide and 4 + 7 high
    jobs = t([[0, 10, 20, 8, 4]])
    args = ([None], [(64, 64)], jobs, None, 32, 32, 8)
    nbytes, ops = rf.work("mc", args)
    assert nbytes == 4 * 15 * 11 + 5 * 4 + 32
    assert ops == (4 + 7) * 8 * 17 + 4 * 8 * 19
    # a window clamped at the plane's corner reads only the plane
    jobs = t([[0, 0, 0, 8, 4]])
    assert rf.work("mc", ([None], [(64, 64)], jobs, None, 32, 32, 8))[0] == (
        4 * 8 * 12 + 5 * 4 + 32)


def test_itx():
    # one 4x4 DCT_DCT whose first coded row holds the only nonzero
    cf = torch.zeros(16, dtype=i32)
    cf[0] = 5
    jobs = t([[0, 0, 0]])
    nbytes, ops = rf.work("itx", (cf, jobs, None, 16, 8))
    assert nbytes == 16 * 4 + 3 * 4 + 16 * 2
    # 1 row: a DCT4 (30) and 4 x 4 shift and clip; 4 column DCT4s; 2 a
    # residual
    assert ops == (30 + 16) + 4 * 30 + 2 * 16
    # WHT_WHT
    assert rf.work("itx", (cf, t([[0, 0, 16]]), None, 16, 8))[1] == 16 + 64


def test_resize():
    plane = torch.zeros((4, 40), dtype=i32)
    geom = (32, 16, 0, 0, 4, 40)  # out_w, src_w, -, -, h, alloc_w
    nbytes, ops = rf.work("resize", ([plane], [geom], 8))
    assert (nbytes, ops) == (4 * (4 * 16 + 4 * 40), 19 * 4 * 32)


def test_lr():
    # a 64x16 unit with a top edge; the variant column 10
    row = [0, 0, 64, 16, 4, 0, 0, 0, 0, 0, 0]
    jobs = t([row])
    nbytes = 4 * (2 * 64 * 16 + 64 * 2) + 11 * 4
    assert rf.work("lr_wiener", (None, None, jobs)) == (
        nbytes, 17 * 22 * 64 + 17 * 1024)
    row[10] = 1  # the 3x3 radius only
    wide = 22 * 66
    assert rf.work("lr_sgr", (None, None, t([row]))) == (
        nbytes, 7 * wide + 19 * 18 * 66 + 24 * 1024 + 7 * 1024)


def test_fg():
    lut = torch.zeros(10, dtype=i32)
    sc = torch.zeros(256, dtype=i32)
    offs = torch.zeros(4, dtype=i32)
    luma = types.SimpleNamespace(pl=0, ss_x=1, csfl=False)
    args = (None, None, lut, sc, offs, 32, 8, 32, luma)
    assert rf.work("fg", args) == (4 * (2 * 256 + 270), 256 * 10)
    chroma = types.SimpleNamespace(pl=1, ss_x=1, csfl=False)
    args = (None, None, lut, sc, offs, 16, 8, 32, chroma)
    assert rf.work("fg", args) == (4 * (2 * 128 + 8 * 32 + 270),
                                   128 * (10 + 3 + 6))


def test_ipred():
    jobs = t([[0, 0, 4, 8]])  # a 4x8 unit
    per = 8 * 32 + 64
    assert rf.work("ipred", (None, None, jobs)) == (
        per + 4 * (2 * 4 + 2 * 8 + 1), 5 * 32)
    assert rf.work("ipred_pal", (None, None, jobs)) == (per + 32, 5 * 32)
    assert rf.work("ipred_cfl", (None, None, None, jobs, None, 1, 1)) == (
        per + 4 * 25 + 4 * 32 * 4, 5 * 32)
    tags = t([0, 2])
    two = t([[0, 0, 4, 8], [0, 0, 4, 8]])
    args = (None, None, None, two, tags, t([1, 1]), None, None, 1, 1)
    assert rf.work("ipred_walk", args) == (
        4 * 4 + per + 4 * 25 + per + 32, 2 * 5 * 32)


def test_bound_is_the_larger_side():
    src = torch.zeros((16, 32), dtype=i32)
    ms = rf.bound_ms("deblock_v", (src, t([[1]]), True, 8, True))
    assert ms == pytest.approx((2 * 512 * 4 + 4) / rf.HBM_BYTES_PER_S * 1e3)
    assert set(rf.KERNEL_OF_CALL.values()) == rf.KERNELS


class _NoTrace:
    """The profiler's place on the CPU, where it has no device to read."""

    def start(self):
        pass

    def stop(self):
        return []


@pytest.mark.parametrize("mix,units,sent", [("stream", 4, 4),
                                            ("clips4", 4, 12)])
def test_roofline_sample_follows_the_cells_traffic(monkeypatch, mix, units,
                                                    sent):
    """After the window each session sends the next units of its own
    traffic (the stream its next clip through the window's decoder, a
    loader its next requests, each finished), and every device call of
    them is bounded; every picture of it is judged."""
    import json
    import time

    import devtrace
    import generator
    import harness
    from conftest import BENCH, ROOT

    monkeypatch.setattr(devtrace, "DeviceTrace", _NoTrace)
    cfg = json.loads((BENCH / "tests/data/tiny10g.json").read_text())
    assert cfg["roofline_units"] == units
    d = json.loads((BENCH / "traffic" / f"{mix}.json").read_text())
    job = {"root": ROOT, "config": cfg, "mix": generator.parse_mix(d),
           "seed": 2147483777, "index": 1, "seconds": 0.5, "trace": True,
           "device": "cpu", "control": False,
           "decoder": f"{harness.PROGRAM}.decoder:Decoder"}
    s = harness._Session(job)
    s.warm_up()
    if s.mix.decoder == "session":
        s.dec = s.open()
    s.t0 = time.perf_counter()
    s.t_end = s.t0 + job["seconds"]
    s.drive()
    expected = s.judge.expected
    got = harness.roofline_sample(s)
    assert got["units"] == sent
    assert s.judge.expected == expected + sent
    assert {"itx_frame_kernel", "mc_put_8tap_kernel"} <= set(got["bound_ms"])
    assert all(v > 0 for v in got["bound_ms"].values())
    assert got["kernel_ms"] == {}
    assert s.judge.finish() == {"order": 0, "pixels": 0, "count": 0}
