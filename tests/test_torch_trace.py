"""The port's tracing (dav1d_tpu_torch/devrt.py): the decoder's API,
wait and queue spans, the frame stages' union and CPU seconds, the
transfer bytes by host memory, and the stage ranges with frame ids and
parents in a profiler trace (``devrt.trace_to``, ``cli.py
--trace-out``), on the CPU; on a card, the ranges and the kernels share
the profiler's clock (``python -m pytest tests/test_torch_trace.py -m
card`` on the card's machine)."""

from __future__ import annotations

import hashlib
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

DATA = Path(__file__).resolve().parent.parent / "dav1d_tpu_torch" / "data"
# 3 frames of 352x288 10-bit with film grain: a key frame and two inter
# frames that read it; the profiled decodes take 3 frames of 128x96
STREAM = "grain_hbd10_352x288.ivf"
SMALL = "hbd10_128x96.ivf"
N_THREADS = 4  # two frame workers (n_fc), as in the benchmark's config

NEW_SPANS = ("api.send", "api.get", "api.open", "api.close", "api.client",
             "wait.frames", "wait.refs", "frame.queued", "frame.release",
             "frames.busy", "pass2.cpu", "chain.cpu")


def _decode(name=STREAM, device="cpu", seen=None, **settings):
    """(pictures, md5 of every plane, wall seconds, n_fc) of one decode
    with the benchmark's settings and ``N_THREADS`` (and ``settings``
    over them), opened and closed; each picture returned is appended to
    ``seen`` where it is a list."""
    from dav1d_tpu_torch.containers import open_stream
    from dav1d_tpu_torch.decoder import Decoder, Settings

    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite's workers share the cores
    try:
        t0 = time.perf_counter()
        dec = Decoder(Settings(**{"two_pass": True, "n_threads": N_THREADS,
                                  "max_frame_delay": 4, **settings}),
                      device=device)
        md5, n = hashlib.md5(), 0

        def take():
            nonlocal n
            while (pic := dec.get_picture()) is not None:
                n += 1
                if seen is not None:
                    seen.append(pic)
                for pl in range(len(pic.planes)):
                    md5.update(pic.plane_buffer(pl))

        for tu, _ in open_stream((DATA / name).read_bytes()):
            dec.send_data(tu)
            take()
        take()
        n_fc = dec.n_fc
        dec.close()
        return n, md5.hexdigest(), time.perf_counter() - t0, n_fc
    finally:
        torch.set_num_threads(threads)


def _want(name=STREAM):
    return json.loads((DATA / "md5.json").read_text())[name]


@pytest.fixture(scope="module")
def traced():
    """One decode with spans and transfer counters on."""
    from dav1d_tpu_torch import devrt

    devrt.SPANS, devrt.XFER = {}, {"up": 0, "down": 0}
    try:
        n, md5, wall, n_fc = _decode()
        return {"n": n, "md5": md5, "wall": wall, "n_fc": n_fc,
                "spans": dict(devrt.SPANS), "xfer": dict(devrt.XFER)}
    finally:
        devrt.SPANS = devrt.XFER = None


def test_every_new_span_is_recorded(traced):
    assert (traced["n"], traced["md5"]) == (_want()["frames"],
                                            _want()["md5"])
    missing = [t for t in NEW_SPANS if t not in traced["spans"]]
    assert not missing, missing
    assert all(v >= 0 for v in traced["spans"].values())


def test_children_within_parents(traced):
    s = traced["spans"]
    assert s["pass1"] <= s["api.send"]
    assert s["pass1.itx"] <= s["pass1"]
    assert s["grain"] <= s["api.get"]
    assert s["wait.frames"] <= s["api.send"] + s["api.get"]
    assert s["pass2.cpu"] <= s["pass2"] * 1.05 + 0.01
    assert s["chain.cpu"] <= s["chain"] * 1.05 + 0.01
    api = s["api.open"] + s["api.send"] + s["api.get"] + s["api.close"]
    assert api + s["api.client"] <= traced["wall"]


def test_pass2_parts_within_pass2(traced):
    """Pass 2's spanned parts: the device MC stage, the host's phase-A
    replay of the inter blocks it left and the host's intra walk."""
    s = traced["spans"]
    assert s["pass2.inter.host"] > 0
    parts = s["pass2.mc"] + s["pass2.inter.host"] + s["pass2.intra.host"]
    assert parts <= s["pass2"] * 1.05 + 0.01


def test_frames_busy_and_parallelism(traced):
    s = traced["spans"]
    assert 0 < s["frames.busy"] <= traced["wall"]
    parallelism = (s["pass1"] + s["pass2"] + s["chain"]) / s["frames.busy"]
    assert 1.0 - 1e-9 <= parallelism <= traced["n_fc"] + 1, parallelism
    assert traced["n_fc"] == 2


def test_transfer_parts_sum_to_totals(traced):
    x = traced["xfer"]
    assert x["up"] > 0 and x["down"] > 0
    assert x.get("up_pageable", 0) + x.get("up_pinned", 0) == x["up"]
    assert x.get("down_pageable", 0) + x.get("down_pinned", 0) == x["down"]


def test_nothing_recorded_with_tracing_off():
    from dav1d_tpu_torch import devrt

    assert devrt.SPANS is None and devrt.XFER is None and not devrt.RANGES
    n, md5, _, _ = _decode()
    assert (n, md5) == (_want()["frames"], _want()["md5"])
    assert devrt.SPANS is None and devrt.XFER is None
    assert devrt.RANGE_LOG == [] and devrt._busy[0] == 0


GRAIN_SPANS = ("grain.copy", "grain.tables", "grain.upload", "grain.apply",
               "grain.download")


def _grain_counts(**settings):
    """(grain counts of ``devrt.COUNTS`` added by one traced decode of
    the stream, its spans, its pictures)."""
    import collections

    from dav1d_tpu_torch import devrt

    before = collections.Counter(devrt.COUNTS)
    pics = []
    devrt.SPANS, devrt.XFER = {}, {"up": 0, "down": 0}
    try:
        _decode(seen=pics, **settings)
        spans = dict(devrt.SPANS)
    finally:
        devrt.SPANS = devrt.XFER = None
    counts = {k: v - before[k] for k, v in devrt.COUNTS.items()
              if k.startswith("grain.")}
    return counts, spans, pics


def _grain_work(pic):
    """(planes grained, bytes of the grain tables uploaded, bytes of the
    planes uploaded where they are not resident, bytes fetched) of one
    picture."""
    from dav1d_tpu_torch.ops import fg as ofg

    d = pic.frame_hdr.film_grain.data
    on = [d.num_y_points > 0] + [
        bool(d.num_uv_points[uv] or d.chroma_scaling_from_luma)
        for uv in range(len(pic.planes) - 1)]
    narrow = 1 if pic.bitdepth == 8 else 2  # the bytes a pixel moves
    blocks = -(-pic.width // ofg.FG_BLOCK) * -(-pic.height // ofg.FG_BLOCK)
    tables = 4 * (2 * blocks + sum(on) * (ofg.LUT_ROWS * ofg.GRAIN_W
                                          + (1 << pic.bitdepth)))
    # luma goes up with any plane: chroma reads it for its index
    planes = sum(p.size * narrow for pl, p in enumerate(pic.planes)
                 if on[pl] or pl == 0)
    down = sum(p.size * narrow for p, g in zip(pic.planes, on) if g)
    return sum(on), tables, planes, down


def test_grain_counts_match_the_pictures():
    """Every picture of the stream is grained: the grain stage counts
    each picture, its planes, the pooled copies, the grained planes
    fetched, and the tables (and the planes where they were not
    resident) uploaded; its span holds its parts.  A picture grained
    again from its host planes counts their upload."""
    import collections

    from dav1d_tpu_torch import devrt
    from dav1d_tpu_torch.recon import filmgrain

    counts, spans, pics = _grain_counts()
    assert len(pics) == _want()["frames"]
    work = [_grain_work(p) for p in pics]
    resident = counts.get("grain.resident", 0)
    assert counts["grain.pictures"] == len(pics)
    assert counts["grain.planes"] == sum(w[0] for w in work)
    assert counts["grain.copy_bytes"] == sum(
        p.nbytes for pic in pics for p in pic.planes)
    assert counts["grain.down_bytes"] == sum(w[3] for w in work)
    assert 0 <= resident <= len(pics)
    planes = {w[2] for w in work}  # one geometry: the same planes each
    assert len(planes) == 1
    assert counts["grain.up_bytes"] == sum(w[1] for w in work) + (
        len(pics) - resident) * planes.pop()
    assert spans["grain"] >= sum(spans[t] for t in GRAIN_SPANS)
    assert spans["grain"] <= spans["api.get"]

    before = collections.Counter(devrt.COUNTS)
    filmgrain.apply_grain(pics[0], torch.device("cpu"))
    added = collections.Counter(devrt.COUNTS) - before
    n, tables, planes, down = work[0]
    assert added == {"grain.pictures": 1, "grain.planes": n,
                     "grain.up_bytes": tables + planes,
                     "grain.down_bytes": down}


def test_no_grain_counted_without_grain():
    counts, spans, pics = _grain_counts(apply_grain=False)
    assert len(pics) == _want()["frames"]
    assert all(v == 0 for v in counts.values()), counts
    assert not any(t == "grain" or t.startswith("grain.") for t in spans)


def test_threads_add_without_loss():
    """Spans and transfer bytes added from many threads at once, with the
    interpreter switching threads as often as it can: no byte is lost,
    and the frame stages' union closes."""
    from dav1d_tpu_torch import devrt

    a = np.zeros(1000, np.uint8)
    interval = sys.getswitchinterval()
    devrt.SPANS, devrt.XFER = {}, {"up": 0, "down": 0}
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(200):
                with devrt.span("pass2"):
                    devrt.upload(a, "cpu")
                    devrt.fetch(torch.zeros(10, dtype=torch.uint8))

        t0 = time.perf_counter()
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        wall = time.perf_counter() - t0
        assert not any(t.is_alive() for t in threads)
        x, s = dict(devrt.XFER), dict(devrt.SPANS)
    finally:
        sys.setswitchinterval(interval)
        devrt.SPANS = devrt.XFER = None
    assert x["up"] == x["up_pageable"] == 16 * 200 * 1000
    assert x["down"] == x["down_pageable"] == 16 * 200 * 10
    assert devrt._busy[0] == 0
    assert 0 < s["frames.busy"] <= wall <= s["pass2"]


def _ranges(path):
    """The trace's ranges of the port's spans: (name, tid, ts, end,
    args)."""
    trace = json.loads(Path(path).read_text())
    return [(e["name"], e["tid"], e["ts"], e["ts"] + e["dur"], e["args"])
            for e in trace["traceEvents"]
            if e.get("cat") == "user_annotation"]


def _within(inner, outer):
    return (inner[1] == outer[1] and outer[2] <= inner[2]
            and inner[3] <= outer[3])


def _check_ranges(ranges):
    """One frame's pass 1 and pass 2 on different threads under one frame
    id; pass1.itx inside pass1 inside api.send, by time and by parent."""
    by = {}
    for r in ranges:
        by.setdefault(r[0], []).append(r)
    for tag in ("api.open", "api.send", "api.get", "pass1", "pass1.itx",
                "pass2", "chain", "wait.frames"):
        assert tag in by, f"no {tag} range"
    p1 = {r[4]["frame"]: r for r in by["pass1"]}
    p2 = {r[4]["frame"]: r for r in by["pass2"]}
    assert set(p1) == set(p2) and len(p1) == _want(SMALL)["frames"]
    for fid in p1:
        assert p1[fid][1] != p2[fid][1], "pass 1 and 2 on one thread"
        assert p1[fid][4]["parent"] == "api.send"
    for itx in by["pass1.itx"]:
        assert itx[4]["parent"] == "pass1"
        outer = [p for p in by["pass1"] if _within(itx, p)]
        assert len(outer) == 1 and outer[0][4]["frame"] == itx[4]["frame"]
        assert any(_within(outer[0], s) for s in by["api.send"])


def test_profiler_ranges_carry_frames_and_parents(tmp_path):
    from dav1d_tpu_torch import devrt

    path = tmp_path / "trace.json"
    with devrt.trace_to(path, "cpu"):
        n, md5, _, _ = _decode(SMALL)
    assert (n, md5) == (_want(SMALL)["frames"], _want(SMALL)["md5"])
    assert not devrt.RANGES and devrt.RANGE_LOG == []
    _check_ranges(_ranges(path))


def test_cli_trace_out(tmp_path, capsys):
    from dav1d_tpu_torch import cli

    path = tmp_path / "cli.json"
    assert cli.main(["-i", str(DATA / SMALL), "--muxer", "md5", "--device",
                     "cpu", "--threads", str(N_THREADS), "--filmgrain", "1",
                     "-q", "--trace-out", str(path)]) == 0
    assert capsys.readouterr().out.strip() == _want(SMALL)["md5"]
    _check_ranges(_ranges(path))


@pytest.mark.card
def test_card_launches_inside_their_ranges(tmp_path):
    """On a card: every itx kernel's launch (the runtime call its
    correlation id names) lies inside a ``pass1.itx`` range on the thread
    that made it, so the ranges and the device's activity share the
    profiler's clock."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from dav1d_tpu_torch import devrt

    path = tmp_path / "trace.json"
    _decode("inter_1080p_8bit.ivf", "cuda")  # builds the kernels
    with devrt.trace_to(path, "cuda"):
        _decode("inter_1080p_8bit.ivf", "cuda")
    events = json.loads(path.read_text())["traceEvents"]
    itx = [r for r in _ranges(path) if r[0] == "pass1.itx"]
    runtime = {e["args"]["correlation"]: e for e in events
               if e.get("cat") in ("cuda_runtime", "cuda_driver")
               and "correlation" in e.get("args", {})}
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "itx_frame_kernel" in e["name"]]
    assert len(kernels) == 4 and len(itx) == 4
    for k in kernels:
        r = runtime[k["args"]["correlation"]]
        launch = (r["name"], r["tid"], r["ts"], r["ts"] + r["dur"])
        assert any(_within(launch, a) for a in itx), launch
