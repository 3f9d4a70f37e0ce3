"""The window's arithmetic: a rate over the whole window, percentiles over
every sample of every session, and a stall inside the window that moves
both the rate and the tail."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest

import run


def _rec(pictures, latency, clips=(), t0=100.0):
    return {"pictures": pictures, "latency_ms": list(latency),
            "clip_ms": list(clips), "t0": t0}


def test_rate_over_the_whole_window():
    recs = [_rec(30, [10.0] * 30), _rec(50, [20.0] * 50)]
    e2e = run.end_to_end(recs, seconds=20.0)
    assert e2e["fps"] == (80 / 20.0, "frames/s")


def test_percentiles_pool_every_sample():
    a = list(np.linspace(1, 100, 100))
    b = [1000.0] * 10
    e2e = run.end_to_end([_rec(100, a), _rec(10, b)], seconds=1.0)
    pooled = float(np.percentile(a + b, 95))
    assert e2e["frame_ms_p95"][0] == pooled
    # not a mean of the sessions' own percentiles
    assert pooled != (np.percentile(a, 95) + np.percentile(b, 95)) / 2
    e2e = run.end_to_end([_rec(0, [], clips=[5.0, 7.0, 9.0, 200.0])], 1.0)
    assert e2e["clip_ms_p90"][0] == float(np.percentile([5, 7, 9, 200], 90))


def test_tails_by_name():
    """Any percentile of any sample is an end-to-end metric by its name
    alone; a name the harness does not take is refused."""
    recs = [dict(_rec(3, [1.0, 2.0, 3.0]), late_ms=[-5.0, 0.0, 40.0])]
    e2e = run.end_to_end(recs, 1.0, ["frame_ms_p50", "late_ms_p99"])
    assert e2e["frame_ms_p50"] == (2.0, "ms")
    assert e2e["late_ms_p99"][0] == float(np.percentile([-5, 0, 40], 99))
    for bad in ("frame_ms_p100", "frame_ms_p0", "rows_p95", "fps_p95"):
        with pytest.raises(ValueError):
            run.end_to_end(recs, 1.0, [bad])


def test_no_sample_gives_none():
    e2e = run.end_to_end([_rec(0, [])], seconds=1.0)
    assert e2e["frame_ms_p95"][0] is None and e2e["clip_ms_p90"][0] is None


class SlowDecoder:
    """A stand-in decoder that takes ``step`` seconds a picture; with
    ``stall`` its pictures 40 to 59, in the middle of the window, take
    0.1 s more each."""

    step, stall = 0.02, False

    def __init__(self, settings, device=None):
        self.queue, self.n = [], 0

    def send_data(self, data):
        self.queue.append(len(data))

    def get_picture(self):
        if not self.queue:
            return None
        self.queue.pop(0)
        self.n += 1
        time.sleep(self.step)
        if self.stall and 40 <= self.n < 60:
            time.sleep(0.1)

        class P:
            planes = [np.zeros((2, 2), np.int32)]
        return P()

    def close(self):
        pass


class StallDecoder(SlowDecoder):
    stall = True


def _metrics(root, decoder, capsys):
    rc = run.main(["--workload", "tiny10g.stream", "--seed", "7",
                   "--seconds", "3", "--trace", "0"], device="cpu",
                  decoder=decoder, root=root)
    assert rc == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    return json.loads(line)["metrics"]


def test_a_stall_moves_rate_and_tail(tiny_root, capsys):
    steady = _metrics(tiny_root, f"{__name__}:SlowDecoder", capsys)
    stalled = _metrics(tiny_root, f"{__name__}:StallDecoder", capsys)
    assert stalled["fps"]["value"] < 0.85 * steady["fps"]["value"]
    assert stalled["frame_ms_p95"]["value"] > steady["frame_ms_p95"]["value"]
