"""The readers of the output stage's film grain (span ``grain``, the
``grain.*`` counts, the film-grain kernel's roofline) on records made by
hand, None where what they read is missing (a program without the
counts, a window with no picture grained, a run without the roofline's
sample), and a traced run of the tiny film-grain stream cell on the CPU
that reports the three the CPU can read."""

from __future__ import annotations

import importlib.util
import json

import pytest

import run
from conftest import BENCH

HOST = ("grain.ms_per_picture", "grain.mb_per_picture",
        "grain.resident_share")


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_"), BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


COUNTS = {"grain.pictures": 10, "grain.planes": 30, "grain.resident": 4,
          "grain.up_bytes": 3_000_000, "grain.down_bytes": 5_000_000,
          "grain.copy_bytes": 12_000_000}
ROOFLINE = {"units": 24, "sessions": 1,
            "bound_ms": {"fg_kernel": 0.5, "itx_frame_kernel": 2.0},
            "kernel_ms": {"fg_kernel": 2.0, "itx_frame_kernel": 4.0}}


def _rec(spans=None, counts=COUNTS, roofline=ROOFLINE):
    return {"spans": {"grain": 0.2, "api.get": 0.5} if spans is None
            else dict(spans), "counts": dict(counts),
            "roofline": roofline, "frames_decoded": 11}


@pytest.mark.parametrize("name,want", [
    ("grain.ms_per_picture", 20.0),
    ("grain.mb_per_picture", 2.0),
    ("grain.resident_share", 40.0),
    ("grain.fg_roofline", 25.0),
])
def test_reader_on_a_record(name, want):
    assert _reader(name)(_rec()) == pytest.approx(want)


@pytest.mark.parametrize("name", HOST)
def test_host_reader_none_without_its_counts(name):
    read = _reader(name)
    # the parent program: the grain span, no grain counts
    assert read(_rec(counts={"inter_blocks": 5})) is None
    # a window in which no picture was grained
    assert read(_rec(counts={**COUNTS, "grain.pictures": 0})) is None
    assert read(_rec(counts={})) is None


def test_each_reader_needs_its_own_inputs():
    assert _reader("grain.ms_per_picture")(_rec(spans={})) is None
    # a count that is 0 drops out of the window's record: none resident
    no_resident = {k: v for k, v in COUNTS.items() if k != "grain.resident"}
    assert _reader("grain.resident_share")(_rec(counts=no_resident)) == 0.0
    only_pictures = {"grain.pictures": 10}
    assert _reader("grain.mb_per_picture")(_rec(counts=only_pictures)) \
        is None


def test_fg_roofline_none_without_its_kernel():
    read = _reader("grain.fg_roofline")
    assert read(_rec(roofline=None)) is None
    other = {"units": 24, "sessions": 1,
             "bound_ms": {"itx_frame_kernel": 2.0},
             "kernel_ms": {"itx_frame_kernel": 4.0}}
    assert read(_rec(roofline=other)) is None
    timed_only = {**ROOFLINE, "bound_ms": {}}
    assert read(_rec(roofline=timed_only)) is None


def test_traced_grain_stream_reports_the_host_readers(tiny_root, capsys):
    assert run.main(["--workload", "tiny10g.stream", "--seed", "2147500321",
                     "--seconds", "3", "--trace", "1"], device="cpu",
                    root=tiny_root) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(HOST) <= set(m), sorted(set(HOST) - set(m))
    # no roofline sample on the CPU
    assert "grain.fg_roofline" not in m
    assert m["grain.ms_per_picture"] > 0
    assert 0.0 <= m["grain.resident_share"] <= 100.0
    # at least the copies of a 160x96 4:2:0 picture's planes
    assert m["grain.mb_per_picture"] >= 160 * 96 * 1.5 * 2 / 1e6
