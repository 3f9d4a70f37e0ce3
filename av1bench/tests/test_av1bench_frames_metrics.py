"""The reader of the frame pipeline's drains (``frames.drains`` over the
frames decoded) on records made by hand: None for a program without the
pipeline's counts, 0 where only ``frames.existing_queued`` moved (the
window's counts leave out a count that stayed at 0), and the drains a
decoded frame otherwise."""

from __future__ import annotations

import importlib.util

import pytest

from conftest import BENCH


def _read(counts, frames=40):
    spec = importlib.util.spec_from_file_location(
        "frames_drains_per_frame",
        BENCH / "metrics" / "frames.drains_per_frame.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read({"counts": dict(counts), "frames_decoded": frames,
                     "spans": {}})


def test_none_without_the_pipeline_counts():
    # a program without the pipeline's counts: other counts only
    assert _read({"grain.pictures": 12, "inter_blocks": 500}) is None
    assert _read({}) is None


def test_zero_where_only_shown_frames_were_queued():
    assert _read({"frames.existing_queued": 14}) == 0.0


@pytest.mark.parametrize("counts,want", [
    ({"frames.drains": 10, "frames.existing_queued": 4}, 0.25),
    ({"frames.drains": 6}, 0.15),
])
def test_drains_over_frames_decoded(counts, want):
    assert _read(counts) == pytest.approx(want)


def test_none_without_frames():
    assert _read({"frames.drains": 3}, frames=0) is None
