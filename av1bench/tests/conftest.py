"""Shared pieces of the benchmark's tests: the ``card`` marker, the
benchmark's modules on the path, and a checkout in a temporary
directory whose ``BENCHMARK.json`` holds cells of the small test
configuration ``tests/data/tiny10g.json`` (160x96 10-bit 4:2:0 with film
grain, three clips of 12 frames, libaom's digests)."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_CELLS = {"tiny10g.stream": "stream", "tiny10g.clips4": "clips4",
              "tiny10g.sessions4": "sessions4"}
# a mix of the tests' own: four stream sessions in processes of their own
SESSIONS4 = {"processes": 4, "in_flight": 4, "decoder": "session",
             "order": "loop", "frames": None, "start": "key",
             "pace_fps": None}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"


def make_root(tmp: Path) -> Path:
    """A checkout under ``tmp``: ``BENCHMARK.json`` with the tiny cells
    added, a copy of the benchmark's folder without the committed clips
    of the full-size configurations, and the tests' ``sessions4`` mix."""
    shutil.copytree(BENCH, tmp / "av1bench", ignore=shutil.ignore_patterns(
        "streams", ".cache", "__pycache__"))
    (tmp / "av1bench" / "traffic" / "sessions4.json").write_text(
        json.dumps(SESSIONS4))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({
        "name": "tiny10g", "source": "test stand-in",
        "file": "av1bench/tests/data/tiny10g.json", "reduced": [],
        "why": "CPU tests"})
    for name, mix in TINY_CELLS.items():
        spec["workloads"].append({"name": name, "config": "tiny10g",
                                  "traffic": mix, "chips": 1, "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            src = [c for c in TINY_CELLS
                   if any(w.endswith("." + TINY_CELLS[c])
                          and w.split(".")[0] in ("fhd8_vod", "uhd10_grain")
                          for w in m["workloads"])]
            m["workloads"] += src
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return tmp


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
