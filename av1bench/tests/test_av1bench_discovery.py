"""A configuration, a traffic mix and a per-layer metric are added by new
files and new ``BENCHMARK.json`` entries alone; and the whole-name check
for JAX and the JAX package."""

from __future__ import annotations

import hashlib
import json
import sys
import types

import pytest

import harness
import run
from conftest import BENCH


def _digest(root):
    h = hashlib.sha256()
    for p in sorted(root.rglob("*")):
        if p.is_file() and "__pycache__" not in p.parts:
            h.update(str(p.relative_to(root)).encode())
            h.update(p.read_bytes())
    return h.hexdigest()


def _last(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_new_config_mix_and_metric_from_files(tiny_root, capsys):
    before = _digest(tiny_root / "av1bench")
    bench = tiny_root / "av1bench"
    # a configuration: the tiny one under a new name and settings
    cfg = json.loads((bench / "tests/data/tiny10g.json").read_text())
    cfg.update(name="tiny10g_nt", settings={**cfg["settings"],
                                            "n_threads": 0})
    (bench / "configs/tiny10g_nt.json").write_text(json.dumps(cfg))
    # a mix: two stream sessions, one unit in flight
    (bench / "traffic/duo.json").write_text(json.dumps(
        {"processes": 2, "in_flight": 1, "decoder": "session",
         "order": "loop", "frames": None, "start": "key",
         "pace_fps": None}))
    # a metric: pictures a second in the traced window
    (bench / "metrics/api.pictures_per_s.py").write_text(
        "def read(rec):\n    return rec['pictures'] / rec['window_s']\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny10g_nt", "source": "test",
                            "file": "av1bench/configs/tiny10g_nt.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny10g_nt.duo",
                              "config": "tiny10g_nt", "traffic": "duo",
                              "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "api.pictures_per_s", "unit": "1/s",
                              "better": "higher", "source": "host_clock",
                              "layer": "API: decoder.Decoder",
                              "moves": "fps",
                              "workloads": ["tiny10g_nt.duo"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = harness.load_cell(tiny_root, "tiny10g_nt.duo")
    assert cell["config"]["settings"]["n_threads"] == 0
    assert cell["mix"].processes == 2
    assert [m["name"] for m in cell["per_layer"]] == ["api.pictures_per_s"]
    assert {m["name"] for m in cell["end_to_end"]} == {"fps", "setup_s"}
    for trace in (0, 1):
        assert run.main(["--workload", "tiny10g_nt.duo", "--seed", "5",
                         "--seconds", "2", "--trace", str(trace)],
                        device="cpu", root=tiny_root) == 0
        out = _last(capsys)
        assert out["correct"], out["checks"]
        want = {"fps", "setup_s"} if not trace else {"api.pictures_per_s"}
        assert set(out["metrics"]) == want
    # the files that were there are unchanged: only new ones were added
    for p in ("configs/tiny10g_nt.json", "traffic/duo.json",
              "metrics/api.pictures_per_s.py"):
        (bench / p).unlink()
    assert _digest(bench) == before


def _add_cell(root, name, mix, metrics=()):
    """A mix file and a cell of the tiny configuration that drives it, and
    end-to-end metrics of that cell alone: new files and entries only."""
    (root / "av1bench" / "traffic" / f"{name}.json").write_text(
        json.dumps(mix))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": f"tiny10g.{name}", "config": "tiny10g",
                              "traffic": name, "chips": 1, "why": "test"})
    for m, unit in metrics:
        spec["end_to_end"].append({"name": m, "unit": unit,
                                   "better": "lower", "bound": 0.25,
                                   "source": "host_clock",
                                   "workloads": [f"tiny10g.{name}"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


def test_paced_open_loop_mix_from_a_file(tiny_root, capsys):
    """A live player's session, paced at 6 units a second, from a mix
    file alone, with its lateness tail as an end-to-end metric of its
    cell: the pace holds the rate down to it."""
    before = _digest(tiny_root / "av1bench")
    _add_cell(tiny_root, "live", {
        "processes": 1, "in_flight": 2, "decoder": "session",
        "order": "loop", "frames": None, "start": "key", "pace_fps": 6,
        "why": "a player paced at 6 frames a second"},
        [("late_ms_p95", "ms")])
    assert run.main(["--workload", "tiny10g.live", "--seed", "11",
                     "--seconds", "3", "--trace", "0"], device="cpu",
                    root=tiny_root) == 0
    out = _last(capsys)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"fps", "late_ms_p95", "setup_s"}
    # 18 units are due in 3 s, the first at the window's start
    assert 14 / 3 <= out["metrics"]["fps"]["value"] <= 19 / 3
    (tiny_root / "av1bench" / "traffic" / "live.json").unlink()
    assert _digest(tiny_root / "av1bench") == before


def test_seek_mix_from_a_file(tiny_root, capsys):
    """Loader clips that start inside a GOP, decoded from the key frame
    before them, from a mix file alone: the pictures before the start are
    judged but not delivered."""
    _add_cell(tiny_root, "seek", {
        "processes": 1, "in_flight": 2, "decoder": "request",
        "order": "shuffle", "frames": 3, "start": "seek", "pace_fps": None},
        [("clip_ms_p90", "ms")])
    assert run.main(["--workload", "tiny10g.seek", "--seed", "2147483999",
                     "--seconds", "3", "--trace", "0"], device="cpu",
                    root=tiny_root) == 0
    out = _last(capsys)
    assert out["correct"], out["checks"]
    assert out["metrics"]["clip_ms_p90"]["value"] > 0
    # more pictures were judged than delivered: the skipped ones
    assert out["attempted"] > out["metrics"]["fps"]["value"] * 3


@pytest.mark.parametrize("mix", [
    {"processes": 1, "unit": "live", "in_flight": 1},
    {"processes": 1, "in_flight": 1, "decoder": "live", "order": "loop",
     "frames": None, "start": "key", "pace_fps": None},
])
def test_mix_the_generator_has_not_is_refused(tiny_root, capsys, mix):
    _add_cell(tiny_root, "odd", mix)
    with pytest.raises(SystemExit, match="traffic"):
        run.main(["--workload", "tiny10g.odd", "--seed", "1", "--seconds",
                  "1", "--trace", "0"], device="cpu", root=tiny_root)
    assert capsys.readouterr().out.strip() == ""


def test_mix_without_a_file_is_refused(tiny_root):
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "tiny10g.none", "config": "tiny10g",
                              "traffic": "none", "chips": 1, "why": "test"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    with pytest.raises(SystemExit, match="unknown traffic mix"):
        harness.load_cell(tiny_root, "tiny10g.none")


@pytest.mark.parametrize("names,found", [
    (["dav1d_tpu_torch", "dav1d_tpu_torch.ops.itx", "jaxtyping", "numpy"],
     []),
    (["jax.numpy", "numpy"], ["jax"]),
    (["jaxlib"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["dav1d_tpu.ops.pallas_itx", "dav1d_tpu_torch"], ["dav1d_tpu"]),
    (["dav1d_tpu_tools", "dav1d"], []),
])
def test_forbidden_names_compared_whole(names, found):
    assert harness.forbidden_modules(names) == found


def test_run_refuses_a_loaded_jax(tiny_root, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc = run.main(["--workload", "tiny10g.stream", "--seed", "3",
                   "--seconds", "1", "--trace", "0"], device="cpu",
                  root=tiny_root)
    captured = capsys.readouterr()
    assert rc != 0
    assert "jax" in captured.err
    assert not captured.out.strip().startswith("{")


def test_run_without_cuda_prints_no_result(tiny_root, capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "tiny10g.stream", "--seed", "3",
                   "--seconds", "1", "--trace", "0"], root=tiny_root)
    assert rc != 0
    assert capsys.readouterr().out.strip() == ""


def test_bench_folder_alone_fails(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    folder, the program under test is missing: the run fails."""
    import shutil
    import subprocess

    shutil.copytree(BENCH, tmp_path / "av1bench", ignore=shutil.
                    ignore_patterns("__pycache__", ".cache"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "av1bench/run.py", "--workload",
                        "fhd8_vod.stream", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert p.returncode != 0
    assert not p.stdout.strip()
