"""The port's CLI and player (python -m dav1d_tpu_torch.cli / .play,
``--device cpu``) against the JAX package's (tools/dav1d_tpu_cli.py,
tools/dav1d_tpu_play.py on its host tier: JAX_PLATFORMS=cpu
DAV1D_TPU_DEVICE=0), each in a subprocess, on the committed 10-bit
stream and a 128x96 8-bit libaom stream:

* the y4m, yuv, md5 and xxh3 outputs are byte-equal;
* ``--verify`` with the JAX CLI's digest exits 0 ("verify OK") and with
  another exits 1 ("verify FAILED"); ``-s``/``-l`` give the same frames
  and status counts; ``-q`` is silent; ``--frametimes`` writes one line
  a frame; the player's ``--ppm`` files are byte-equal;
* without CUDA, the CLI and the player asked for ``cuda`` (their
  default) exit non-zero and say that CUDA is not available."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "dav1d_tpu_torch" / "data"
sys.path.insert(0, str(REPO / "tools"))

from aom_enc import AomEncoder, gradient_frames, write_ivf_packets  # noqa

ENV = dict(os.environ, JAX_PLATFORMS="cpu", DAV1D_TPU_DEVICE="0",
           OMP_NUM_THREADS="1")


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    enc = AomEncoder(width=128, height=96, usage="good", cpu_used=6, q=40,
                     kf_max_dist=9999, lag=0)
    pkts = enc.encode(gradient_frames(5, 128, 96))
    enc.close()
    write_ivf_packets(d / "s8.ivf", pkts, 128, 96)
    return {"s8": d / "s8.ivf", "hbd10": DATA / "hbd10_128x96.ivf"}


def _jax(*args):
    return subprocess.run(
        [sys.executable, str(REPO / "tools" / "dav1d_tpu_cli.py"),
         *map(str, args)], capture_output=True, env=ENV, timeout=300)


def _port(*args, module="cli", device="cpu"):
    dev = ["--device", device] if device else []
    return subprocess.run(
        [sys.executable, "-m", f"dav1d_tpu_torch.{module}", *map(str, args),
         *dev], capture_output=True, env=ENV, cwd=REPO, timeout=300)


@pytest.mark.parametrize("muxer,name", [
    ("y4m", "s8"), ("y4m", "hbd10"), ("yuv", "s8"), ("md5", "s8"),
    ("md5", "hbd10"), ("xxh3", "hbd10")])
def test_output_matches_jax(streams, muxer, name):
    jax = _jax("-i", streams[name], "--muxer", muxer, "-o", "-")
    port = _port("-i", streams[name], "--muxer", muxer, "-o", "-")
    assert jax.returncode == 0, jax.stderr[-2000:]
    assert port.returncode == 0, port.stderr[-2000:]
    assert len(port.stdout) > 0 and port.stdout == jax.stdout
    n = 5 if name == "s8" else 3
    assert f"decoded {n}/{n} frames".encode() in port.stderr


@pytest.fixture(scope="module")
def digest(streams):
    return _jax("-i", streams["s8"], "--muxer", "md5", "-o", "-",
                "-q").stdout.decode().split()[0]


@pytest.mark.parametrize("ok", [True, False])
def test_verify(streams, digest, ok):
    r = _port("-i", streams["s8"], "--muxer", "null", "--verify",
              digest if ok else "0" * 32)
    if ok:
        assert r.returncode == 0 and b"verify OK" in r.stderr, r.stderr
    else:
        assert r.returncode == 1 and b"verify FAILED" in r.stderr, r.stderr


def test_skip_and_limit(streams):
    args = ("-i", streams["s8"], "--muxer", "yuv", "-o", "-", "-s", "2",
            "-l", "2")
    jax, port = _jax(*args), _port(*args)
    assert port.returncode == jax.returncode == 0
    assert port.stdout == jax.stdout
    assert len(port.stdout) == 2 * 128 * 96 * 3 // 2
    assert b"decoded 2/4 frames" in jax.stderr
    assert b"decoded 2/4 frames" in port.stderr


def test_quiet_and_frametimes(streams, tmp_path):
    times = tmp_path / "times.txt"
    r = _port("-i", streams["s8"], "--muxer", "null", "-q", "--frametimes",
              times)
    assert r.returncode == 0 and r.stderr.strip() == b"", r.stderr
    lines = times.read_text().splitlines()
    assert len(lines) == 5 and all(int(t) > 0 for t in lines)


def test_player_ppm_matches_jax(streams, tmp_path):
    dirs = {}
    for who in ("jax", "port"):
        d = dirs[who] = tmp_path / who
        args = ("-i", streams["hbd10"], "--ppm", d, "--no-pace", "--limit",
                "2")
        if who == "jax":
            r = subprocess.run(
                [sys.executable, str(REPO / "tools" / "dav1d_tpu_play.py"),
                 *map(str, args)], capture_output=True, env=ENV, timeout=300)
        else:
            r = _port(*args, module="play")
        assert r.returncode == 0, r.stderr[-2000:]
    names = sorted(p.name for p in dirs["jax"].iterdir())
    assert names == ["frame00000.ppm", "frame00001.ppm"]
    assert sorted(p.name for p in dirs["port"].iterdir()) == names
    for n in names:
        want = (dirs["jax"] / n).read_bytes()
        assert want.startswith(b"P6\n128 96\n255\n")
        assert (dirs["port"] / n).read_bytes() == want


def cuda_without_cuda(module, *args):
    """Run ``python -m dav1d_tpu_torch.<module>`` on its default device,
    the card: without CUDA it must fail and say why, and run nothing on
    the CPU (tests/test_torch_gop.py, test_torch_entry.py and
    test_torch_scaling.py use this too)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _port(*args, module=module, device=None)
    assert r.returncode != 0
    assert b"CUDA is not available" in r.stderr, r.stderr[-2000:]
    assert b"Traceback" not in r.stderr


@pytest.mark.parametrize("module", ["cli", "play"])
def test_cuda_without_cuda_exits_nonzero(module):
    cuda_without_cuda(module, "-i", DATA / "hbd10_128x96.ivf")
