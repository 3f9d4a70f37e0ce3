"""The port's GOP-parallel and relay decodes (dav1d_tpu_torch/gop.py,
``device="cpu"``) against the JAX package's tools/gop_decode.py and its
serial decode on the host tier, and decoder state handed from the JAX
package to the port:

* ``split_gops`` cuts a 10-frame ``kf_max_dist=4`` stream into the same
  sequence header and segments as tools/gop_decode.split_gops;
* ``gop_decode(jobs=2)`` (spawned workers) and ``relay_decode(segments=3)``
  (a spawned process a segment, the state handed through files) stitch to
  the JAX package's serial md5;
* a JAX ``Decoder.export_state`` blob, taken after the first temporal
  unit of the committed 10-bit stream, continues in the port's
  ``Decoder.import_state`` to the whole stream's md5, and the port's
  unpickler refuses a blob naming anything but the decoder's classes,
  numpy's array reconstructors and plain builtin types;
* two processes that build the kernel library at once compile it once
  (kernels/build.py's file lock), with nvcc stood in by a script;
* without CUDA, ``python -m dav1d_tpu_torch.gop`` on its default device
  exits non-zero and says why."""

import hashlib
import os
import pickle
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "dav1d_tpu_torch" / "data"
sys.path.insert(0, str(REPO / "tools"))

from aom_enc import AomEncoder, gradient_frames, write_ivf_packets  # noqa

DEVICE_VARS = ("DAV1D_TPU_DEVICE", "DAV1D_TPU_DEVICE_MC",
               "DAV1D_TPU_DEVICE_ITX", "DAV1D_TPU_DEVICE_IPRED")


@pytest.fixture(scope="module", autouse=True)
def _host_tier():
    from dav1d_tpu.dispatch import use_device

    saved = {k: os.environ.get(k) for k in DEVICE_VARS}
    for k in DEVICE_VARS:
        os.environ.pop(k, None)
    os.environ["DAV1D_TPU_DEVICE"] = "0"
    use_device.cache_clear()
    yield
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    use_device.cache_clear()


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    enc = AomEncoder(width=128, height=96, usage="good", cpu_used=6, q=40,
                     kf_max_dist=4, lag=0)
    pkts = enc.encode(gradient_frames(10, 128, 96))
    enc.close()
    ivf = tmp_path_factory.mktemp("gop") / "gop.ivf"
    write_ivf_packets(ivf, pkts, 128, 96)
    return ivf.read_bytes()


def _jax_serial(data):
    from dav1d_tpu.containers import read_ivf
    from dav1d_tpu.decoder import Decoder, Settings

    dec = Decoder(Settings(two_pass=True, max_frame_delay=4))
    h = hashlib.md5()
    n = 0
    for tu, _ in read_ivf(data):
        dec.send_data(tu)
        while (pic := dec.get_picture()) is not None:
            for pl in range(len(pic.planes)):
                h.update(pic.plane_bytes(pl))
            n += 1
    return n, h.hexdigest()


def _stitched(parts):
    h = hashlib.md5()
    for _, path in parts:
        h.update(Path(path).read_bytes())
    return sum(c for c, _ in parts), h.hexdigest()


def test_split_gops_matches_jax(stream):
    from gop_decode import split_gops as jax_split

    from dav1d_tpu_torch.containers import read_ivf
    from dav1d_tpu_torch.gop import split_gops

    tus = [tu for tu, _ in read_ivf(stream)]
    seq, segments = split_gops(tus)
    assert (seq, segments) == jax_split(tus)
    assert seq is not None and len(segments) == 3
    assert [len(s) for s in segments] == [4, 4, 2]


def test_gop_decode_matches_jax_serial(stream, tmp_path):
    from dav1d_tpu_torch.gop import gop_decode

    parts = gop_decode(stream, jobs=2, workdir=str(tmp_path), device="cpu")
    assert len(parts) == 3
    assert _stitched(parts) == _jax_serial(stream)


def test_relay_decode_matches_jax_serial(stream, tmp_path):
    from dav1d_tpu_torch.gop import relay_decode

    parts = relay_decode(stream, segments=3, workdir=str(tmp_path),
                         device="cpu")
    assert [c for c, _ in parts] == [3, 4, 3]
    assert _stitched(parts) == _jax_serial(stream)


def _pictures(dec, tus):
    out = []
    for tu in tus:
        dec.send_data(tu)
        while (pic := dec.get_picture()) is not None:
            out.append(b"".join(pic.plane_bytes(pl)
                                for pl in range(len(pic.planes))))
    return out


def test_jax_state_continues_in_port():
    from dav1d_tpu.decoder import Decoder as JaxDecoder
    from dav1d_tpu.decoder import Settings as JaxSettings
    from dav1d_tpu_torch.containers import read_ivf
    from dav1d_tpu_torch.decoder import Decoder, Settings

    want = __import__("json").loads((DATA / "md5.json").read_text())[
        "hbd10_128x96.ivf"]
    tus = [tu for tu, _ in read_ivf((DATA / "hbd10_128x96.ivf").read_bytes())]
    jax = JaxDecoder(JaxSettings(two_pass=True, max_frame_delay=4))
    head = _pictures(jax, tus[:1])
    port = Decoder(Settings(two_pass=True, max_frame_delay=4), device="cpu")
    port.import_state(jax.export_state())
    tail = _pictures(port, tus[1:])
    assert len(head) + len(tail) == want["frames"]
    assert hashlib.md5(b"".join(head + tail)).hexdigest() == want["md5"]


class _Gadget:
    def __init__(self, fn, arg):
        self.fn, self.arg = fn, arg

    def __reduce__(self):
        return self.fn, (self.arg,)


@pytest.mark.parametrize("what", ["os.system", "builtins.eval",
                                  "module_attribute", "other_package"])
def test_import_state_refuses_other_names(what):
    from dav1d_tpu_torch.decoder import Decoder, Settings, load_state

    dec = Decoder(Settings(two_pass=True), device="cpu")
    good = dec.export_state()
    assert load_state(good)["refs"]
    payload = {"os.system": _Gadget(os.system, "true"),
               "builtins.eval": _Gadget(eval, "1"),
               # a module-level name of the package that is not a class
               "module_attribute": _Gadget(
                   __import__("dav1d_tpu_torch.kernels.build",
                              fromlist=["build"]).build, None),
               "other_package": _Gadget(subprocess.Popen, ["true"])}[what]
    blob = pickle.dumps({"refs": [payload]})
    with pytest.raises(pickle.UnpicklingError, match="state blob names"):
        dec.import_state(blob)


_BUILD = r"""
import sys
from pathlib import Path
sys.path.insert(0, sys.argv[1])
from dav1d_tpu_torch.kernels import build
build.BUILD_DIR = Path(sys.argv[2])
print(build.build())
"""

_FAKE_NVCC = """#!/bin/sh
echo "$*" >> "$NVCC_LOG"
sleep 0.5
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then touch "$2"; fi
  shift
done
"""


def test_kernel_build_once_across_processes(tmp_path):
    from dav1d_tpu_torch.kernels import build

    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(0o755)
    log = tmp_path / "nvcc.log"
    env = dict(os.environ, PATH=f"{bin_dir}:{os.environ['PATH']}",
               NVCC_LOG=str(log))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(REPO),
                               str(tmp_path / "build")], env=env,
                              stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300)[0].strip() for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    assert outs[0] == outs[1] and Path(outs[0]).exists()
    # one nvcc per source and one link, once
    calls = log.read_text().splitlines()
    assert len(calls) == len(build.sources()) + 1, calls
    assert sum("-shared" in c for c in calls) == 1


def test_cuda_without_cuda_exits_nonzero():
    from test_torch_cli import cuda_without_cuda

    cuda_without_cuda("gop", "-i", DATA / "hbd10_128x96.ivf")
