"""dav1d_tpu_torch end to end on the CPU: the port's decoder
(device="cpu", so its itx, MC and filter chain run the plain PyTorch
versions of the kernels) against the JAX package, bit-exact.

* the four tests/test_device_e2e.CASES streams (inter tools, film grain,
  10-bit, super-res + restoration; the grain stream holds no restoration
  unit, whatever tests/test_device_e2e.py's comment says): the port's md5
  equals
  the JAX host tier's (DAV1D_TPU_DEVICE=0), the JAX chain-on tier's
  (DAV1D_TPU_DEVICE=1 with MC, itx and intra on the host) and the JAX
  MC-on tier's (DAV1D_TPU_DEVICE=1 with itx and intra on the host); on
  kitchen (8-bit) and hbd10 (10-bit) also the JAX itx-on tier's
  (DAV1D_TPU_DEVICE=1 with MC and itx on the device, intra on the host).
  That tier compiles one XLA program per (tx, txtp, batch bucket): ~100 s
  for those two streams on the CPU, ~150 s for all four, so the other
  two skip it;
* the port's itx stage computed the residuals of every transform block
  with coefficients (devrt.COUNTS["itx_blocks"] equals the valid rows of
  each frame's coefficient meta arena, counted beside the stage);
* the port's device MC stage predicted blocks (devrt.COUNTS, counted on
  the CPU too) on the streams whose inter frames have blocks its
  selection takes: kitchen, grain and hbd10.  superres_lr has none: with
  super-res on every frame, each reference's upscaled width differs from
  the coded width, so every reference counts as scaled;
* every committed smoke stream (also two film-grain streams, a
  palette-coded one and 256x192 streams of 4:2:2 8-bit, 4:4:4 10-bit,
  4:2:0 12-bit and monochrome 8-bit) decodes to its committed md5, with its
  transform blocks through the itx stage, its inter blocks predicted by
  the MC stage and its loop-restoration units filtered, counted (the
  10-bit stream: 164 transform blocks, 11 of its 12 inter blocks; the
  1080p super-res stream: 642 Wiener units, every frame upscaled, no MC
  block, since every reference is scaled; the 1080p restoration stream:
  327 Wiener and 16 self-guided units);
* with device_intra=True (phase B on the device schedule, one walk per
  chain, the plain walk on the CPU), every
  tests/test_device_intra.CASES stream, that file's mixed-stream recipe
  and 4:2:2 and 12-bit key frames equal the JAX host tier, and the
  committed 10-bit (a CFL unit) and palette streams their md5s; a 10-bit
  film-grain stream equals the JAX host tier on the port's plain grain
  path; a failing launch in the device
  intra stage or in film grain raises out of the decode, and
  device_intra on CUDA without CUDA raises; the schedule leaves frames
  with intrabc or interintra blocks to the host walk, which counts them;
* in a subprocess, the port imports and decodes the committed 10-bit
  stream to its md5 and imports no jax: once with jax unimportable, and
  once with jax importable and the JAX package's dispatch reporting an
  accelerator, as on a GPU machine that has jax installed.

The port imports nothing of the JAX package (tests/test_torch_standalone
.py), so while the port decodes here that package's dispatch reports an
accelerator and refuses to be consulted: the decode must not reach it.
DAV1D_TPU_DEVICE* are unset meanwhile."""

import contextlib
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from dav1d_tpu_torch.containers import read_ivf
from dav1d_tpu.dispatch import use_device
from test_device_e2e import CASES

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
from aom_enc import AomEncoder, gradient_frames  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "dav1d_tpu_torch" / "data"
DEVICE_VARS = ("DAV1D_TPU_DEVICE", "DAV1D_TPU_DEVICE_MC",
               "DAV1D_TPU_DEVICE_ITX", "DAV1D_TPU_DEVICE_IPRED")


@contextlib.contextmanager
def _device_env(**env):
    """Set the JAX package's dispatch variables (others unset) for the
    duration, restoring them and its dispatch cache afterwards."""
    saved = {k: os.environ.get(k) for k in DEVICE_VARS}
    try:
        for k in DEVICE_VARS:
            os.environ.pop(k, None)
        os.environ.update(env)
        use_device.cache_clear()
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        use_device.cache_clear()


def _md5(dec, data):
    h = hashlib.md5()
    n = 0
    for tu, _ in read_ivf(data):
        dec.send_data(tu)
        while (pic := dec.get_picture()) is not None:
            for pl in range(len(pic.planes)):
                h.update(pic.plane_bytes(pl))
            n += 1
    return n, h.hexdigest()


def _settings():
    from dav1d_tpu.decoder import Settings

    return Settings(two_pass=True, max_frame_delay=4)


def _jax_md5(data):
    from dav1d_tpu.decoder import Decoder

    return _md5(Decoder(_settings()), data)


@contextlib.contextmanager
def _refusing_dispatch():
    """The JAX package's dispatch as on an accelerator machine, except
    that every consultation is recorded and refused (yields the record)."""
    import dav1d_tpu.dispatch as dispatch

    asked = []

    def _platform():
        asked.append("_platform")
        return "gpu"

    def use_device(kind):
        asked.append(kind)
        raise AssertionError(f"dav1d_tpu.dispatch consulted for {kind!r}")

    saved = dispatch._platform, dispatch.use_device
    dispatch._platform, dispatch.use_device = _platform, use_device
    try:
        yield asked
    finally:
        dispatch._platform, dispatch.use_device = saved


@contextlib.contextmanager
def _meta_rows_seen():
    """Count, beside the port's itx stage, the rows with coefficients
    (eob >= 0) of every frame's coefficient meta arena (yields a list
    that holds the total afterwards)."""
    from dav1d_tpu_torch import pipeline

    seen = [0]
    launch = pipeline._launch_residuals_native

    def counting(f):
        seen[0] += int((f._nat.meta_rows()[:, 0] >= 0).sum())
        return launch(f)

    pipeline._launch_residuals_native = counting
    try:
        yield seen
    finally:
        pipeline._launch_residuals_native = launch


def _port_md5(data, device_intra=False):
    """The port's (frames, md5) on the CPU; its devrt.COUNTS hold the
    decode's block counts afterwards, and every transform block with
    coefficients went through the itx stage."""
    from dav1d_tpu_torch import devrt
    from dav1d_tpu_torch.decoder import Decoder, Settings

    devrt.COUNTS.clear()
    # one intra-op thread: the suite's workers share the machine's cores,
    # and torch's thread pools in each of them oversubscribe those (a
    # 1080p decode took ~20x longer there than alone)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with _device_env(), _refusing_dispatch() as asked, \
                _meta_rows_seen() as seen:
            got = _md5(Decoder(Settings(two_pass=True, max_frame_delay=4),
                               device="cpu", device_intra=device_intra),
                       data)
    finally:
        torch.set_num_threads(threads)
    assert asked == [], f"the port consulted dav1d_tpu.dispatch: {asked}"
    assert devrt.COUNTS["itx_blocks"] == seen[0] > 0, (
        devrt.COUNTS["itx_blocks"], seen[0])
    return got


def _encode(name):
    kw = dict(CASES[name])
    n = kw.pop("n")
    w, h = kw.pop("w"), kw.pop("h")
    bitdepth = kw.pop("bitdepth", 8)
    enc = AomEncoder(width=w, height=h, usage="good", kf_max_dist=9999,
                     bitdepth=bitdepth, **kw)
    pkts = enc.encode(gradient_frames(n, w, h, bitdepth=bitdepth))
    enc.close()
    import io
    import struct

    buf = io.BytesIO()
    buf.write(struct.pack("<4sHH4sHHIII", b"DKIF", 0, 32, b"AV01", w, h,
                          30, 1, len(pkts)))
    buf.write(b"\0\0\0\0")
    for pts, d in pkts:
        buf.write(struct.pack("<IQ", len(d), pts))
        buf.write(d)
    return n, buf.getvalue()


# streams whose inter frames hold blocks the device MC stage takes
MC_CASES = ("grain", "hbd10", "kitchen")
# streams held against the JAX itx-on tier (one per bit depth; module
# docstring)
ITX_CASES = ("hbd10", "kitchen")


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_matches_jax_tiers(name):
    from dav1d_tpu_torch import devrt

    n, data = _encode(name)
    with _device_env(DAV1D_TPU_DEVICE="0"):
        host = _jax_md5(data)
    with _device_env(DAV1D_TPU_DEVICE="1", DAV1D_TPU_DEVICE_MC="0",
                     DAV1D_TPU_DEVICE_ITX="0", DAV1D_TPU_DEVICE_IPRED="0"):
        chain = _jax_md5(data)
    with _device_env(DAV1D_TPU_DEVICE="1", DAV1D_TPU_DEVICE_MC="1",
                     DAV1D_TPU_DEVICE_ITX="0", DAV1D_TPU_DEVICE_IPRED="0"):
        mc = _jax_md5(data)
    if name in ITX_CASES:
        with _device_env(DAV1D_TPU_DEVICE="1", DAV1D_TPU_DEVICE_MC="1",
                         DAV1D_TPU_DEVICE_ITX="1",
                         DAV1D_TPU_DEVICE_IPRED="0"):
            assert _jax_md5(data) == host, f"{name}: JAX itx-on tier diverges"
    port = _port_md5(data)
    counts = dict(devrt.COUNTS)
    assert host[0] == n
    assert chain == host, f"{name}: JAX chain-on tier diverges"
    assert mc == host, f"{name}: JAX MC-on tier diverges"
    assert port == host, f"{name}: port diverges from the JAX host tier"
    assert 0 < counts["inter_blocks"]
    if name in MC_CASES:
        assert 0 < counts["mc_blocks"] <= counts["inter_blocks"], counts
    else:
        assert counts.get("mc_blocks", 0) == 0, counts


# what each committed stream's decode counts (devrt.COUNTS)
COMMITTED = {
    # 164 transform blocks with coefficients; two inter frames: 12 inter
    # blocks, 11 of them plain translational single-reference blocks the
    # MC stage predicts
    "hbd10_128x96.ivf": {"itx_blocks": 164, "inter_blocks": 12,
                         "mc_blocks": 11},
    "inter_1080p_8bit.ivf": {"itx_blocks": 25444, "inter_blocks": 3489,
                             "mc_blocks": 3324},
    # Wiener on every plane of every frame (106 + 181 + 204 + 151 stripe
    # units); every reference scaled, so no MC block on the device
    "superres_lr_1080p_8bit.ivf": {"itx_blocks": 15819,
                                   "inter_blocks": 2416,
                                   "lr_wiener_units": 642,
                                   "lr_sgr_units": 0},
    # 168 + 16 + 55 + 104 stripe units; the 16 of the key frame's V plane
    # self-guided (the mixed variant)
    "lr_1080p_8bit.ivf": {"itx_blocks": 23361, "inter_blocks": 2491,
                          "mc_blocks": 2337, "lr_wiener_units": 327,
                          "lr_sgr_units": 16},
    # film grain on every frame (plain grain on the CPU)
    "grain_1080p_8bit.ivf": {"itx_blocks": 25418, "inter_blocks": 3466,
                             "mc_blocks": 3282},
    "grain_hbd10_352x288.ivf": {"itx_blocks": 517, "inter_blocks": 87,
                                "mc_blocks": 80},
    # two key frames, palette coded
    "screen_1080p_8bit.ivf": {"itx_blocks": 196, "inter_blocks": 0},
    # the other layouts at 256x192, 1 key + 3 inter frames, restoration on
    "i422_8bit_256x192.ivf": {"itx_blocks": 1030, "inter_blocks": 143,
                              "mc_blocks": 130, "lr_wiener_units": 10,
                              "lr_sgr_units": 0},
    "i444_10bit_256x192.ivf": {"itx_blocks": 598, "inter_blocks": 92,
                               "mc_blocks": 84, "lr_wiener_units": 2,
                               "lr_sgr_units": 0},
    "i420_12bit_256x192.ivf": {"itx_blocks": 166, "inter_blocks": 36,
                               "mc_blocks": 35},
    "mono_8bit_256x192.ivf": {"itx_blocks": 498, "inter_blocks": 160,
                              "mc_blocks": 135, "lr_wiener_units": 6,
                              "lr_sgr_units": 0},
}


# committed streams held elsewhere: the 8-frame 1080p GOP stream only by
# chip_smoke.py on the card, the 2x2-tile stream by
# tests/test_torch_entry.py
ELSEWHERE = ("gop_1080p_8bit.ivf", "tiles2x2_256x192.ivf")


@pytest.mark.parametrize("name", sorted(COMMITTED))
def test_committed_stream_md5(name):
    from dav1d_tpu_torch import devrt

    assert sorted(json.loads((DATA / "md5.json").read_text())) == \
        sorted([*COMMITTED, *ELSEWHERE])
    want = json.loads((DATA / "md5.json").read_text())[name]
    n, md5 = _port_md5((DATA / name).read_bytes())
    assert (n, md5) == (want["frames"], want["md5"])
    assert dict(devrt.COUNTS) == COMMITTED[name]


def test_import_state_continues_with_device_mc():
    """A decoder seeded with export_state() bytes holds reference planes
    but no resident copies of them: its device MC uploads the slots'
    planes, and the decode goes on to the same pictures as one decoder
    that saw the whole stream."""
    from dav1d_tpu_torch import devrt
    from dav1d_tpu_torch.decoder import Decoder, Settings

    tus = [tu for tu, _ in read_ivf((DATA / "hbd10_128x96.ivf").read_bytes())]

    def pictures(dec, units):
        out = []
        for tu in units:
            dec.send_data(tu)
            while (pic := dec.get_picture()) is not None:
                out.append(hashlib.md5(b"".join(
                    pic.plane_bytes(pl) for pl in range(len(pic.planes)))
                ).hexdigest())
        return out

    def decoder():
        return Decoder(Settings(two_pass=True, max_frame_delay=4),
                       device="cpu")

    whole = pictures(decoder(), tus)
    first = decoder()
    head = pictures(first, tus[:1])
    second = decoder()
    second.import_state(first.export_state())
    devrt.COUNTS.clear()
    tail = pictures(second, tus[1:])
    assert head + tail == whole
    assert devrt.COUNTS["mc_blocks"] > 0


_NO_JAX = r"""
import hashlib, importlib.abc, json, sys
from pathlib import Path

mode = sys.argv[3]
tried = []  # jax imports attempted


class _WatchJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            tried.append(name)
            if mode == "blocked":
                raise ImportError(f"{name} blocked")
        return None


sys.meta_path.insert(0, _WatchJax())
sys.path.insert(0, sys.argv[1])
import dav1d_tpu.dispatch as dispatch

asked = []  # dispatch consultations
if mode == "accelerator":
    # jax stays importable; the dispatch answers as on a GPU machine
    dispatch._platform = lambda: asked.append("_platform") or "gpu"
    _use_device = dispatch.use_device
    dispatch.use_device = lambda kind: asked.append(kind) or _use_device(kind)

from dav1d_tpu_torch.containers import read_ivf
from dav1d_tpu_torch.decoder import Decoder, Settings

data = Path(sys.argv[2]).read_bytes()
dec = Decoder(Settings(two_pass=True, max_frame_delay=4), device="cpu")
h = hashlib.md5()
n = 0
for tu, _ in read_ivf(data):
    dec.send_data(tu)
    while (pic := dec.get_picture()) is not None:
        for pl in range(len(pic.planes)):
            h.update(pic.plane_bytes(pl))
        n += 1
jax_mods = sorted(m for m in sys.modules if m.split(".")[0] == "jax")
print(json.dumps({"frames": n, "md5": h.hexdigest(), "tried": tried,
                  "asked": asked, "jax_modules": jax_mods}))
"""


@pytest.mark.parametrize("mode", ["blocked", "accelerator"])
def test_port_runs_without_jax(mode):
    """The port decodes without touching jax: with jax unimportable, and
    with jax importable while the JAX package's dispatch reports an
    accelerator (where a stage that consulted it would pick jax device
    tiers)."""
    want = json.loads((DATA / "md5.json").read_text())["hbd10_128x96.ivf"]
    env = {k: v for k, v in os.environ.items() if k not in DEVICE_VARS}
    r = subprocess.run([sys.executable, "-c", _NO_JAX, str(REPO),
                        str(DATA / "hbd10_128x96.ivf"), mode],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got == {"frames": want["frames"], "md5": want["md5"],
                   "tried": [], "asked": [], "jax_modules": []}


def test_cuda_device_without_cuda_raises():
    """No silent CPU run: asking for CUDA where there is none raises."""
    import torch

    from dav1d_tpu_torch.decoder import Decoder, Settings

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Decoder(Settings(two_pass=True, max_frame_delay=4))


# ---- device intra and film grain ------------------------------------------

def _intra_case(tmp_path, name):
    sys.path.insert(0, str(REPO / "tests"))
    from test_torch_ipred import encode_intra_case

    return encode_intra_case(tmp_path, name)


def _mixed_stream(tmp_path):
    """tests/test_device_intra.test_mixed_stream's recipe: key frames every
    3 frames, inter frames between."""
    from aom_enc import write_ivf_packets
    from test_device_intra import noisy_frames

    w, h, n = 128, 96, 5
    enc = AomEncoder(width=w, height=h, usage="good", kf_max_dist=3, lag=0,
                     cpu_used=4, q=40)
    pkts = enc.encode(noisy_frames(n, w, h))
    enc.close()
    path = tmp_path / "mixed.ivf"
    write_ivf_packets(path, pkts, w, h)
    return path.read_bytes()


# what tests/test_device_intra.CASES lacks: 4:2:2 and 12-bit key frames
EXTRA_INTRA = {"i422": dict(fmt="422"), "hbd12": dict(bitdepth=12)}


def _extra_intra(tmp_path, name):
    """Two key frames of noisy_frames at 96x64 in 4:2:2 or at 12-bit."""
    import numpy as np
    from aom_enc import write_ivf_packets
    from test_device_intra import noisy_frames

    kw = EXTRA_INTRA[name]
    w, h, n = 96, 64, 2
    enc = AomEncoder(width=w, height=h, usage="good", kf_max_dist=1, lag=0,
                     cpu_used=3, q=36, **kw)
    frames = noisy_frames(n, w, h, bitdepth=kw.get("bitdepth", 8))
    if kw.get("fmt") == "422":
        frames = [[f[0], np.repeat(f[1], 2, 0)[:h], np.repeat(f[2], 2, 0)[:h]]
                  for f in frames]
    pkts = enc.encode(frames)
    enc.close()
    path = tmp_path / f"{name}.ivf"
    write_ivf_packets(path, pkts, w, h)
    return path.read_bytes()


INTRA_CASES = ["angular_cfl", "hbd10", "i444_odd", "mono", "sb64",
               "screen_palette", "tiles", "mixed", *EXTRA_INTRA]


@pytest.mark.parametrize("name", INTRA_CASES)
def test_device_intra_matches_jax_host(tmp_path, name):
    """The port with device_intra=True (phase B by wavefront levels, the
    plain walk on the CPU) on every tests/test_device_intra.CASES
    stream, on test_mixed_stream's recipe and on 4:2:2 and 12-bit key
    frames: the JAX host tier's md5, every frame on the device schedule,
    its units counted."""
    from dav1d_tpu_torch import devrt

    if name == "mixed":
        data = _mixed_stream(tmp_path)
    elif name in EXTRA_INTRA:
        data = _extra_intra(tmp_path, name)
    else:
        data = _intra_case(tmp_path, name)
    with _device_env(DAV1D_TPU_DEVICE="0"):
        host = _jax_md5(data)
    port = _port_md5(data, device_intra=True)
    counts = dict(devrt.COUNTS)
    assert port == host, f"{name}: device intra diverges from the JAX host"
    assert counts.get("intra_host_frames", 0) == 0, counts
    units = sum(counts.get(f"intra_{k}_units", 0)
                for k in ("pred", "cfl", "pal"))
    assert units > 0 and counts["intra_levels"] > 0, counts
    # one walk per chain holding units: at most two a frame
    assert 0 < counts["intra_walk_launches"] <= 2 * port[0], counts
    if name == "screen_palette":
        assert counts["intra_pal_units"] > 0, counts


@pytest.mark.parametrize("name", ["hbd10_128x96.ivf",
                                  "screen_1080p_8bit.ivf"])
def test_committed_stream_md5_device_intra(name):
    """The committed 10-bit stream (its key frame holds a CFL unit) and
    the palette stream decode to their committed md5 with device_intra
    on the CPU."""
    from dav1d_tpu_torch import devrt

    want = json.loads((DATA / "md5.json").read_text())[name]
    n, md5 = _port_md5((DATA / name).read_bytes(), device_intra=True)
    assert (n, md5) == (want["frames"], want["md5"])
    kind = "cfl" if name.startswith("hbd10") else "pal"
    assert devrt.COUNTS[f"intra_{kind}_units"] > 0, dict(devrt.COUNTS)
    assert devrt.COUNTS["intra_host_frames"] == 0


def test_grain_hbd10_matches_jax():
    """A 10-bit film-grain stream (the grain case's option at 10-bit):
    the port's plain grain path equals the JAX host tier."""
    w, h, n = 128, 96, 3
    enc = AomEncoder(width=w, height=h, usage="good", kf_max_dist=9999,
                     bitdepth=10, options={"denoise-noise-level": 25})
    pkts = enc.encode(gradient_frames(n, w, h, bitdepth=10))
    enc.close()
    import io
    import struct

    buf = io.BytesIO()
    buf.write(struct.pack("<4sHH4sHHIII", b"DKIF", 0, 32, b"AV01", w, h,
                          30, 1, len(pkts)))
    buf.write(b"\0\0\0\0")
    for pts, d in pkts:
        buf.write(struct.pack("<IQ", len(d), pts))
        buf.write(d)
    data = buf.getvalue()
    with _device_env(DAV1D_TPU_DEVICE="0"):
        host = _jax_md5(data)
    assert _port_md5(data) == host


def _decode_all(data, **kw):
    from dav1d_tpu_torch.decoder import Decoder, Settings

    dec = Decoder(Settings(two_pass=True, max_frame_delay=4), device="cpu",
                  **kw)
    for tu, _ in read_ivf(data):
        dec.send_data(tu)
        while dec.get_picture() is not None:
            pass


def test_device_intra_failure_raises(tmp_path, monkeypatch):
    """No fallback: a failing launch in the device intra stage raises out
    of the decode (the reference degrades to its host walk instead,
    tests/test_device_intra.test_sticky_fallback_on_device_failure)."""
    from dav1d_tpu_torch.ops import ipred

    def failing(*args, **kw):
        raise RuntimeError("ipred_walk: CUDA launch failed: 719")

    monkeypatch.setattr(ipred, "walk", failing)
    with pytest.raises(RuntimeError,
                       match="ipred_walk: CUDA launch failed"):
        _decode_all(_intra_case(tmp_path, "angular_cfl"),
                    device_intra=True)


def test_grain_failure_raises(monkeypatch):
    """No fallback: a failing film-grain launch raises out of
    get_picture."""
    from dav1d_tpu_torch.ops import fg

    def failing(*args, **kw):
        raise RuntimeError("fg: CUDA launch failed: 719")

    monkeypatch.setattr(fg, "apply_plane", failing)
    with pytest.raises(RuntimeError, match="fg: CUDA launch failed"):
        _decode_all((DATA / "grain_hbd10_352x288.ivf").read_bytes())


def test_device_intra_on_cuda_without_cuda_raises():
    import torch

    from dav1d_tpu_torch.decoder import Decoder, Settings

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Decoder(Settings(two_pass=True, max_frame_delay=4), device="cuda",
                device_intra=True)


@pytest.mark.parametrize("kind,interintra", [(2, 0), (1, 1)])
def test_schedule_leaves_intrabc_and_interintra_to_the_host(kind,
                                                            interintra):
    """The device intra schedule covers no frame with an intrabc block
    (it copies from the canvas in decode order) or an interintra block
    (phase A leaves it to the ordered walk): _enumerate_units returns
    None there, and a plain inter block alone schedules nothing."""
    import types

    import numpy as np

    from dav1d_tpu_torch.headers import PixelLayout
    from dav1d_tpu_torch.native.decode_glue import CAP_BLOCK_DT
    from dav1d_tpu_torch.recon import device_intra

    rows = np.zeros(2, CAP_BLOCK_DT)
    rows["kind"] = 1
    rows[1]["kind"], rows[1]["interintra_type"] = kind, interintra
    glue = types.SimpleNamespace(cap_blocks=rows)
    f = types.SimpleNamespace(
        ss_ver=1, ss_hor=1, layout=PixelLayout.I420, bitdepth=8, bw=8,
        bh=8, seq_hdr=types.SimpleNamespace(intra_edge_filter=1),
        planes=[np.zeros((32, 32), np.int32)] + [np.zeros((16, 16),
                                                          np.int32)] * 2)
    assert device_intra._enumerate_units(f, glue, [(0, 2)]) == (None, None)
    sched, _ = device_intra._enumerate_units(f, glue, [(0, 1)])
    assert sched == [{}, {}]


def test_host_walk_frames_are_counted(tmp_path, monkeypatch):
    """A frame the device schedule does not cover goes to the host walk:
    the same output, counted in intra_host_frames, no unit launched."""
    from dav1d_tpu_torch import devrt
    from dav1d_tpu_torch.recon import device_intra

    monkeypatch.setattr(device_intra, "_enumerate_units",
                        lambda f, glue, ranges: (None, None))
    data = _intra_case(tmp_path, "sb64")
    with _device_env(DAV1D_TPU_DEVICE="0"):
        host = _jax_md5(data)
    assert _port_md5(data, device_intra=True) == host
    assert devrt.COUNTS["intra_host_frames"] == host[0]
    assert not any(k.endswith("_units") and k.startswith("intra_")
                   for k in devrt.COUNTS), dict(devrt.COUNTS)
