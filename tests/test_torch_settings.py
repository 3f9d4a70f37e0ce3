"""Decoder settings of dav1d_tpu_torch against the JAX package, md5 for
md5 (the checks of tests/test_api.py, test_threads.py, test_svc.py and
test_fuzz.py, run on both packages).

Every case runs one script of actions (send a temporal unit with or
without DataProps, flush) through the port's ``Decoder(settings,
device="cpu")`` and through the JAX package's ``Decoder(settings)`` on
its host tier (DAV1D_TPU_DEVICE=0), draining the pictures after every
send.  The two traces must be equal: per action, the md5 of every plane
of every picture with its size, visibility and props, or the class of
the exception the action raised (``dav1d_tpu_torch.obu.ObuError`` stands
for ``dav1d_tpu.obu.ObuError``).  A script goes on after an exception,
so a decoder that fails on a temporal unit is also held on what it does
next.

Streams: the committed ``hbd10_128x96.ivf`` (10-bit) and
``grain_hbd10_352x288.ivf`` (film grain), ``i422_8bit_256x192.ivf``
(loop restoration units, which the inloop_filters mask's bit 4 turns
off), a 128x96 8-bit libaom stream with key frames at 0 and 4
(tests/test_api.py:_stream), the same content coded with a 16-frame
lag (hidden alt-ref frames and shown existing ones, for
output_invisible_frames and the thread settings), and the
2-spatial-layer avgen SVC stream of tests/test_svc.py:20.

Settings covered: inloop_filters 0-7 with two-pass on and off;
decode_frame_type 1-3; apply_grain; output_invisible_frames;
frame_size_limit (refusal); max_frame_delay 0/4 with n_threads 0/4;
flush and seek to the mid-stream key frame; DataProps and
decode_error_props; logger messages; operating points 0/1 with
all_layers 0/1; and corrupt input: random bytes, truncated temporal
units, bit flips, an error followed by flush and recovery."""

import hashlib
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "dav1d_tpu_torch" / "data"
sys.path.insert(0, str(REPO / "tools"))

from aom_enc import AomEncoder, gradient_frames  # noqa: E402
from avgen.stream import StreamConfig, make_svc_stream  # noqa: E402
from test_e2e_intra import random_decide  # noqa: E402

DEVICE_VARS = ("DAV1D_TPU_DEVICE", "DAV1D_TPU_DEVICE_MC",
               "DAV1D_TPU_DEVICE_ITX", "DAV1D_TPU_DEVICE_IPRED")


@pytest.fixture(scope="module", autouse=True)
def _host_tier():
    """The JAX package on its host tier, the port on one torch thread,
    for the module; both restored afterwards."""
    from dav1d_tpu.dispatch import use_device

    saved = {k: os.environ.get(k) for k in DEVICE_VARS}
    threads = torch.get_num_threads()
    for k in DEVICE_VARS:
        os.environ.pop(k, None)
    os.environ["DAV1D_TPU_DEVICE"] = "0"
    use_device.cache_clear()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    use_device.cache_clear()


def _aom(n, kf, lag):
    enc = AomEncoder(width=128, height=96, usage="good", cpu_used=6, q=40,
                     kf_max_dist=kf, lag=lag)
    pkts = enc.encode(gradient_frames(n, 128, 96))
    enc.close()
    return [d for _, d in pkts]


@pytest.fixture(scope="module")
def streams():
    from dav1d_tpu_torch.containers import read_ivf

    out = {name: [tu for tu, _ in read_ivf((DATA / name).read_bytes())]
           for name in ("hbd10_128x96.ivf", "grain_hbd10_352x288.ivf",
                        "i422_8bit_256x192.ivf")}
    out["seek8"] = _aom(8, 4, 0)
    out["hidden8"] = _aom(8, 9999, 16)
    cfg = StreamConfig(width=96, height=80, qidx=90, seed=11,
                       operating_points=(0x301, 0x101))
    out["svc"] = make_svc_stream(cfg, random_decide(5), 3)[0]
    return out


def _modules(port):
    if port:
        from dav1d_tpu_torch import decoder
    else:
        from dav1d_tpu import decoder
    return decoder


def _exc_class(e):
    mod = type(e).__module__
    if mod.split(".")[0] == "dav1d_tpu_torch":
        mod = "dav1d_tpu" + mod[len("dav1d_tpu_torch"):]
    return f"{mod}.{type(e).__qualname__}"


def _picture(p):
    props = None
    if p.props is not None:
        props = (p.props.timestamp, p.props.duration, p.props.offset,
                 p.props.size, p.props.user_data)
    return (tuple(hashlib.md5(p.plane_bytes(pl)).hexdigest()
                  for pl in range(len(p.planes))),
            p.width, p.height, p.bitdepth, bool(p.visible), props)


def trace(port, kw, script, log=None):
    """Run ``script`` through a decoder of the port (``port``) or of the
    JAX package with ``Settings(**kw)``: a list of ("send", data[,
    props kwargs]) and ("flush",) actions.  Returns one entry per action:
    the pictures drained after it, or ("raise", exception class)."""
    mod = _modules(port)
    if log is not None:
        kw = dict(kw, logger=log.append)
    settings = mod.Settings(**kw)
    dec = mod.Decoder(settings, device="cpu") if port else \
        mod.Decoder(settings)
    out = []
    for act in script:
        try:
            if act[0] == "flush":
                dec.flush()
                out.append("flushed")
                continue
            props = mod.DataProps(**act[2]) if len(act) > 2 else None
            dec.send_data(act[1], props=props)
            pics = []
            while (p := dec.get_picture()) is not None:
                pics.append(_picture(p))
            out.append(pics)
        except Exception as e:  # noqa: BLE001 (the class is compared)
            assert not isinstance(e, (SystemError, MemoryError)), e
            out.append(("raise", _exc_class(e)))
    err = dec.decode_error_props
    out.append(("error_props", None if err is None else
                (err.timestamp, err.offset, err.size)))
    dec.close()
    return out


def _same(kw, script, min_pictures=1):
    jax = trace(False, kw, script)
    port = trace(True, kw, script)
    assert port == jax
    n = sum(len(a) for a in jax if isinstance(a, list))
    assert n >= min_pictures, jax
    return jax


def _sends(tus):
    return [("send", tu) for tu in tus]


# ---- settings ------------------------------------------------------------

ILF_STREAMS = ("seek8", "hbd10_128x96.ivf", "i422_8bit_256x192.ivf")


@pytest.mark.parametrize("two_pass", [False, True])
@pytest.mark.parametrize("mask", range(8))
@pytest.mark.parametrize("name", ILF_STREAMS)
def test_inloop_filters(streams, name, mask, two_pass):
    _same(dict(inloop_filters=mask, two_pass=two_pass,
               max_frame_delay=4), _sends(streams[name]))


@pytest.mark.parametrize("name", ILF_STREAMS)
def test_inloop_filters_change_output(streams, name):
    """Each stream's filters do something: the full mask and no filter
    give different pictures, so the mask cases above test the filters."""
    tus = _sends(streams[name])
    full = trace(True, dict(inloop_filters=7), tus)
    assert full != trace(True, dict(inloop_filters=0), tus)
    if name == "i422_8bit_256x192.ivf":  # restoration units
        assert full != trace(True, dict(inloop_filters=3), tus)


@pytest.mark.parametrize("two_pass", [False, True])
@pytest.mark.parametrize("dft", [1, 2, 3])
def test_decode_frame_type(streams, dft, two_pass):
    got = _same(dict(decode_frame_type=dft, two_pass=two_pass),
                _sends(streams["seek8"]))
    if dft == 3:  # the key frames at 0 and 4 only
        assert sum(len(a) for a in got if isinstance(a, list)) == 2


@pytest.mark.parametrize("two_pass", [False, True])
@pytest.mark.parametrize("grain", [False, True])
def test_apply_grain(streams, grain, two_pass):
    _same(dict(apply_grain=grain, two_pass=two_pass),
          _sends(streams["grain_hbd10_352x288.ivf"]))


@pytest.mark.parametrize("invisible", [False, True])
def test_output_invisible_frames(streams, invisible):
    got = _same(dict(output_invisible_frames=invisible, two_pass=True),
                _sends(streams["hidden8"]))
    hidden = [p for a in got if isinstance(a, list) for p in a if not p[4]]
    assert bool(hidden) == invisible


def test_frame_size_limit(streams):
    tus = _sends(streams["seek8"][:2])
    got = _same(dict(frame_size_limit=64 * 64), tus, min_pictures=0)
    assert got[0] == ("raise", "dav1d_tpu.obu.ObuError")
    _same(dict(frame_size_limit=1 << 20), tus, min_pictures=2)


@pytest.mark.parametrize("n_threads", [0, 4])
@pytest.mark.parametrize("delay", [0, 4])
@pytest.mark.parametrize("name", ["seek8", "hbd10_128x96.ivf", "hidden8"])
def test_frame_delay_and_threads(streams, name, delay, n_threads):
    for two_pass in (False, True):
        _same(dict(max_frame_delay=delay, n_threads=n_threads,
                   two_pass=two_pass), _sends(streams[name]))


@pytest.mark.parametrize("two_pass", [False, True])
def test_flush_and_seek(streams, two_pass):
    """Two temporal units, flush, then the mid-stream key frame on."""
    tus = streams["seek8"]
    got = _same(dict(two_pass=two_pass, max_frame_delay=4),
                _sends(tus[:2]) + [("flush",)] + _sends(tus[4:]))
    whole = trace(True, dict(two_pass=two_pass), _sends(tus))
    assert got[3:7] == whole[4:8]


def test_data_props_and_error_props(streams):
    tus = streams["seek8"]
    script = [("send", tu, dict(timestamp=1000 + i, offset=i,
                                user_data=("tag", i)))
              for i, tu in enumerate(tus[:3])]
    got = _same({}, script, min_pictures=3)
    assert got[-1] == ("error_props", None)
    bad = bytearray(tus[1])
    bad[len(bad) // 2:] = b"\xff" * (len(bad) - len(bad) // 2)
    for two_pass in (False, True):
        got = _same(dict(two_pass=two_pass),
                    [("send", tus[0], dict(timestamp=7)),
                     ("send", bytes(bad), dict(timestamp=8, offset=1))])
        assert got[-1][1][:2] == (8, 1)


def test_logger(streams):
    """The same messages, in order, through the logger (decode errors,
    and the memory lines at close: their numbers are process-wide, so
    only their category names are compared)."""
    script = [("send", bytes([0x0A, 0x02, 0xFF]))] + \
        _sends(streams["seek8"][:2])
    logs = [[], []]
    got = [trace(port, {}, script, log=logs[port]) for port in (False, True)]
    assert got[1] == got[0] and got[0][0][0] == "raise"

    def words(msgs):
        return [m.split()[:2] if m.startswith("memory:") else m
                for m in msgs]

    assert words(logs[1]) == words(logs[0])
    assert logs[0] and "error" in logs[0][0]
    assert any(m.startswith("memory:") for m in logs[0])


@pytest.mark.parametrize("invisible", [False, True])
@pytest.mark.parametrize("all_layers", [False, True])
@pytest.mark.parametrize("op", [0, 1])
def test_operating_points(streams, op, all_layers, invisible):
    # operating point 1 is the base layer alone, whose key frames are
    # coded not shown
    _same(dict(operating_point=op, all_layers=all_layers,
               output_invisible_frames=invisible),
          _sends(streams["svc"]), min_pictures=int(op == 0 or invisible))


# ---- corrupt input (tests/test_fuzz.py) ------------------------------------

def test_random_bytes():
    rng = np.random.default_rng(1234)
    for _ in range(40):
        blob = rng.integers(0, 256, rng.integers(1, 300),
                            dtype=np.uint8).tobytes()
        _same({}, [("send", blob)], min_pictures=0)


@pytest.mark.parametrize("two_pass", [False, True])
def test_truncated_temporal_units(streams, two_pass):
    tus = streams["seek8"]
    for tu in (tus[0], tus[1]):
        for cut in range(0, len(tu), max(1, len(tu) // 23)):
            _same(dict(two_pass=two_pass),
                  _sends(tus[:1] if tu is tus[1] else []) +
                  [("send", tu[:cut])], min_pictures=0)


@pytest.mark.parametrize("two_pass", [False, True])
def test_bitflips(streams, two_pass):
    tus = streams["seek8"]
    rng = np.random.default_rng(7)
    for trial in range(25):
        blob = bytearray(tus[trial % len(tus)])
        for _ in range(3):
            pos = rng.integers(2, len(blob))
            blob[pos] ^= 1 << rng.integers(0, 8)
        _same(dict(two_pass=two_pass), [("send", bytes(blob))],
              min_pictures=0)


@pytest.mark.parametrize("two_pass", [False, True])
def test_error_then_recovery(streams, two_pass):
    """A broken key frame, a flush, then the next key frame on: the same
    error and, after it, the same pictures."""
    tus = streams["seek8"]
    bad = bytearray(tus[0])
    bad[len(bad) // 2] ^= 0xFF
    got = _same(dict(two_pass=two_pass),
                [("send", bytes(bad))] + _sends(tus[1:2]) + [("flush",)]
                + _sends(tus[4:]), min_pictures=4)
    assert sum(len(a) for a in got[3:7]) == 4
