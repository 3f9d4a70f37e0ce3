"""The port's frame pipeline, with a worker pool (``n_threads >= 2``)
and without one: a frame's finish is an output entry as soon as its
pass 1 ends (on the workers, or deferred to the caller's thread), a
shown existing frame waits in output order behind the frames in flight,
with no drain, and ``flush()`` finishes the frames in flight, so a
decode restarted after it never waits on a reference slot that nothing
will fill.

The stream is the benchmark's small film-grain clip
(``av1bench/tests/data/tiny10g/clip0.ivf``: 160x96 10-bit 4:2:0, 12
temporal units, 4 of which show an existing frame, 16 frames decoded),
decoded on the CPU with the benchmark's settings, 4 units in flight as
the benchmark's stream cells keep them.  Pictures are held against
libaom's digests (``reference.json``, each plane's MD5 as
``av1bench/check.py`` takes it) and across thread counts; the producer
of the first shown existing frame is held on its worker (or made to
fail) through a wrapped ``decode_frame_finish``."""

import importlib.util
import json
import threading
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
CLIP = REPO / "av1bench" / "tests" / "data" / "tiny10g"
IN_FLIGHT = 4
TIMEOUT = 30.0  # seconds; a hung pipeline fails the test instead


def _check():
    spec = importlib.util.spec_from_file_location(
        "av1bench_check", REPO / "av1bench" / "check.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHECK = _check()


@pytest.fixture(scope="module")
def clip():
    """The clip's units, libaom's digests, the units that show an
    existing frame, a decode without workers, and the decode index of
    the frame the first shown existing frame shows (its picture's
    ``frame_id`` in that decode)."""
    from dav1d_tpu_torch.containers import open_stream

    ref = json.loads((CLIP / "reference.json").read_text())["clips"][0]
    tus = [tu for tu, _ in open_stream((CLIP / "clip0.ivf").read_bytes())]
    shown = [i for i, s in enumerate(ref["shows_existing"]) if s]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the suite's workers share the cores
    serial = _decode(tus, 0, 0)
    yield {"tus": tus, "md5": [p["md5"] for p in ref["pictures"]],
           "shown": shown, "serial": [_md5s(p) for p in serial],
           "producer": serial[shown[0]].frame_id[1]}
    torch.set_num_threads(threads)


def _decoder(n_threads, delay):
    from dav1d_tpu_torch.decoder import Decoder, Settings

    return Decoder(Settings(two_pass=True, n_threads=n_threads,
                            max_frame_delay=delay, apply_grain=True),
                   device="cpu")


def _md5s(pic):
    return CHECK.md5s(pic.planes, pic.bitdepth)


def _decode(tus, n_threads, delay):
    """Every picture of ``tus``, ``IN_FLIGHT`` units in flight."""
    dec = _decoder(n_threads, delay)
    pics, waiting = [], 0
    for tu in tus:
        dec.send_data(tu)
        waiting += 1
        if waiting >= IN_FLIGHT:
            pics.append(dec.get_picture())
            waiting -= 1
    while (p := dec.get_picture()) is not None:
        pics.append(p)
    dec.close()
    return pics


def _counts():
    from dav1d_tpu_torch import devrt

    return {k: devrt.COUNTS[k] for k in ("frames.drains",
                                         "frames.existing_queued")}


def _moved(before):
    return {k: v - before[k] for k, v in _counts().items()}


# the pool's cases keep the ids they had before the serial ones came
@pytest.mark.parametrize("n_threads, delay", [
    pytest.param(4, 4, id="4"), pytest.param(4, 0, id="0"),
    pytest.param(0, 4, id="serial-4"), pytest.param(0, 0, id="serial-0")])
def test_shown_existing_frames_queue_without_a_drain(clip, n_threads,
                                                     delay):
    before = _counts()
    pics = _decode(clip["tus"], n_threads, delay)
    moved = _moved(before)
    assert [_md5s(p) for p in pics] == clip["md5"] == clip["serial"]
    assert len(clip["shown"]) == 4
    assert moved == {"frames.drains": 0, "frames.existing_queued": 4}


class _Hold:
    """Wraps ``decode_frame_finish``: frame ``index`` of the decoder whose
    serial is ``serial`` waits on ``release`` (then raises where
    ``fail``); ``started`` and ``finished`` mark its work."""

    def __init__(self, monkeypatch, index):
        from dav1d_tpu_torch import decoder

        self.index, self.serial = index, None
        self.release, self.fail = threading.Event(), False
        self.started, self.finished = threading.Event(), threading.Event()
        inner = decoder.decode_frame_finish

        def finish(f):
            if f._id != (self.serial, self.index):
                return inner(f)
            self.started.set()
            try:
                assert self.release.wait(TIMEOUT), "never released"
                if self.fail:
                    raise RuntimeError("planted producer fault")
                return inner(f)
            finally:
                self.finished.set()

        monkeypatch.setattr(decoder, "decode_frame_finish", finish)


def _sends_while_held(clip, hold, dec):
    """Send the units up to the first shown existing frame's, on a
    thread of their own; True where they all returned in time while the
    producer was still held on its worker."""
    hold.serial = dec._serial
    done = threading.Event()

    def sends():
        for tu in clip["tus"][:clip["shown"][0] + 1]:
            dec.send_data(tu)
        done.set()

    t = threading.Thread(target=sends)
    t.start()
    returned = done.wait(TIMEOUT / 3)
    held = hold.started.is_set() and not hold.finished.is_set()
    hold.release.set()
    t.join(TIMEOUT)
    assert not t.is_alive()
    return returned and held


@pytest.mark.parametrize("delay", [4, 0])
def test_send_returns_while_the_producer_is_held(clip, monkeypatch, delay):
    hold = _Hold(monkeypatch, clip["producer"])
    dec = _decoder(4, delay)
    before = _counts()
    assert _sends_while_held(clip, hold, dec)
    assert _moved(before)["frames.existing_queued"] == 1
    pics = []
    while (p := dec.get_picture()) is not None:
        pics.append(p)
    for tu in clip["tus"][clip["shown"][0] + 1:]:
        dec.send_data(tu)
        while (p := dec.get_picture()) is not None:
            pics.append(p)
    dec.close()
    assert [_md5s(p) for p in pics] == clip["md5"]
    assert _moved(before)["frames.drains"] == 0


def test_failed_producer_raises_and_flush_recovers(clip, monkeypatch):
    from dav1d_tpu_torch.obu import ObuError

    hold = _Hold(monkeypatch, clip["producer"])
    hold.fail = True
    dec = _decoder(4, 4)
    assert _sends_while_held(clip, hold, dec)
    # the pictures in order up to the failed producer's entry, which
    # raises its own fault; the shown existing frame's entry raises
    # ObuError when reached; then the list is empty
    outcomes = []
    for _ in range(2 * len(clip["tus"])):
        try:
            p = dec.get_picture()
        except Exception as e:  # noqa: BLE001 (the class is checked)
            outcomes.append(e)
            continue
        if p is None:
            break
        outcomes.append(_md5s(p))
    errors = [o for o in outcomes if isinstance(o, Exception)]
    assert isinstance(errors[0], RuntimeError), outcomes
    assert "planted" in str(errors[0])
    assert isinstance(errors[-1], ObuError), outcomes
    assert outcomes[0] == clip["md5"][0]
    assert dec.get_picture() is None
    dec.flush()
    pics = []
    for tu in clip["tus"]:
        dec.send_data(tu)
        while (p := dec.get_picture()) is not None:
            pics.append(p)
    dec.close()
    assert [_md5s(p) for p in pics] == clip["md5"]


FLUSH_CUTS = (1, 2, 6, 8)  # units sent before the flush


def _guarded(fn):
    """``fn()`` on a thread of its own; fails where it has not returned
    within ``TIMEOUT``."""
    out = []
    t = threading.Thread(target=lambda: out.append(fn()), daemon=True)
    t.start()
    t.join(TIMEOUT)
    assert not t.is_alive(), "the decode hung"
    assert out, "the decode raised on its thread"
    return out[0]


def _flushed(tus, n_threads, k):
    """The outcomes of a decode that sends ``k`` units, flushes, then
    sends the rest and drains: each picture's md5s, or the class name of
    what a call raised."""
    dec = _decoder(n_threads, 4)
    out = []
    for tu in tus[:k]:
        dec.send_data(tu)
    dec.flush()
    for tu in tus[k:]:
        try:
            dec.send_data(tu)
        except Exception as e:  # noqa: BLE001 (the class is compared)
            out.append(type(e).__name__)
        while True:
            try:
                p = dec.get_picture()
            except Exception as e:  # noqa: BLE001
                out.append(type(e).__name__)
                continue
            if p is None:
                break
            out.append(_md5s(p))
    dec.close()
    return out


@pytest.fixture(scope="module")
def flushed(clip):
    """``(n_threads, k) -> outcomes`` of :func:`_flushed`, each decode
    run once, under the hang guard."""
    memo = {}

    def get(n_threads, k):
        if (n_threads, k) not in memo:
            memo[n_threads, k] = _guarded(
                lambda: _flushed(clip["tus"], n_threads, k))
        return memo[n_threads, k]
    return get


@pytest.mark.parametrize("n_threads", [0, 4])
def test_flush_with_frames_in_flight(clip, flushed, n_threads):
    other = 4 if n_threads == 0 else 0
    for k in FLUSH_CUTS:
        got = flushed(n_threads, k)
        assert got == flushed(other, k), k
        # the flushed units' pictures are dropped, the rest are exact
        assert got == clip["md5"][k:], k
