"""The one generator of load.  A traffic mix is a file of parameters,
``traffic/<mix>.json``; :func:`parse_mix` checks it and :func:`requests`
turns it, with the seed, into the requests each session sends.  The
harness (``harness.py``) sends them.

A mix gives every key below; a key that is not one of them, or a value
outside its kind, is refused:

* ``processes`` (whole number >= 1): sessions, one process each (1 runs
  in the benchmark's own process);
* ``in_flight`` (whole number >= 1): temporal units a session keeps sent
  and not yet answered before it waits for a picture (the frame delay
  it drives);
* ``decoder``: ``"session"``, one decoder a session, opened in set-up,
  through which its requests follow one another as one stream; or
  ``"request"``, a decoder opened for each request and closed once the
  request's last picture is returned (a loader's clip);
* ``order``: ``"loop"``, the clips in one fixed order, session ``i``
  starting ``i`` clips further on (a window then holds the same pictures
  whatever the seed); or ``"shuffle"``, epochs of the clips, each a
  permutation drawn from the seed (a loader's shuffle);
* ``frames``: the pictures a request delivers, or null for the rest of
  its clip;
* ``start``: ``"key"``, a request starts at its clip's key frame, the
  clip's first unit; or ``"seek"``, at a picture drawn from the seed
  inside the clip, decoded from the key frame before it: the pictures
  before it are decoded and judged but not delivered;
* ``pace_fps``: null, a closed loop (each unit sent as soon as
  ``in_flight`` allows); or a rate, an open loop: a session's ``k``-th
  unit of the window is not sent before ``k / pace_fps`` seconds after
  the window's start.  A delivered picture is due ``in_flight /
  pace_fps`` seconds after its unit was due (a player's buffer of its
  frame delay); its lateness is the time it was returned less that;
* ``why`` (optional): one line on what the mix stands for.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

DECODERS = ("session", "request")
ORDERS = ("loop", "shuffle")
STARTS = ("key", "seek")


@dataclass(frozen=True)
class Mix:
    processes: int
    in_flight: int
    decoder: str
    order: str
    frames: int | None
    start: str
    pace_fps: float | None


@dataclass(frozen=True)
class Request:
    """One request: temporal units ``0 .. units - 1`` of ``clip`` sent,
    the pictures of units ``deliver_from`` on delivered."""

    clip: int
    units: int
    deliver_from: int


def _whole(v, key, least):
    if isinstance(v, bool) or not isinstance(v, int) or v < least:
        raise ValueError(f"traffic {key}: {v!r} is not a whole number >= "
                         f"{least}")
    return v


def _one_of(v, key, allowed):
    if v not in allowed:
        raise ValueError(f"traffic {key}: {v!r} is not one of {allowed}")
    return v


def parse_mix(d: dict) -> Mix:
    """The mix of a traffic file's parameters; ValueError on a key that is
    missing or unknown, or on a value outside its kind."""
    keys = {"processes", "in_flight", "decoder", "order", "frames", "start",
            "pace_fps"}
    unknown = set(d) - keys - {"why"}
    if unknown:
        raise ValueError(f"traffic: unknown keys {sorted(unknown)}; a mix "
                         f"has {sorted(keys)} and why")
    missing = keys - set(d)
    if missing:
        raise ValueError(f"traffic: missing keys {sorted(missing)}")
    pace = d["pace_fps"]
    if pace is not None and (isinstance(pace, bool)
                             or not isinstance(pace, (int, float))
                             or not pace > 0):
        raise ValueError(f"traffic pace_fps: {pace!r} is neither null nor "
                         "a rate above 0")
    return Mix(processes=_whole(d["processes"], "processes", 1),
               in_flight=_whole(d["in_flight"], "in_flight", 1),
               decoder=_one_of(d["decoder"], "decoder", DECODERS),
               order=_one_of(d["order"], "order", ORDERS),
               frames=(None if d["frames"] is None
                       else _whole(d["frames"], "frames", 1)),
               start=_one_of(d["start"], "start", STARTS),
               pace_fps=None if pace is None else float(pace))


def order(seed: int, n_clips: int, index: int, kind: str):
    """The clips session ``index`` requests, one after another, without
    end.  ``loop``: ``index`` clips on, then round; ``shuffle``: seeded
    permutations."""
    if kind == "loop":
        k = index % n_clips
        while True:
            yield from range(k, n_clips)
            yield from range(k)
    rng = np.random.default_rng([seed, 1, index])
    while True:
        yield from (int(c) for c in rng.permutation(n_clips))


def requests(mix: Mix, seed: int, index: int, clip_units: list):
    """The requests of session ``index``, without end; ``clip_units``:
    the temporal units of each clip.  A seek start is drawn so that the
    request's ``frames`` pictures fit after it (uniform over the
    pictures after the key frame where they do)."""
    starts = np.random.default_rng([seed, 3, index])
    for clip in order(seed, len(clip_units), index, mix.order):
        n = clip_units[clip]
        first = 0
        if mix.start == "seek":
            room = n - (mix.frames or 1)
            first = int(starts.integers(1, room + 1)) if room >= 1 else 0
        take = n - first if mix.frames is None else min(mix.frames,
                                                        n - first)
        yield Request(clip, first + take, first)
