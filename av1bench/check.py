"""The comparison that decides ``correct``.

The reference is libaom's AV1 decoder, run by ``make_streams.py`` over
every committed clip: ``streams/<config>/reference.json`` holds, for
each picture it output, the MD5 of each plane (cropped, uint8 at 8-bit
and little-endian uint16 above) and a fingerprint (the sum of each
plane's pixels on a 16-pixel grid).  Nothing here imports the program
under test or takes anything it made: the program's pictures are only
read, to be judged.

A run judges what the timed window output:

* ``order``: every picture returned, in every session, is the one its
  temporal unit shows (one shown frame a temporal unit), by the
  fingerprint of each of its planes;
* ``pixels``: a sample of the pictures drawn from the seed, copied as
  they were returned and compared after the window has closed, by the
  MD5 of each plane, and every pixel inside ``[0, 2**bitdepth)``;
* ``count``: after the window every temporal unit sent has returned its
  picture (the decoder drained once the window has closed).

Each is a count of pictures at fault with the limit 0 (an exact
comparison).
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np

GRID = 16
LIMITS = {"order": 0, "pixels": 0, "count": 0}


def out_dtype(bitdepth: int):
    return np.uint8 if bitdepth == 8 else np.dtype("<u2")


def fingerprint(planes) -> list:
    """Sum of each plane's pixels on the ``GRID`` lattice."""
    return [int(np.asarray(p)[::GRID, ::GRID].sum(dtype=np.int64))
            for p in planes]


def md5s(planes, bitdepth: int) -> list:
    """MD5 of each plane in the output format."""
    dt = out_dtype(bitdepth)
    return [hashlib.md5(np.ascontiguousarray(p, dtype=dt)).hexdigest()
            for p in planes]


def in_range(planes, bitdepth: int) -> bool:
    top = 1 << bitdepth
    return all(int(p.min()) >= 0 and int(p.max()) < top for p in planes)


def load_reference(root: Path, config: dict) -> dict:
    """The config's reference digests: ``clips[i]["pictures"][k]`` holds
    ``md5`` and ``fp`` of the picture of temporal unit ``k``."""
    return json.loads((root / config["streams"] / "reference.json")
                      .read_text())


class Judge:
    """Counts the faults of one session's pictures against the reference.

    ``expect(clip, tu)`` registers the picture the next returned one has
    to be; ``seen(planes, keep)`` checks its fingerprint and, when
    ``keep``, copies its planes for :meth:`finish`."""

    def __init__(self, reference: dict, bitdepth: int):
        self.clips = reference["clips"]
        self.bitdepth = bitdepth
        self.due = []      # (clip, tu) of pictures not yet returned
        self.kept = []     # (clip, tu, planes copied)
        self.faults = {"order": 0, "pixels": 0, "count": 0}
        self.expected = 0
        self.compared = 0

    def expect(self, clip: int, tu: int) -> None:
        self.expected += 1
        self.due.append((clip, tu))

    def seen(self, planes, keep: bool) -> None:
        if not self.due:
            self.faults["order"] += 1  # a picture no unit asked for
            return
        clip, tu = self.due.pop(0)
        want = self.clips[clip]["pictures"][tu]
        if len(planes) != len(want["fp"]) or fingerprint(planes) != want["fp"]:
            self.faults["order"] += 1
        if keep:
            self.kept.append((clip, tu, [np.array(p) for p in planes]))

    def finish(self) -> dict:
        """Compare the kept pictures and count the pictures never
        returned; the faults by kind."""
        for clip, tu, planes in self.kept:
            want = self.clips[clip]["pictures"][tu]
            self.compared += 1
            if (len(planes) != len(want["md5"])
                    or not in_range(planes, self.bitdepth)
                    or md5s(planes, self.bitdepth) != want["md5"]):
                self.faults["pixels"] += 1
        self.kept = []
        self.faults["count"] += len(self.due)
        return dict(self.faults)


def verdict(faults: dict) -> dict:
    """Each number compared beside its limit."""
    return {k: {"value": faults[k], "limit": LIMITS[k]} for k in LIMITS}


def correct(faults: dict) -> bool:
    return all(faults[k] <= LIMITS[k] for k in LIMITS)
