"""Decoders with a planted fault, for the tests that see ``correct`` come
out false: each wraps the program's decoder and breaks what it returns
where it is produced.  Named to the harness as ``faults:<Class>``."""

from __future__ import annotations

import numpy as np

from dav1d_tpu_torch.decoder import Decoder


class StaleDecoder(Decoder):
    """A step that returns its state unchanged: from the third picture on,
    every picture is the one returned before it."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._n, self._last = 0, None

    def get_picture(self):
        pic = super().get_picture()
        if pic is None:
            return None
        self._n += 1
        if self._n >= 3 and self._last is not None:
            pic.planes = [np.array(p) for p in self._last]
        self._last = [np.array(p) for p in pic.planes]
        return pic


class HalfDecoder(Decoder):
    """Half of the work left out: every other picture is never returned."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self._n = 0

    def get_picture(self):
        pic = super().get_picture()
        self._n += 1
        return None if self._n % 2 == 0 else pic


class GridPixelDecoder(Decoder):
    """An answer altered where it is produced: a pixel on the fingerprint's
    grid of every picture's luma, plus one."""

    at = (0, 0)

    def get_picture(self):
        pic = super().get_picture()
        if pic is not None:
            y = np.array(pic.planes[0])
            y[self.at] += 1
            pic.planes = [y] + list(pic.planes[1:])
        return pic


class OffGridPixelDecoder(GridPixelDecoder):
    """As :class:`GridPixelDecoder`, at a pixel off the fingerprint's grid:
    only the sampled pictures' digests can see it."""

    at = (5, 7)
