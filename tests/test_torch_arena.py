"""The port's tile-sliced capture arenas (dav1d_tpu_torch/native/
decode_glue.py), on the CPU.

With ``n_threads >= 2`` and more than one tile, pass 1 cuts every
capture arena into one slice a tile; between a tile's used prefix and
the next slice lies a gap that no tile writes.  These tests hold that
the gap counts as unused:

* the residual stage transforms the same blocks at ``n_threads`` 0, 2
  and 4 (``devrt.COUNTS["itx_blocks"]`` and the meta rows with
  coefficients that the frame's blocks own), counts no gap rows at
  ``n_threads`` 0 (``arena.gap_rows``), and the output keeps its
  committed md5, on the committed tiled streams;
* ``release`` re-zeroes each tile's used slice of every arena and
  nothing else (``arena.cleared_bytes``), every pooled arena reads
  all-zero afterwards, and a second decoder on the recycled arenas
  decodes the stream to the same md5."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

DATA = Path(__file__).resolve().parent.parent / "dav1d_tpu_torch" / "data"
FEATURES = DATA / "features"

# the committed tiled streams small enough for the suite, with the
# transform blocks their serial decode runs
TILED = {
    DATA / "tiles2x2_256x192.ivf": 983,
    FEATURES / "tiles_2x2.ivf": 1273,
    FEATURES / "tiles_full.ivf": 1154,
}


def _want_md5(path):
    return json.loads((path.parent / "md5.json").read_text())[path.name]


def _decode(path, n_threads):
    """The port's (frames, md5) of a committed stream on the CPU, on one
    torch thread, with ``devrt.COUNTS`` cleared before."""
    from dav1d_tpu_torch import devrt
    from dav1d_tpu_torch.containers import read_ivf
    from dav1d_tpu_torch.decoder import Decoder, Settings

    devrt.COUNTS.clear()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        dec = Decoder(Settings(two_pass=True, max_frame_delay=4,
                               n_threads=n_threads), device="cpu")
        h, n = hashlib.md5(), 0
        for tu, _ in read_ivf(path.read_bytes()):
            dec.send_data(tu)
            while (pic := dec.get_picture()) is not None:
                for pl in range(len(pic.planes)):
                    h.update(pic.plane_bytes(pl))
                n += 1
    finally:
        torch.set_num_threads(threads)
    return n, h.hexdigest()


@pytest.fixture
def owned_rows(monkeypatch):
    """Count, beside the residual stage, the meta rows with coefficients
    (eob >= 0) that the frame's capture blocks own: each block's
    ``coef_start`` / ``coef_count`` rows, over every record of the block
    arena (a gap record is zero and owns none)."""
    from dav1d_tpu_torch import pipeline

    seen = [0]
    launch = pipeline._launch_residuals_native

    def counting(f):
        glue = f._nat
        blocks = glue.cap_blocks[:int(glue.c.n_blocks)]
        for s, n in zip(blocks["coef_start"].tolist(),
                        blocks["coef_count"].tolist()):
            seen[0] += int((glue.cap_coef_meta[s:s + n, 0] >= 0).sum())
        return launch(f)

    monkeypatch.setattr(pipeline, "_launch_residuals_native", counting)
    return seen


@pytest.mark.parametrize("n_threads", [0, 2, 4])
@pytest.mark.parametrize("path", list(TILED), ids=lambda p: p.name)
def test_tiled_itx_blocks_as_serial(path, n_threads, owned_rows):
    from dav1d_tpu_torch import devrt

    want = _want_md5(path)
    got = _decode(path, n_threads)
    assert got == (want["frames"], want["md5"])
    counts = dict(devrt.COUNTS)
    assert counts["itx_blocks"] == owned_rows[0] == TILED[path], counts
    # at n_threads >= 2 the slices engage: gap rows exist, and none of
    # them became a job
    assert (counts["arena.gap_rows"] > 0) == (n_threads >= 2), counts


def _zero(arr):
    return not arr.view(np.uint8).any()


def test_pool_returns_tile_slices_zeroed(monkeypatch):
    from dav1d_tpu_torch import devrt
    from dav1d_tpu_torch.native import decode_glue as dg

    path = DATA / "tiles2x2_256x192.ivf"
    want = _want_md5(path)
    with dg._POOL_LOCK:
        dg._ARENA_POOL.clear()
    used = []
    release = dg.NativeFrameDecode.release

    def measuring(self):
        # each tile's [slice start, used end) of every arena, in bytes,
        # read from the tile contexts before release clears them
        assert self.tile_order, "the 2x2 frames decode tile-sliced"
        n = 0
        for ts in self.tile_order:
            fc, *starts = self.tile_fctx[id(ts)]
            for (_, attr, cur), s in zip(dg._ARENAS, starts):
                n += getattr(self, attr).strides[0] * \
                    (getattr(fc, cur) - s)
        used.append(n)
        release(self)

    monkeypatch.setattr(dg.NativeFrameDecode, "release", measuring)
    reuses = {k: v[1] for k, v in dg.ALLOC_STATS.items()}
    assert _decode(path, 4) == (want["frames"], want["md5"])
    assert len(used) == want["frames"]
    assert devrt.COUNTS["arena.cleared_bytes"] == sum(used) > 0
    # frames took arenas that earlier frames had released
    assert any(v[1] > reuses.get(k, 0) for k, v in dg.ALLOC_STATS.items())
    pooled = [a for lst in dg._ARENA_POOL.values() for a in lst]
    assert len(pooled) >= len(dg._ARENAS)
    assert all(_zero(a) for a in pooled)

    # a second decoder draws the recycled arenas
    reuses = {k: v[1] for k, v in dg.ALLOC_STATS.items()}
    assert _decode(path, 2) == (want["frames"], want["md5"])
    assert all(dg.ALLOC_STATS[name][1] > reuses[name]
               for name, _, _ in dg._ARENAS), \
        dg.ALLOC_STATS
    assert all(_zero(a) for lst in dg._ARENA_POOL.values() for a in lst)
