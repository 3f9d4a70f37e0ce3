"""The decoder's state on the device: constant tables and frame planes.

The decoder has no learned weights.  What the kernels need besides the
pixels is the normative tables, carried across from the JAX package as
numpy arrays and turned into device tensors once per device:

* CDEF tap offsets ``recon/cdef._DIR_DY/_DIR_DX`` (2 passes x 12
  entries, indexed ``[k][2 + dir]`` for primary taps and
  ``[k][dir]``/``[k][4 + dir]`` for secondary taps);
* the chroma direction remaps ``UV_DIRS_420/422``;
* the CDEF direction-search cost lattice: which of the 15 bins of each
  of the 8 partial-sum sets a pixel of the 8x8 block adds to, and the
  divisor weight of each bin (reference src/cdef_tmpl.c:56-104, the
  numbers of ``ops/cdef._cost_weights``).

The deblock limit LUTs (``f.lf_lim_lut`` from ``recon/lf.calc_eih``)
are consumed on the host: the cell-map packer (``ops/lf.cellmap``)
resolves E/I/H per edge before the map is uploaded.

Frame state is the planes: :func:`upload_planes` moves the narrow host
planes to the device once per frame and widens them to int32.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import devrt
from .recon.cdef import _DIR_DX, _DIR_DY, UV_DIRS_420, UV_DIRS_422
from .recon.lf import calc_eih

# cost divisors of the direction search (reference cdef_find_dir_c)
CDEF_DIV = (840, 420, 280, 210, 168, 140, 120)
CDEF_DIV_ALT = (420, 210, 140)


def cdef_bin_index() -> np.ndarray:
    """(8, 64) int64: bin of pixel ``y*8 + x`` in each partial-sum set,
    in cost-row order diag0, alt0, hv0, alt1, diag1, alt2, hv1, alt3
    (the order of recon/cdef._onehot_maps)."""
    ys, xs = np.mgrid[0:8, 0:8]
    ys, xs = ys.ravel(), xs.ravel()
    return np.stack([ys + xs, ys + (xs >> 1), ys, 3 + ys - (xs >> 1),
                     7 + ys - xs, 3 - (ys >> 1) + xs, xs,
                     (ys >> 1) + xs]).astype(np.int64)


def cdef_bin_weights() -> np.ndarray:
    """(8, 15) int32: weight of each bin in its cost row; cost[d] is
    sum_b weight[d, b] * psum_d[b]^2 (unused bins weigh 0)."""
    w = np.zeros((8, 15), dtype=np.int32)
    for d in (0, 4):  # diagonals: 15 bins
        for i in range(7):
            w[d, i] = w[d, 14 - i] = CDEF_DIV[i]
        w[d, 7] = 105
    for d in (2, 6):  # horizontal / vertical: 8 bins
        w[d, :8] = 105
    for d in (1, 3, 5, 7):  # alternates: 11 bins
        for i in range(3):
            w[d, i] = w[d, 10 - i] = CDEF_DIV_ALT[i]
        w[d, 3:8] = 105
    return w


def lf_limits(sharpness: int):
    """(E, I) deblock limit LUTs per filter level for a frame's
    sharpness (recon/lf.calc_eih; a frame carries them as
    ``f.lf_lim_lut``)."""
    return calc_eih(sharpness)


@dataclasses.dataclass(frozen=True)
class DeviceTables:
    dir_dy: torch.Tensor       # (2, 12) int32
    dir_dx: torch.Tensor       # (2, 12) int32
    uv_dirs: torch.Tensor      # (2, 8) int32: [4:2:0, 4:2:2]
    bin_index: torch.Tensor    # (8, 64) int64
    bin_weights: torch.Tensor  # (8, 15) int32


@functools.lru_cache(maxsize=None)
def tables(device: torch.device) -> DeviceTables:
    """The constant tables on ``device``, built once per device."""
    def t(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)

    return DeviceTables(
        dir_dy=t(_DIR_DY, torch.int32), dir_dx=t(_DIR_DX, torch.int32),
        uv_dirs=t([UV_DIRS_420, UV_DIRS_422], torch.int32),
        bin_index=t(cdef_bin_index(), torch.int64),
        bin_weights=t(cdef_bin_weights(), torch.int32))


def upload_planes(planes, bitdepth: int, device) -> list:
    """Host int32 planes -> int32 device tensors, moved in the narrow
    storage dtype (uint8 / int16) and widened on the device."""
    narrow = np.uint8 if bitdepth == 8 else np.int16
    return [devrt.upload(p.astype(narrow), device).to(torch.int32)
            for p in planes]
