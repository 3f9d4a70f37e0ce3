"""Normative AV1 constant tables.

Loaded from dav1d_tpu/data/tables.npz, which tools/extract_tables.py builds
by mechanically dumping the AV1 specification constants (default CDFs, scan
orders, dequant/QM tables, subpel/warp/resize filter coefficients,
wedge/interintra masks, context LUTs) from a build of the reference decoder.
These are spec data, required bit-exactly; see tools/dump_tables.c.

This module exposes them as numpy arrays with logical (unpadded) shapes,
plus a few derived structures (per-tx-size scan list, QM dict, wedge/II
mask views).
"""

from __future__ import annotations

import functools
import threading
from pathlib import Path

import numpy as np

from .levels import N_RECT_TX_SIZES

_DATA = Path(__file__).parent / "data" / "tables.npz"


@functools.cache
def _z():
    return np.load(_DATA)


_cache: dict = {}
# one zip handle serves every member: reads from threads at once (pass 1's
# tile threads on a process's first frame) overlap on its file position
# and fail (zipfile.BadZipFile), so the first read of each member holds
# the lock; a member already read is returned without it
_LOCK = threading.Lock()


def _get(name: str) -> np.ndarray:
    # np.load is lazy: indexing re-reads+decompresses the member each time,
    # so cache materialized arrays
    arr = _cache.get(name)
    if arr is None:
        with _LOCK:
            arr = _cache.get(name)
            if arr is None:
                arr = _cache[name] = _z()[name]
    return arr


def __getattr__(name: str):
    """Module attribute access for plain tables: tables.mc_subpel_filters
    etc. map 1:1 to npz records."""
    try:
        return _get(name)
    except KeyError:
        raise AttributeError(name) from None


# --- derived structures -------------------------------------------------

@functools.cache
def txfm_info() -> np.ndarray:
    """(19, 8) uint8: w, h (4px units), lw, lh, min, max, sub, ctx."""
    return _get("txfm_dimensions")


@functools.cache
def scans() -> list[np.ndarray]:
    """Per rect-tx-size coefficient scan order (uint16)."""
    return [_get(f"scan.{i}") for i in range(N_RECT_TX_SIZES)]


@functools.cache
def qm_tbl() -> dict[tuple[int, int, int], np.ndarray]:
    """(qm_level, plane(0=y,1=uv), rect_tx_size) -> flattened QM weights."""
    out = {}
    for key in _z().files:
        if key.startswith("qm."):
            _, j, p, i = key.split(".")
            out[(int(j), int(p), int(i))] = _get(key)
    return out


@functools.cache
def _masks_fields() -> dict[str, np.ndarray]:
    blob = _get("masks.blob")
    manifest = bytes(_get("masks.manifest")).decode()
    fields = {}
    for line in manifest.strip().splitlines():
        name, off, size = line.split()
        fields[name] = blob[int(off) : int(off) + int(size)]
    return fields


@functools.cache
def mask_offsets() -> np.ndarray:
    """(3 chroma layouts 444/422/420, 11 block sizes BS_32x32..BS_8x8, 36)
    uint16 offsets in 8-byte units into the masks blob:
    [0:32]=wedge[2 signs][16 idx], [32:36]=ii[4 modes]
    (reference src/wedge.h:33-38)."""
    raw = _masks_fields()["offsets"].view(np.uint16)
    return raw.reshape(3, 11, 36)


_BS_32X32 = 7  # BlockSize.BS_32x32


def wedge_mask(chr_layout_idx: int, bs: int, sign: int, wedge_idx: int,
               w: int, h: int) -> np.ndarray:
    """Wedge mask (reference WEDGE_MASK, src/wedge.h:88-90), as (h, w) at
    the chroma-scaled size."""
    off = int(mask_offsets()[chr_layout_idx, bs - _BS_32X32,
                             sign * 16 + wedge_idx]) * 8
    blob = _get("masks.blob")
    return blob[off : off + w * h].reshape(h, w)


def ii_mask(chr_layout_idx: int, bs: int, b) -> np.ndarray:
    """Interintra blend mask (reference II_MASK, src/wedge.h:82-86);
    returns the flat mask array (caller reshapes to block size)."""
    from .levels import InterIntraType
    if b.interintra_type == InterIntraType.BLEND:
        idx = 32 + b.interintra_mode
    else:
        idx = b.wedge_idx
    off = int(mask_offsets()[chr_layout_idx, bs - _BS_32X32, idx]) * 8
    return _get("masks.blob")[off:]


# --- default CDFs --------------------------------------------------------

@functools.cache
def default_cdf_mode() -> dict[str, np.ndarray]:
    """All default mode/mv/kf CDF arrays keyed by field name (padded dims,
    as in reference src/cdf.h:39-134)."""
    out = {}
    for key in _z().files:
        if key.startswith("cdf.") and not key.startswith("cdf.q"):
            out[key[len("cdf."):]] = _get(key)
    return out


@functools.cache
def default_cdf_coef(qcat: int) -> dict[str, np.ndarray]:
    """Default coefficient CDFs for quantizer category 0..3."""
    prefix = f"cdf.q{qcat}.coef."
    out = {}
    for key in _z().files:
        if key.startswith(prefix):
            out[key[len(prefix):]] = _get(key)
    return out
