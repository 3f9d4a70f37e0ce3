"""CDEF of the resident planes as row bands over a mesh (counterpart of
dav1d_tpu/recon/mesh_cdef.py, whose shard_map program runs
ops/cdef._jit_filter on a band per device with 2-row ppermute halos).

Every 8x8 unit reads up to 2 pre-CDEF pixels beyond its own rows, and
writes only its own; the bands are 64-aligned (mesh.Mesh.band_rows), so
no unit straddles two:

* the direction search (K5, ops/cdef.find_dir_maps) runs on each luma
  band's own rows: its 8x8 blocks lie inside the band.  The bands' maps
  are stitched (all-gathered across ranks), because a chroma band's
  units, whose bands are cut from the chroma plane's own rows, read the
  luma blocks of other rows;
* each band of each plane with units runs K2's band form
  (ops/cdef.filter_plane with ``top`` / ``bottom``) on a canvas of its
  rows and 2 pre-CDEF rows of each neighbour (mesh.Mesh.edge_rows), its
  units, strength grids and maps in its own coordinates.  The frame's
  first band takes no halo above and the band holding the plane's last
  filtered row none below: the kernel reads the sentinel there, as the
  whole-plane call does at the frame's edges (dav1d_tpu's band program
  fills those halos with the sentinel, mesh_cdef.py:62-73, and the rows
  past ``ph`` too, :157-158).

The bands are stitched back into the plane on the mesh's first device
(on every rank in the process-group form).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import devrt
from ..mesh import halo
from ..ops import cdef as ocdef

HALO = 2


def dir_maps_mesh(mesh, luma: torch.Tensor, ph: int, bitdepth: int,
                  search: bool = True):
    """(dir, var) int32 maps of the luma plane's 8x8 blocks, rows of every
    luma band (``mesh.n * band_rows / 8`` rows), on each local band's
    device: {band: (dir, var)}.  One K5 launch per local band with
    filtered rows; the maps of a band past ``ph`` are zeros (a unit beyond
    the whole-plane maps reads dir = var = 0 too), and all are zeros
    without ``search`` (no unit has a primary strength)."""
    bh = mesh.band_rows(ph)
    bands = mesh.split(luma, bh)
    parts = []
    for b in mesh.local:
        if search and b * bh < ph:
            devrt.COUNTS["mesh_cdef_dir_bands"] += 1
            d, v = devrt.call("cdef_dir", ocdef.find_dir_maps, bands[b],
                              bitdepth)
        else:
            d = v = torch.zeros((bh >> 3, luma.shape[1] >> 3),
                                dtype=torch.int32, device=bands[b].device)
        parts.append(torch.stack([d, v]).transpose(0, 1))
    every = mesh.gather(parts)
    on = {}  # one copy a device
    for b in mesh.local:
        dev = mesh.device_of(b)
        if dev not in on:
            dv = torch.cat([t.to(dev) for t in every]).transpose(0, 1)
            on[dev] = (dv[0].contiguous(), dv[1].contiguous())
    return {b: on[mesh.device_of(b)] for b in mesh.local}


def filter_plane_mesh(mesh, plane: torch.Tensor, maps: dict, ph: int,
                      pw: int, uys, uxs, w: int, h: int, pri, sec,
                      damping: int, bitdepth: int, luma: bool,
                      layout_422: bool) -> torch.Tensor:
    """CDEF of the resident ``plane`` (on the mesh's first device) in row
    bands: the units ``uys``, ``uxs`` (plane coordinates, host numpy) with
    strengths ``pri``, ``sec`` as ops/cdef.cdef_filter_plane_resident
    takes them, ``maps`` from :func:`dir_maps_mesh` (or {band: zero
    maps}).  Returns the filtered plane."""
    bh = mesh.band_rows(ph)
    bands = mesh.split(plane, bh)
    sent = mesh.edge_rows(bands, HALO)
    band_of = np.asarray(uys) // bh
    out = {}
    for b in mesh.local:
        y0 = b * bh
        sel = band_of == b
        if y0 >= ph or not sel.any():
            out[b] = bands[b]
            continue
        dev = mesh.device_of(b)
        top = HALO if b > 0 else 0
        bottom = HALO if y0 + bh < ph else 0
        rows = [bands[b]]
        if top:
            rows.insert(0, halo(sent[b - 1][HALO:], dev))
        if bottom:
            rows.append(halo(sent[b + 1][:HALO], dev))
        dmap, vmap = maps[b]
        ph_b = min(bh, ph - y0)
        u0, u1 = y0 // h, y0 // h + -(-ph_b // h)
        devrt.COUNTS["mesh_cdef_bands"] += 1
        out[b] = ocdef.cdef_filter_plane_resident(
            torch.cat(rows), dmap[u0:u1], vmap[u0:u1], ph_b, pw,
            np.asarray(uys)[sel] - y0, np.asarray(uxs)[sel], w, h,
            np.asarray(pri)[sel], np.asarray(sec)[sel], damping, bitdepth,
            luma, layout_422, top, bottom)
    return mesh.stitch(out, plane)
