"""Deblocking of a resident plane as row bands over a mesh (counterpart of
dav1d_tpu/recon/mesh_lf.py, whose shard_map program runs ops/lf.lf_apply
on a band per device with ppermute halos).

Within a direction pass no edge reads another edge's writes, and no two
edges' write windows overlap (recon/lf.py module docstring), so a pass
runs band by band once each band sees the rows its edges read:

* vertical edges filter 4-row segments along their own rows: each band
  runs K1 (ops/lf.deblock, ``deblock_v``) on its own rows and its own
  rows of the pass's cell map, with no exchange;
* horizontal edges read up to 7 rows and write up to 6 across the edge:
  each band runs K1 (``deblock_h``) on its rows with 8 post-vertical rows
  of each neighbour above and below (mesh.Mesh.edge_rows: an exchange of
  every band's first and last 8 rows), on a cell map that holds only the
  band's own edges, 2 cell rows down (8 rows are 2 cells, so K1 needs
  no change);
* the halo rows a band's boundary edges wrote go back to their owner
  (a second exchange), which takes the pixels that differ from the rows
  it sent: exact, because no other edge writes them and an edge that
  wrote a pixel's own value leaves it as it was.

Bands wholly past the plane's filtered rows hold no edge and take no
halo; the frame's first band has no band above and its last band with
filtered rows none below (zero rows there: no edge reads beyond the
frame, as in the whole-plane pass).  The bands are stitched back into
the plane on the mesh's first device (on every rank in the
process-group form).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import devrt
from ..mesh import halo
from ..ops import lf as olf

HALO = 8


def deblock_plane_mesh(mesh, plane: torch.Tensor, v_edges, h_edges, ph: int,
                       bitdepth: int, luma: bool) -> torch.Tensor:
    """Both deblock passes of the resident ``plane`` (on the mesh's first
    device) in row bands of ``mesh.band_rows(ph)`` rows: v_edges /
    h_edges as for ops/lf.cellmap, or None.  Returns the deblocked
    plane."""
    H, W = plane.shape
    bh = mesh.band_rows(ph)
    cell_h = bh >> 2
    live = [b for b in mesh.local if b * bh < ph]
    cells = {}
    for vertical, edges in ((True, v_edges), (False, h_edges)):
        if edges is not None and len(edges[0]):
            cells[vertical] = olf.cellmap(edges, mesh.n * bh, W)
    if not cells:
        return plane
    bands = mesh.split(plane, bh)

    def band_cells(cm, b, pad=0):
        c = np.zeros((cell_h + 2 * pad, cm.shape[1]), np.int32)
        c[pad:pad + cell_h] = cm[b * cell_h:(b + 1) * cell_h]
        return c if c.any() else None

    if True in cells:
        for b in live:
            c = band_cells(cells[True], b)
            if c is None:
                continue
            devrt.COUNTS["mesh_deblock_v_bands"] += 1
            bands[b] = devrt.call(
                "deblock", olf.deblock, bands[b],
                devrt.upload(c, mesh.device_of(b)), True, bitdepth, luma)
    if False in cells:
        def inner(b):  # a band with filtered rows
            return 0 <= b < mesh.n and b * bh < ph

        sent = mesh.edge_rows(bands, HALO)
        ext = {}
        for b in live:
            dev = mesh.device_of(b)
            zeros = bands[b].new_zeros((HALO, W))
            top = halo(sent[b - 1][HALO:], dev) if inner(b - 1) else zeros
            bot = halo(sent[b + 1][:HALO], dev) if inner(b + 1) else zeros
            e = torch.cat([top, bands[b], bot])
            c = band_cells(cells[False], b, pad=HALO >> 2)
            if c is not None:
                devrt.COUNTS["mesh_deblock_h_bands"] += 1
                e = devrt.call("deblock", olf.deblock, e,
                               devrt.upload(c, dev), False, bitdepth, luma)
            ext[b] = e
        # every band's written halo rows (the rows as sent where it has
        # none), back to their owners
        back = mesh.gather([torch.cat([ext[b][:HALO], ext[b][-HALO:]])
                            if b in ext else sent[b].to(bands[b].device)
                            for b in mesh.local])
        for b in live:
            dev = mesh.device_of(b)
            mine = sent[b].to(dev)
            core = ext[b][HALO:-HALO]
            if inner(b - 1):  # rows 0..7, as the band above wrote them
                got = halo(back[b - 1][HALO:], dev)
                core[:HALO] = torch.where(got != mine[:HALO], got,
                                          core[:HALO])
            if inner(b + 1):  # the last 8 rows, as the band below wrote
                got = halo(back[b + 1][:HALO], dev)
                core[-HALO:] = torch.where(got != mine[HALO:], got,
                                           core[-HALO:])
            bands[b] = core
    return mesh.stitch(bands, plane)
