"""Multi-device decode: row bands of the resident planes over several
torch devices, or over the ranks of a ``torch.distributed`` process group
(the port's ``Settings.mesh``; dav1d_tpu's is a ``jax.sharding.Mesh``,
dav1d_tpu/decoder.py:55).

``Mesh(devices)`` holds one row band per entry of ``devices``, in order;
entries may repeat, so ``Mesh([torch.device("cuda:0")] * 4)`` runs four
bands on one card and ``Mesh([torch.device("cpu")] * 8)`` eight on the
CPU.  ``Mesh(devices, group=pg)`` is the process-group form: this rank
holds ``len(devices)`` bands (every rank the same number; the
constructor checks it with a collective and refuses otherwise), band
``rank * len(devices) + i`` on ``devices[i]``, and the mesh has
``len(devices) * world_size`` bands.  Every rank entropy-decodes the
whole stream, so the host state is replicated and every rank takes the
same decisions; only rows and shares of device work move between ranks,
by ``all_gather`` of equal-size blocks (gloo on CPU tensors, NCCL on
CUDA ones: one code path for both).

What the mesh spreads (the four stages of dav1d_tpu's mesh; MC, device
intra, super-res and film grain stay on ``devices[0]``):

* the frame's inverse transforms: the blocks in shares of contiguous
  arena ranges, one K4 launch a share (pipeline.itx_shares);
* deblock, as row bands with 8-row halos (recon/mesh_lf.py);
* CDEF, as row bands with 2-row halos (recon/mesh_cdef.py);
* the loop-restoration units, dealt in contiguous shares
  (recon/device_chain._lr).

Band geometry is dav1d_tpu's (recon/mesh_lf.py:139-140,
recon/mesh_cdef.py:154-155): a plane of ``ph`` filtered rows is cut into
``n`` bands of ``ceil(ph / n)`` rows rounded up to 64, so no 8x8 unit
and no 64-row superblock edge straddles two bands; the last bands may
lie partly or wholly past ``ph`` (and past the plane's allocation: rows
there read as zeros and are dropped when the bands are stitched back).

Nothing here catches a failed copy or collective: it raises out of the
decode.
"""

from __future__ import annotations

import torch

from . import devrt

BAND_ALIGN = 64


class Mesh:
    """Row bands over torch devices (see the module docstring)."""

    def __init__(self, devices, group=None):
        devices = [devrt.resolve_device(d) for d in devices]
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices = devices
        self.group = group
        k = len(devices)
        if group is None:
            self.rank, self.world = 0, 1
        else:
            import torch.distributed as dist

            self.rank = dist.get_rank(group)
            self.world = dist.get_world_size(group)
            mine = torch.tensor([k], dtype=torch.int64, device=devices[0])
            every = [torch.empty_like(mine) for _ in range(self.world)]
            dist.all_gather(every, mine, group=group)
            counts = [int(c) for c in every]
            if len(set(counts)) != 1:
                raise ValueError(f"the ranks disagree on the band count: "
                                 f"{counts} bands by rank")
        self.n = k * self.world
        self.local = list(range(self.rank * k, (self.rank + 1) * k))

    def device_of(self, b: int) -> torch.device:
        """The device of local band ``b``."""
        return self.devices[b - self.local[0]]

    def band_rows(self, ph: int) -> int:
        """Rows of each band of a plane of ``ph`` filtered rows."""
        bh = -(-int(ph) // self.n)
        return -(-bh // BAND_ALIGN) * BAND_ALIGN

    def split(self, plane: torch.Tensor, bh: int) -> dict:
        """{local band: its ``bh`` rows of ``plane`` on its device}; rows
        past the plane are zeros.  A band on the plane's device is a view
        where it lies inside the plane."""
        H = plane.shape[0]
        out = {}
        for b in self.local:
            y0, dev = b * bh, self.device_of(b)
            if y0 + bh <= H and dev == plane.device:
                out[b] = plane[y0:y0 + bh]
                continue
            t = plane.new_zeros((bh,) + tuple(plane.shape[1:]), device=dev)
            if y0 < H:
                t[:H - y0] = plane[y0:y0 + bh]
            out[b] = t
        return out

    def put(self, rows) -> list:
        """This process's rows of ``rows`` (one a band, in band order), row
        b uploaded to band b's device, in ``local`` order (counterpart of
        dav1d_tpu/devrt.py:138 ``mesh_put``)."""
        if len(rows) != self.n:
            raise ValueError(f"{len(rows)} rows for {self.n} bands")
        return [devrt.upload(rows[b], self.device_of(b)) for b in self.local]

    def fetch(self, parts, sizes=None) -> torch.Tensor:
        """Every band's part, in band order, concatenated along the leading
        axis on ``devices[0]`` (:meth:`gather`; counterpart of
        dav1d_tpu/devrt.py:156 ``mesh_fetch``)."""
        return torch.cat(self.gather(parts, sizes, to=self.devices[0]))

    def gather(self, parts, sizes=None, to=None) -> list:
        """Every band's part, in band order, from this process's ``parts``
        (one tensor a local band, in order, all of one shape but for the
        leading axis).  Single process: the parts on their devices, or
        moved to ``to``.  Process group: all-gathered across the ranks
        onto ``devices[0]``; ``sizes`` gives every band's leading size
        where they differ (the parts are padded to the largest for the
        collective and cut back).  ``devrt.XFER["mesh"]`` counts the
        bytes that came from another device or rank."""
        parts = list(parts)
        if len(parts) != len(self.local):
            raise ValueError(f"{len(parts)} parts for {len(self.local)} "
                             "local bands")
        if self.group is None:
            if to is None:
                return parts
            _count_moved(p for p in parts if p.device != to)
            return [p.to(to) for p in parts]
        import torch.distributed as dist

        k = len(self.local)
        if sizes is None:
            sizes = [parts[0].shape[0]] * self.n
        cap = max(sizes)
        dev = self.devices[0]
        shape = tuple(parts[0].shape[1:])
        mine = torch.zeros((k, cap) + shape, dtype=parts[0].dtype,
                           device=dev)
        if not cap:  # every part empty: nothing to gather
            return [mine[0]] * self.n
        for i, p in enumerate(parts):
            mine[i, :p.shape[0]] = p
        # as bytes: gloo gathers no int16
        raw = mine.view(torch.uint8)
        every = [torch.empty_like(raw) for _ in range(self.world)]
        dist.all_gather(every, raw, group=self.group)
        every = [t.view(mine.dtype) for t in every]
        out = [every[b // k][b % k, :sizes[b]] for b in range(self.n)]
        _count_moved(t for b, t in enumerate(out) if b not in self.local)
        return out

    def stitch(self, bands: dict, plane: torch.Tensor) -> torch.Tensor:
        """``plane`` (on ``devices[0]``) with its rows replaced by every
        band's rows (``bands``: {local band: its rows}), on every rank in
        the process-group form.  Rows of the allocation past the last
        band (where the bands' ``n * bh`` rows end before the plane's:
        a one-band mesh on a plane allocated in 128-row superblocks) lie
        past the filtered rows and keep the plane's values, as the
        reference writes back only the filtered rows
        (dav1d_tpu/recon/mesh_lf.py:184)."""
        out = self.fetch([bands[b] for b in self.local])
        H = plane.shape[0]
        if out.shape[0] >= H:
            return out[:H]
        return torch.cat([out, plane[out.shape[0]:]])

    def edge_rows(self, bands: dict, k: int) -> list:
        """Every band's first ``k`` and last ``k`` rows, stacked (2k rows a
        band), in band order, from this process's ``bands``: the halo
        exchange."""
        return self.gather([torch.cat([bands[b][:k], bands[b][-k:]])
                            for b in self.local])


def _count_moved(tensors) -> None:
    if devrt.XFER is not None:
        devrt.XFER["mesh"] = devrt.XFER.get("mesh", 0) + sum(
            t.numel() * t.element_size() for t in tensors)


def halo(rows: torch.Tensor, device) -> torch.Tensor:
    """Halo rows received by a band on ``device``; counted in
    ``devrt.COUNTS["halo_bytes"]``."""
    devrt.COUNTS["halo_bytes"] += rows.numel() * rows.element_size()
    return rows.to(device)
