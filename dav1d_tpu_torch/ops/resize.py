"""Super-res resample on device tensors (counterpart of
dav1d_tpu/ops/resize.py, placed as dav1d_tpu/recon/device_chain.py
_resize_resident places it).

The horizontal 8-tap upscale of a plane (reference resize_c,
src/mc_tmpl.c, applied by filter_sbrow_resize, src/recon_tmpl.c:2053),
as a plain PyTorch version and a wrapper that launches
``csrc/resize.cu`` on CUDA tensors (CPU tensors run the plain version):
:func:`resize_planes` takes up to six planes in one launch (the device
chain's frame and pre-CDEF snapshot), :func:`resize_plane` one.
The per-column stepping has a closed form (recon/mc_np.resize_coords):
each output column reads 8 clamped source columns through one of the 64
filter rows.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import devrt, tables
from ..kernels import build
from ..recon.mc_np import resize_coords

# planes a launch takes (csrc/resize_core.cuh MAX_PLANES: the frame's
# three and the pre-CDEF snapshot's three); the largest step the kernel's
# staged rows hold (an upscale: step <= 2^14); int32 geometry columns of
# a plane in the C call
MAX_PLANES = 6
MAX_STEP = 1 << 14
GEO_COLS = 8


def resize_plain(src: torch.Tensor, out_w: int, src_w: int, step: int,
                 mx0: int, bitdepth: int) -> torch.Tensor:
    """(h, >= src_w) int32 rows -> (h, out_w) int32 in plain PyTorch:
    clip((-sum(tap * px) + 64) >> 7, 0, 2^bd - 1) over the 8 clamped
    source columns of each output column."""
    cols, fi = resize_coords(out_w, src_w, step, mx0)
    filt = torch.from_numpy(
        tables.resize_filter.astype(np.int32)[fi]).to(src.device)
    g = src[:, torch.from_numpy(cols).to(src.device).long()]  # (h, out_w, 8)
    acc = -(g * filt[None]).sum(2, dtype=torch.int32)
    return torch.clamp((acc + 64) >> 7, 0, (1 << bitdepth) - 1)


def resize_plane_plain(plane, out_w, src_w, step, mx0, h, alloc_w,
                       bitdepth):
    """The plain version of :func:`resize_plane`."""
    out = torch.zeros((plane.shape[0], alloc_w), dtype=torch.int32,
                      device=plane.device)
    out[:h, :out_w] = resize_plain(plane[:h, :src_w], out_w, src_w, step,
                                   mx0, bitdepth)
    return out


def resize_planes_plain(planes, geoms, bitdepth):
    """The plain version of :func:`resize_planes`."""
    return [resize_plane_plain(p, *g, bitdepth) for p, g in
            zip(planes, geoms)]


def _check(planes, geoms, bitdepth):
    """Raise unless the kernel takes these planes and geometries."""
    if len(planes) != len(geoms):
        raise ValueError(f"{len(planes)} planes, {len(geoms)} geometries")
    if not 0 < len(planes) <= MAX_PLANES:
        raise ValueError(f"{len(planes)} planes: a launch takes 1 to "
                         f"{MAX_PLANES}")
    if bitdepth not in (8, 10, 12):
        raise ValueError(f"bitdepth {bitdepth}")
    for k, (plane, g) in enumerate(zip(planes, geoms)):
        build.check(plane, f"planes[{k}]")
        if len(g) != 6:
            raise ValueError(f"geoms[{k}]: {g}, expected (out_w, src_w, "
                             "step, mx0, h, alloc_w)")
        out_w, src_w, step, mx0, h, alloc_w = g
        H, W = plane.shape
        if not (0 < src_w <= W and 0 < h <= H and 0 < out_w <= alloc_w):
            raise ValueError(f"resize of {h}x{src_w} to {out_w} (alloc "
                             f"{alloc_w}) outside {H}x{W}")
        if not 0 < step <= MAX_STEP:
            raise ValueError(f"step {step}: an upscale steps by at most "
                             f"{MAX_STEP}")


def resize_planes(planes, geoms, bitdepth: int) -> list:
    """Super-res of up to :data:`MAX_PLANES` resident (H, W) int32
    planes in one launch, plane k in the geometry ``geoms[k]`` of
    decode/frame.superres_geometry (out_w, src_w, step, mx0, h, alloc_w):
    returns a new (H, alloc_w) int32 plane for each, holding rows [0, h)
    x columns [0, src_w) of the plane upscaled to columns [0, out_w), and
    0 elsewhere.  CPU tensors run the plain version; CUDA tensors launch
    ``csrc/resize.cu`` (one launch for all the planes)."""
    planes, geoms = list(planes), [tuple(int(v) for v in g) for g in geoms]
    _check(planes, geoms, bitdepth)
    if not build.on_cuda(*planes):
        return resize_planes_plain(planes, geoms, bitdepth)
    outs = [torch.empty((p.shape[0], g[5]), dtype=torch.int32,
                        device=p.device) for p, g in zip(planes, geoms)]
    n = len(planes)
    srcs = (ctypes.c_void_p * n)(*(p.data_ptr() for p in planes))
    dsts = (ctypes.c_void_p * n)(*(o.data_ptr() for o in outs))
    geo = (ctypes.c_int * (GEO_COLS * n))(*(
        v for p, (out_w, src_w, step, mx0, h, alloc_w) in zip(planes, geoms)
        for v in (p.shape[1], src_w, h, out_w, p.shape[0], alloc_w, step,
                  mx0)))
    with torch.cuda.device(planes[0].device):
        devrt.launch("resize", build.lib().dtpu_resize, srcs, dsts, geo, n,
                     int(bitdepth), build.stream(planes[0]))
    return outs


def resize_plane(plane: torch.Tensor, out_w: int, src_w: int, step: int,
                 mx0: int, h: int, alloc_w: int,
                 bitdepth: int) -> torch.Tensor:
    """Super-res of one resident (H, W) int32 plane: the one-plane call
    of :func:`resize_planes`."""
    return resize_planes([plane], [(out_w, src_w, step, mx0, h, alloc_w)],
                         bitdepth)[0]
