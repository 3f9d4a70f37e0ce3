"""Super-res resample on device tensors (counterpart of
dav1d_tpu/ops/resize.py, placed as dav1d_tpu/recon/device_chain.py
_resize_resident places it).

The horizontal 8-tap upscale of one plane (reference resize_c,
src/mc_tmpl.c, applied by filter_sbrow_resize, src/recon_tmpl.c:2053),
as a plain PyTorch version and a wrapper that launches
``csrc/resize.cu`` on CUDA tensors (CPU tensors run the plain version).
The per-column stepping has a closed form (recon/mc_np.resize_coords):
each output column reads 8 clamped source columns through one of the 64
filter rows.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import devrt, tables
from ..kernels import build
from ..recon.mc_np import resize_coords


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


def resize_plane(plane: torch.Tensor, out_w: int, src_w: int, step: int,
                 mx0: int, h: int, alloc_w: int,
                 bitdepth: int) -> torch.Tensor:
    """Super-res of one resident (H, W) int32 plane, in the geometry of
    decode/frame.superres_geometry: returns a new (H, alloc_w) int32
    plane holding rows [0, h) x columns [0, src_w) of ``plane`` upscaled
    to columns [0, out_w), and 0 elsewhere.  CPU tensors run the plain
    version; CUDA tensors launch ``csrc/resize.cu``."""
    H, W = plane.shape
    build.check(plane, "plane")
    if bitdepth not in (8, 10, 12):
        raise ValueError(f"bitdepth {bitdepth}")
    if not (0 < src_w <= W and 0 < h <= H and 0 < out_w <= alloc_w):
        raise ValueError(f"resize of {h}x{src_w} to {out_w} (alloc "
                         f"{alloc_w}) outside {H}x{W}")
    if not build.on_cuda(plane):
        return resize_plane_plain(plane, out_w, src_w, step, mx0, h,
                                  alloc_w, bitdepth)
    out = torch.empty((H, alloc_w), dtype=torch.int32, device=plane.device)
    with torch.cuda.device(plane.device):
        devrt.launch("resize", build.lib().dtpu_resize, plane.data_ptr(), W,
                     int(src_w), int(h), out.data_ptr(), H, int(alloc_w),
                     int(out_w), int(step), int(mx0), int(bitdepth),
                     build.stream(plane))
    return out
