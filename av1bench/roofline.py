"""The least device time each kernel call needs on an H100: the bytes and
operations the call's function needs on its arguments, over the card's
published peaks, the larger of the two.

A frozen copy of the arithmetic that ``chip_smoke.py`` (``work``,
``bound``, ``_itx_work``, ``_lr_work``, ``_units_work``,
``_ipred_work``, ``_mc_footprint``) applies to the program's device
calls, so that a later change to the program cannot move the
yardstick.  The 1-D transforms' operation counts, which that code counts
by running the program's transforms on counting lanes, are frozen here
as a table (``OPS_1D``), with the transform sizes (``TX_INFO``) and the
1-D types of each 2-D type (``TX_1D``).

``work(name, args)`` takes the arguments of one device call as the
program's wrappers receive them (a ``devrt.call`` record's ``args``;
``kernel_of`` names the kernel of a record).
"""

from __future__ import annotations

# the card's peak rates (H100 SXM data sheet, at 700 W): device memory,
# and 32-bit scalar operations outside the tensor cores (the float32
# rate; integer operations issue at most as fast, so the operation bound
# is a lower bound)
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12

# the CUDA kernel (``__global__`` function of dav1d_tpu_torch/csrc) that
# each call's name launches
KERNEL_OF_CALL = {
    "deblock_v": "deblock_kernel", "deblock_h": "deblock_kernel",
    "cdef_dir": "cdef_dir_kernel",
    "cdef_filter": "cdef_filter_kernel",
    "cdef_filter_band": "cdef_filter_kernel",
    "mc": "mc_put_8tap_kernel", "itx": "itx_frame_kernel",
    "resize": "resize_kernel", "lr_wiener": "lr_wiener_kernel",
    "lr_sgr": "lr_sgr_kernel", "fg": "fg_kernel",
    "ipred": "ipred_kernel", "ipred_cfl": "ipred_cfl_kernel",
    "ipred_pal": "ipred_pal_kernel", "ipred_walk": "ipred_walk_kernel",
}
KERNELS = frozenset(KERNEL_OF_CALL.values())
KIND_OF = {"ipred": 0, "ipred_cfl": 1, "ipred_pal": 2}

# transform size id -> (w, h, log2 w / 4, log2 h / 4)
TX_INFO = [(4, 4, 0, 0), (8, 8, 1, 1), (16, 16, 2, 2), (32, 32, 3, 3),
           (64, 64, 4, 4), (4, 8, 0, 1), (8, 4, 1, 0), (8, 16, 1, 2),
           (16, 8, 2, 1), (16, 32, 2, 3), (32, 16, 3, 2), (32, 64, 3, 4),
           (64, 32, 4, 3), (4, 16, 0, 2), (16, 4, 2, 0), (8, 32, 1, 3),
           (32, 8, 3, 1), (16, 64, 2, 4), (64, 16, 4, 2)]
DCT, ADST, FLIPADST, IDENTITY = 0, 1, 2, 3
WHT_WHT = 16
# 2-D transform type -> (row 1-D type, column 1-D type)
TX_1D = {0: (0, 0), 1: (0, 1), 2: (1, 0), 3: (1, 1), 4: (0, 2), 5: (2, 0),
         6: (2, 2), 7: (2, 1), 8: (1, 2), 9: (3, 3), 10: (3, 0),
         11: (0, 3), 12: (3, 1), 13: (1, 3), 14: (3, 2), 15: (2, 3)}
# operations of one 1-D transform of length 4 << lsz, (lsz, type) ->
# count (clips count 2), and of one 4-point WHT
OPS_1D = {(0, 0): 30, (0, 1): 32, (0, 2): 32, (0, 3): 16, (1, 0): 94,
          (1, 1): 128, (1, 2): 128, (1, 3): 8, (2, 0): 266, (2, 1): 344,
          (2, 2): 344, (2, 3): 80, (3, 0): 698, (3, 3): 32, (4, 0): 1674}
OPS_WHT4 = 8


def kernel_of(tag, args):
    """The call name of a ``devrt.call`` record (the deblock wrapper is
    one call for both directions)."""
    if tag == "deblock":
        return "deblock_v" if args[2] else "deblock_h"
    return tag


def _itx_ops(tx, txtp, rows):
    """Operations of one 2-D transform whose first ``rows`` rows hold a
    nonzero coefficient: the rect2 pre-scale (3 per coefficient), the row
    transforms, the rounding shift and column clip (4 per row element),
    the column transforms and the final (v+8)>>4 (2 per residual);
    WHT_WHT: cf>>2, four row and four column wht4."""
    w, h, lw, lh = TX_INFO[tx]
    if txtp == WHT_WHT:
        return 16 + 8 * OPS_WHT4
    row_t, col_t = TX_1D[txtp]
    rect2 = 3 * min(w, 32) * min(h, 32) if abs(lw - lh) == 1 else 0
    return (rect2 + rows * (OPS_1D[(lw, row_t)] + 4 * w)
            + w * OPS_1D[(lh, col_t)] + 2 * h * w)


def _itx_work(cf, jobs, groups, n_out, bitdepth):
    """(bytes, operations) of an itx call: the coefficients of every job
    read, the job rows read, the residuals written; the operations of
    :func:`_itx_ops` for each job's rows with a nonzero coefficient."""
    import torch

    j = jobs.long()
    n_coef = ops = 0
    for tx in torch.unique(j[:, 1]).tolist():
        g = j[j[:, 1] == tx]
        w, h, _, _ = TX_INFO[tx]
        sw, sh = min(w, 32), min(h, 32)
        n_coef += len(g) * sw * sh
        coef = cf[g[:, 0, None] + torch.arange(sw * sh, device=cf.device)]
        rows = (coef.reshape(len(g), sw, sh) != 0).any(1).sum(1)
        pairs = torch.stack([g[:, 2], rows], 1)
        uniq, cnt = torch.unique(pairs, dim=0, return_counts=True)
        for (txtp, r), c in zip(uniq.tolist(), cnt.tolist()):
            ops += c * _itx_ops(tx, txtp, r)
    nbytes = (4 * n_coef + jobs.numel() * 4
              + n_out * (2 if bitdepth <= 10 else 4))
    return nbytes, ops


def _mc_footprint(coded, jobs):
    """Distinct reference pixels the jobs' clamped windows read: 2-D
    difference array of the rectangles, integrated, counted where
    covered."""
    import torch

    j = jobs.long()
    total = 0
    for e, (vh, vw) in enumerate(coded):
        g = j[j[:, 0] == e]
        if not len(g):
            continue
        y0 = (g[:, 1] - 3).clamp(0, vh - 1)
        y1 = (g[:, 1] + g[:, 4] + 3).clamp(0, vh - 1) + 1
        x0 = (g[:, 2] - 3).clamp(0, vw - 1)
        x1 = (g[:, 2] + g[:, 3] + 3).clamp(0, vw - 1) + 1
        d = torch.zeros((vh + 1, vw + 1), dtype=torch.int32,
                        device=jobs.device)
        one = torch.ones_like(y0, dtype=torch.int32)
        for ys, xs, v in ((y0, x0, one), (y0, x1, -one), (y1, x0, -one),
                          (y1, x1, one)):
            d.index_put_((ys, xs), v, accumulate=True)
        total += int((d.cumsum(0).cumsum(1)[:vh, :vw] > 0).sum())
    return total


def _units_work(kind, jobs, ss_hor=0, ss_ver=0):
    """(bytes, operations) of intra units of one kind: per unit its job
    row, its edge reads (2w + 2h + 1 canvas pixels; none for palette),
    its residual and output windows (for CFL the luma under it, for
    palette its index map); per pixel one blend (2), the residual add (1)
    and the clip (2)."""
    j = jobs.long()
    w, h = j[:, 2], j[:, 3]
    pix = w * h
    per = 8 * pix + 64
    if kind == 0:
        per = per + 4 * (2 * w + 2 * h + 1)
    elif kind == 1:
        per = per + 4 * (2 * w + 2 * h + 1) + 4 * pix * ((1 + ss_hor)
                                                         * (1 + ss_ver))
    else:
        per = per + pix
    return int(per.sum()), int(5 * pix.sum())


def _ipred_work(name, args):
    if name == "ipred_walk":
        jobs, tags, counts = args[3], args[4].long(), args[5]
        nbytes, ops = 4 * (tags.numel() + counts.numel()), 0
        for kind in range(3):
            b, o = _units_work(kind, jobs[(tags & 3) == kind], args[8],
                               args[9])
            nbytes, ops = nbytes + b, ops + o
        return nbytes, ops
    if name == "ipred_cfl":
        return _units_work(1, args[3], args[5], args[6])
    return _units_work(KIND_OF[name], args[2])


def _lr_work(name, jobs):
    """(bytes, operations) of a restoration call: the units' pixels read
    and written, their context rows (2 above with a top edge, 2 below
    with a bottom edge), the job rows.  Wiener: a 7-tap sum (13) and its
    rounding and clip (4) per pixel of the (sh + 6)-row intermediate, the
    same vertically per output pixel.  Self-guided, per radius used: box
    sums and square sums (7 / 13 per element of (sh + 6) x (uw + 2)),
    vertical sums (4 / 8) and the (A, B) derivation (15) per position
    (every row of sh + 2 for the 3x3, odd rows for the 5x5), the
    weighted neighbourhood and correction (24 / 20 per output pixel); the
    blend and clip (7 per output pixel)."""
    j = jobs.long()
    uw, sh, e = j[:, 2], j[:, 3], j[:, 4]
    pix = uw * sh
    ctx = uw * 2 * (((e & 4) > 0).long() + ((e & 8) > 0).long())
    nbytes = 4 * int((2 * pix + ctx).sum()) + jobs.numel() * 4
    if name == "lr_wiener":
        return nbytes, int((17 * (sh + 6) * uw + 17 * pix).sum())
    variant = j[:, 10]
    wide = (sh + 6) * (uw + 2)
    r1 = 7 * wide + 19 * (sh + 2) * (uw + 2) + 24 * pix
    r2 = 13 * wide + 23 * ((sh + 2) // 2) * (uw + 2) + 20 * pix
    ops = (variant != 0).long() * r1 + (variant != 1).long() * r2 + 7 * pix
    return nbytes, int(ops.sum())


def work(name, args):
    """(bytes, 32-bit operations) that the call's function needs on
    ``args``: each input byte read once and each output byte written
    once, and the operations of the plain algorithm counted from below."""
    import torch

    if name in ("deblock_v", "deblock_h"):
        src, cells = args[0], args[1]
        nbytes = 2 * src.numel() * 4 + cells.numel() * 4
        # >= 20 operations per edge line: the filter-mask test and the
        # narrow filter
        return nbytes, 20 * 4 * int(torch.count_nonzero(cells))
    if name == "cdef_dir":
        plane = args[0]
        nb = (plane.shape[0] // 8) * (plane.shape[1] // 8)
        # per pixel: 8 partial-sum adds, shift, offset; per block: the 90
        # cost bins (square, weight, add) and the argmax
        return plane.numel() * 4 + 2 * nb * 4, nb * (64 * 10 + 290)
    if name in ("cdef_filter", "cdef_filter_band"):
        plane, pm, sm, dmap = args[:4]
        w, h, luma = args[7], args[8], args[11]
        # the band form reads its halo rows and writes its rows alone
        halo = sum(args[13:15]) * plane.shape[1]
        # the map words of the units the grids hold (a direction per
        # unit, and a variance in luma)
        maps = (min(pm.shape[0], dmap.shape[0])
                * min(pm.shape[1], dmap.shape[1]) * (2 if luma else 1))
        nbytes = (2 * plane.numel() - halo + pm.numel() + sm.numel()
                  + maps) * 4
        active = int(torch.count_nonzero(pm | sm)) * w * h
        # per filtered pixel: 12 taps, each a constrain (~8 operations)
        return nbytes, active * 100
    if name == "mc":
        planes, coded, jobs, _, n_pix, n_out, bitdepth = args
        j = jobs.long()
        w, h = j[:, 3], j[:, 4]
        # reads: the reference pixels under the clamped windows and the
        # jobs; writes: the predicted pixels
        nbytes = (4 * _mc_footprint(coded, jobs) + jobs.numel() * 4
                  + n_pix * (1 if bitdepth == 8 else 2))
        # separable 8-tap: (h+7)*w horizontal and h*w vertical sums of 8
        # products (15 operations), each rounded (2) and clipped (2)
        ops = int(((h + 7) * w * 17 + h * w * 19).sum())
        return nbytes, ops
    if name == "itx":
        return _itx_work(*args)
    if name == "resize":
        # one plane or a batch: reads each source rectangle, writes each
        # whole output plane; per resampled pixel 8 multiply-adds (16),
        # the rounding shift and the clip (3)
        batch = (zip(args[0], args[1]) if isinstance(args[0], (list, tuple))
                 else [(args[0], args[1:7])])
        nbytes = ops = 0
        for plane, (out_w, src_w, _, _, h, alloc_w) in batch:
            nbytes += 4 * (h * src_w + plane.shape[0] * alloc_w)
            ops += 19 * h * out_w
        return nbytes, ops
    if name in ("lr_wiener", "lr_sgr"):
        return _lr_work(name, args[2])
    if name == "fg":
        lut, sc, offs, w, h, p = args[2:6] + args[6:7] + args[8:9]
        pix = w * h
        # reads: the plane, for chroma the luma rows under it, the
        # tables; writes: the plane.  Per pixel: the grain offset and LUT
        # address (4), the apply (6); chroma adds the luma average (3)
        # and, without chroma-from-luma, the combine and its clip (6)
        luma = h * (w << p.ss_x) if p.pl else 0
        nbytes = 4 * (2 * pix + luma + lut.numel() + sc.numel()
                      + offs.numel())
        ops = pix * (10 + (3 + 6 * (not p.csfl) if p.pl else 0))
        return nbytes, ops
    if name in KERNEL_OF_CALL and name.startswith("ipred"):
        return _ipred_work(name, args)
    raise KeyError(name)


def bound_ms(name, args):
    """The larger of bytes over the memory rate and operations over the
    operation rate, in ms."""
    nbytes, ops = work(name, args)
    return max(nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S) * 1e3
