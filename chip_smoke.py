#!/usr/bin/env python3
"""GPU smoke run of dav1d_tpu_torch, the PyTorch/CUDA port of the
decoder, on one CUDA card.

Run from the root of a checkout, on a machine with a CUDA GPU, PyTorch
built for CUDA and nvcc (no libaom, no network needed):

    python3 chip_smoke.py

The port imports nothing of the JAX package and never imports jax,
even where jax is installed, so only the port's kernels touch the card.
The run fails if jax was imported.

Phases; any failure exits non-zero:

1. print the card's name and power limit (nvidia-smi);
2. build the port's kernels from csrc/ (one nvcc per source, sm_90a)
   and, at the same time, the port's native C (cc, native/); print
   ptxas's registers and spills, the itx kernel's registers, shared
   memory and resident CTAs per SM at 8/10 and 12-bit, and the
   registers and shared memory of the fg (luma, chroma), lr_wiener,
   lr_sgr and resize kernels (resize also its CTAs per SM);
3. hold each kernel against its plain PyTorch version on the card,
   exactly, at the decoder's 1080p shapes (4:2:0 luma and chroma planes,
   random edge/unit maps with every class present; CDEF also on flat
   planes with spikes, at mid range and up to 2^bd-1, where the [min,
   max] clip bites next to the sentinel, and on a 4:2:2-shaped
   1088x960 chroma plane with 4x8 units; MC job lists over
   three references with every block size the device-MC selection
   takes, windows inside, over every edge and beyond the reference's
   MC_PAD border, junk in the allocation rows and columns beyond the
   coded size, and one of only 128x128 luma and 4x4 chroma jobs (the
   largest split into tiles, the smallest tiles), both also with two
   jobs in three compound (CT_AVG and CT_WEIGHTED_AVG over a second
   reference) among the single ones; itx job lists holding
   every valid (tx, txtp) pair with random and extreme coefficients,
   shuffled, in an arena with gaps, and sparse ones: zero rows between
   nonzero rows, a lone coefficient in the last column of the last
   coded row, DC only, partly full groups; the direction search also on
   a plane of blocks whose costs tie; the super-res resample one plane a
   launch at the 1080p super-res stream's luma and chroma geometry
   (denominator 16: 960 -> 1920, 480 -> 960) on random and extreme
   pixels and at denominators 9 and 12, and the frame's three planes with
   its snapshot's in one launch, junk in the rows beyond the frame and
   the columns beyond the coded width; the Wiener and self-guided
   (variants 0, 1, 2) units on job tables at the 1080p planes with unit
   widths 128/192/256/384 and stripe heights 28/32/56/64 in all 16 edge
   combinations, on blocky planes and on the pixels {0, 1, 2^bd-2,
   2^bd-1}, where the self-guided products are largest, each through its
   chunk table with the wrapper's bands and with forced bands (Wiener 64
   rows, self-guided 8), and both also on units narrower than a 16-byte
   copy or a chunk (1, 2, 3, 37, 65 columns) on stripes of 4, 13 and 28
   rows; film grain (fg) on every
   plane of 1080p 4:2:0 pictures with random grain parameters: luma,
   chroma with uv_mult, chroma from luma, overlap on and off, the
   restricted range, an odd 1919x1079 picture, junk beyond it in the
   allocation, and that picture's planes starting one column into their
   allocation (no row 16-byte aligned: the kernel's ragged path); the intra
   kernels on 1080p-shaped canvases: prediction units (ipred) of every
   size 4..64, mode, angle of tests/test_ops_ipred.py:50,58,69 with
   every flag, and edge-availability combination on the luma canvas and
   the stacked chroma pair, CFL units (ipred_cfl) on the stacked chroma
   pair with the luma canvas, palette units (ipred_pal), on random and
   extreme pixels; the walk (ipred_walk, every level of a chain in one
   launch) on six levels of prediction and palette units on the luma
   canvas and of all three kinds on the stacked chroma pair, and on 300
   levels of 6 units), bit depths 8/10/12; K2's band form
   (cdef_filter_band: the filter on a row band's canvas with 2 halo rows
   of each neighbour) on every band of the 1080p luma and chroma planes
   and of a 4:2:2-shaped chroma plane cut into 2, 4 and 8 bands as the
   mesh cuts them;
4. decode the committed 1080p 8-bit inter stream (the main path of the
   earlier kernels), the committed 10-bit stream and the two committed
   1080p loop-restoration streams (super-res + Wiener on every frame;
   Wiener and, in the key frame, self-guided units) with
   ``Decoder(..., device="cuda")`` through send_data/get_picture, and
   check the md5 of every output plane against the committed md5 (the
   JAX package's host tier).  The launch counts are zeroed just before
   each decode and read just after: on the inter stream every
   filter-chain kernel must have launched at least once per frame, the
   itx and direction kernels exactly once per frame and the MC kernel at
   least once per inter frame; on the restoration streams, frame by
   frame, the resize kernel exactly once on every super-res frame (the
   frame's planes and the snapshot's in one launch), the Wiener kernel
   on every frame with Wiener units, the self-guided kernel on the frame
   with self-guided units, and on every frame with super-res or
   restoration one upload of planes (the reconstructed ones) and no
   ``chain.upload_final``; the transform blocks of the itx kernel, the
   share of inter blocks the MC kernel predicted and the restoration
   units are printed; the committed film-grain streams (1080p 8-bit,
   352x288 10-bit) and the palette stream against their md5s, with one
   fg launch per plane with grain on every picture; the main stream, the
   10-bit stream and the palette stream again with
   ``Decoder(..., device_intra=True)`` against the same md5s, frame by
   frame one ipred_walk launch per chain holding units (luma, the
   stacked chroma pair) and no launch of a per-level kernel, none on a
   frame the device stage hands to the host walk (their count is
   printed); on the main stream's key frame each walk runs 20 times from
   a copy of its input canvas, bitwise equal each time, to the decode's
   output and to the frame's levels replayed through the per-level
   kernels (ipred, ipred_cfl, ipred_pal) from the same copy, both timed
   with CUDA events; a walk of 4,096 one-unit levels gives the latency
   floor of a level (one handoff through L2 plus the smallest unit);
   the three 1080p chain streams (main, restoration, super-res +
   restoration) with ``Settings(mesh=Mesh([cuda:0] * n))`` for n = 2
   and 4 (row bands on the one card) against their md5s, frame by frame:
   K1 once per band and direction with edges (every band with luma rows
   among them), K5 once per band with luma rows, K2 once per band and
   plane with units, the restoration kernels once per share holding
   their units, and itx n times a frame; the halo bytes per frame are
   printed; the seven streams again with ``Settings(n_threads=4)``
   (worker threads: frames in flight at once), and the main stream with
   n_threads=4 and a 2-band mesh, each against its md5 and the launches
   of its decode with n_threads=0; the four small streams of the other
   layouts (4:2:2 8-bit, 4:4:4 10-bit, 4:2:0 12-bit, monochrome) on one
   device and with a 2-band mesh against their md5s;
5. time the 1080p decode (frames/s, best of 3 after the warm-up decode),
   and with a mesh of 2 and of 4 bands on the one card (best of 3, then
   the stage spans of one more decode: bands on one card measure what
   the band work costs, not scaling),
   then decode it once more with the stage spans and transfer counters
   on, capturing the MC, CDEF filter and itx kernels' real calls: each
   is held against the plain version (exact), and each itx call's jobs
   by tx size, nonzero coefficients and rows are printed; time each
   kernel's wrapper
   against its plain version (CUDA events, in turns plain, kernel,
   kernel, plain): the deblock and direction kernels on the 8-bit 1080p
   luma case of phase 3, the CDEF filter on the decode's largest luma
   call, MC on the largest captured frame, itx on two calls (the one
   with the most jobs, the key frame's, and the inter call with the
   most 64x64 jobs), resize on the super-res decode's frame call (six
   planes), on that call's luma plane alone and on a denominator-9 luma
   plane, the self-guided kernel on the decode's 16-unit call; time the
   bare launches of the C entry point on the same input, queued behind a
   spin kernel so that the card runs them back to back (``launch_ms``:
   device time, where the wrapper's ``ms`` also holds its host work),
   with the registers and shared memory of fg, lr_wiener, lr_sgr and
   resize beside them, and an empty kernel's launch, the floor under
   them all;
   and compute each kernel's bound, the least time the card could take for
   the same inputs (bytes over 3.35 TB/s or 32-bit operations over 67
   Tops/s, whichever is larger), and its share, bound over launch
   time; time on the host what the MC tile list adds to the
   ``pass2.mc.launch`` span on the decode's own job lists; film grain's
   spans and transfer bytes per picture, the ``pass2.intra.*`` spans of
   the intra streams with device intra off and on, its levels, units per
   kind and host-walk frames, each frame's walks replayed back to back
   (device time); the bound per frame of K9, the walk and K10-K12 (their
   units in the walks) on their decodes' calls; K9 and K10-K12 timed on
   those calls (the largest grained plane; the level with the most units
   of each kind, from its walk's input canvas), the walk on the main key
   frame's luma chain, its plain version once (held equal to the walk),
   and its latency floor (its levels times the floor of a level).

6. the port's entry points on the card: the CLI (``python -m
   dav1d_tpu_torch.cli``, in a subprocess on its default device) on the
   main stream with ``--muxer md5 --verify`` of the JAX CLI's digest
   (``cli_md5`` in md5.json: exit 0, the same digest, its status line's
   frames/s, and its K3/K4/K1/K2/K5 launches counted in that process),
   and with a wrong digest (exit 1); the player's ``--ppm`` dump of the
   first two frames against the JAX player's (``ppm_md5``);
   ``gop.gop_decode`` with 2 spawned workers and ``gop.relay_decode``
   with 2 segments of the 8-frame, two-GOP 1080p stream against its md5;
   the fused step of ``entry.entry()`` on the card, one K3 and one K4
   launch, equal to its plain version on CPU tensors; then
   ``entry.dryrun_multichip(2)`` and ``(4)``; and the scaling tool's
   parts A (the main stream at 1, 2 and 4 bands, byte-equal to one
   device, with the halo and band work per frame) and B (the band
   kernels' calls of the main and restoration streams replayed at full
   size and at the 1/n share, CUDA events), printed on a line of their
   own;
7. the JAX suite's AV1 features on the card: every stream of
   dav1d_tpu_torch/data/features/ (one per libaom recipe of
   tests/test_e2e_aom.py ``CASES`` and ``SCREEN_CASES``, and its annexb
   and section-5 streams; ``tools/torch_smoke_streams.py --features``)
   with ``Decoder(..., device="cuda")`` in fused mode (``two_pass=False``,
   ``Settings()``'s default), in two-pass mode and in two-pass mode with
   ``device_intra=True`` (the 4K stream without it), each against the
   JAX package's md5 in features/md5.json; after each fused and
   two-pass decode every reference slot's host planes equal its
   resident device planes; frame by frame: a coded-lossless frame
   launches no deblock, CDEF, restoration or resize kernel (and its
   frame's itx launch ran in two-pass mode), the resize kernel once on
   every super-res frame and on no other, no MC or itx launch in fused
   mode and the chain's launches of two-pass mode, fg once per grained
   plane on the grain streams, and with device intra the walk checks of
   phase 4; the odd geometries (odd sizes, 4:4:4 at 347x251, 64x64
   superblocks, 2x2 tiles, 4K) with a mesh of 2 and of 3 bands on the
   card, against their md5s and the band launch checks; the MC, itx,
   CDEF filter, resize and restoration calls of the two-pass decodes of
   the kitchen-sink, lossless, 12-bit, random super-res, 4:4:4
   restoration, small super-res and multi-unit restoration (self-guided
   units) streams held against the plain versions, exactly; the
   CLI with ``--twopass 0`` on the kitchen-sink stream against its md5;
   film grain's 10-bit chroma launches (``grain_10bit`` and the
   committed 352x288 10-bit stream) timed (device time, bound); one line
   per decode: stream, mode, frames, md5, launches by kernel, frames/s.

The line before the last is the kernels' JSON report; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import functools
import hashlib
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DATA = ROOT / "dav1d_tpu_torch" / "data"
MAIN_STREAM = "inter_1080p_8bit.ivf"
HBD_STREAM = "hbd10_128x96.ivf"
# super-res + Wiener on every frame; Wiener and self-guided units
SR_STREAM = "superres_lr_1080p_8bit.ivf"
LR_STREAM = "lr_1080p_8bit.ivf"
LR_KERNELS = ("resize", "lr_wiener", "lr_sgr")
# film grain on every frame (1080p 8-bit; 352x288 10-bit)
FG_STREAM = "grain_1080p_8bit.ivf"
FG_HBD_STREAM = "grain_hbd10_352x288.ivf"
# two palette-coded 1080p key frames
SCREEN_STREAM = "screen_1080p_8bit.ivf"
# one level of one kind a launch (K10-K12): held against their plain
# versions and against the walk, on no decode path since the walk
LEVEL_KERNELS = ("ipred", "ipred_cfl", "ipred_pal")
KIND_OF = {"ipred": 0, "ipred_cfl": 1, "ipred_pal": 2}
# every level of a chain in one launch: the device intra path
INTRA_KERNELS = LEVEL_KERNELS + ("ipred_walk",)
# decoded with device_intra=True as well: the main stream's key frame
# (prediction and CFL units), the 10-bit stream, the palette stream
INTRA_STREAMS = (MAIN_STREAM, HBD_STREAM, SCREEN_STREAM)
# the decode whose launches fg and the walk report: (stream, device_intra)
PATH_OF = {"fg": (FG_STREAM, False), "ipred_walk": (MAIN_STREAM, True)}
# multi-device decode (Settings.mesh): bands on the one card, decoded for
# each count of bands on the three 1080p chain streams; K2's band form
# reports the main stream's decode with MESH_PATH bands
MESH_BANDS = (2, 4)
MESH_STREAMS = (MAIN_STREAM, LR_STREAM, SR_STREAM)
MESH_PATH = 2
# K2's band form in phase 3: every band of these counts at 1080p
BAND_CASE_BANDS = (2, 4, 8)
# the layouts beside 4:2:0 (small streams, phase 4: single-device and
# with a 2-band mesh)
LAYOUT_STREAMS = ("i422_8bit_256x192.ivf", "i444_10bit_256x192.ivf",
                  "i420_12bit_256x192.ivf", "mono_8bit_256x192.ivf")
# decoded again with worker threads (Settings.n_threads)
THREAD_STREAMS = (MAIN_STREAM, HBD_STREAM, SR_STREAM, LR_STREAM, FG_STREAM,
                  FG_HBD_STREAM, SCREEN_STREAM)
N_THREADS = 4
# the stream whose walks give each per-level kernel its timed level
LEVEL_STREAM = {"ipred": MAIN_STREAM, "ipred_cfl": MAIN_STREAM,
                "ipred_pal": SCREEN_STREAM}

# phase 6, the entry points: the CLI and the player on the main stream,
# GOP-parallel and relay decodes of an 8-frame stream of two GOPs, the
# fused step and its mesh dry run, and the scaling tool at these bands
GOP_STREAM = "gop_1080p_8bit.ivf"
SCALING_BANDS = (1, 2, 4)
# the main stream's kernels (K3, K4, K1, K2, K5), counted in the CLI's run
CLI_KERNELS = ("mc", "itx", "deblock_v", "deblock_h", "cdef_filter",
               "cdef_dir")

# phase 7, the JAX suite's AV1 features (module docstring)
FEATURE_DIR = DATA / "features"
FEATURE_MODES = ("fused", "two_pass", "device_intra")
# decoded without device_intra (its Python schedule at 3840x2160)
FEATURE_NO_INTRA = ("uhd4k_smoke.ivf",)
# the odd geometries, decoded again with a mesh of each of these bands
FEATURE_MESH = ("odd_size.ivf", "restoration_444_odd.ivf", "screen_odd.ivf",
                "sb64.ivf", "superres_random.ivf", "tiles_full.ivf",
                "uhd4k_smoke.ivf")
FEATURE_MESH_BANDS = (2, 3)
# the two-pass decodes whose own kernel calls are held against the plain
# versions (superres_lr: the small super-res stream, resize;
# restoration_multiunit: the one with self-guided units)
FEATURE_CALLS = ("kitchen_sink.ivf", "lossless.ivf", "hbd12.ivf",
                 "superres_random.ivf", "restoration_444_odd.ivf",
                 "superres_lr.ivf", "restoration_multiunit.ivf")
CALL_TAGS = ("mc", "itx", "cdef_filter", "resize", "lr_wiener", "lr_sgr")
# film grain on every picture: one fg launch per grained plane
FEATURE_GRAIN = ("grain.ivf", "grain_10bit.ivf",
                 "fhd_grain_superres_tiles.ivf")
# the CLI in fused mode (--twopass 0)
FEATURE_CLI = "kitchen_sink.ivf"
# the kernels a coded-lossless frame must not launch
FILTER_KERNELS = ("deblock_v", "deblock_h", "cdef_dir", "cdef_filter",
                  "cdef_filter_band", "lr_wiener", "lr_sgr", "resize")

# kernel name -> (source, TPU kernel it replaces)
KERNELS = {
    "deblock_v": ("dav1d_tpu_torch/csrc/deblock.cu",
                  "dav1d_tpu/ops/pallas_lf.py:270"),
    "deblock_h": ("dav1d_tpu_torch/csrc/deblock.cu",
                  "dav1d_tpu/ops/pallas_lf.py:341"),
    "cdef_dir": ("dav1d_tpu_torch/csrc/cdef_dir.cu",
                 "dav1d_tpu/ops/cdef.py:159"),
    "cdef_filter": ("dav1d_tpu_torch/csrc/cdef_filter.cu",
                    "dav1d_tpu/ops/pallas_cdef.py:200"),
    # the same kernel launched on a row band with halo rows (the mesh's
    # CDEF, dav1d_tpu/recon/mesh_cdef.py:41 over ops/cdef.py:192)
    "cdef_filter_band": ("dav1d_tpu_torch/csrc/cdef_filter.cu",
                         "dav1d_tpu/ops/pallas_cdef.py:200"),
    "mc": ("dav1d_tpu_torch/csrc/mc.cu",
           "dav1d_tpu/ops/pallas_mc.py:164"),
    "itx": ("dav1d_tpu_torch/csrc/itx.cu",
            "dav1d_tpu/ops/pallas_itx.py:106"),
    "resize": ("dav1d_tpu_torch/csrc/resize.cu",
               "dav1d_tpu/ops/resize.py:24"),
    "lr_wiener": ("dav1d_tpu_torch/csrc/lr.cu",
                  "dav1d_tpu/ops/lr.py:22"),
    "lr_sgr": ("dav1d_tpu_torch/csrc/lr.cu",
               "dav1d_tpu/ops/lr.py:124"),
    "fg": ("dav1d_tpu_torch/csrc/fg.cu", "dav1d_tpu/ops/fg.py:21"),
    "ipred": ("dav1d_tpu_torch/csrc/ipred.cu",
              "dav1d_tpu/recon/device_intra.py:230"),
    "ipred_cfl": ("dav1d_tpu_torch/csrc/ipred.cu",
                  "dav1d_tpu/recon/device_intra.py:320"),
    "ipred_pal": ("dav1d_tpu_torch/csrc/ipred.cu",
                  "dav1d_tpu/recon/device_intra.py:406"),
    "ipred_walk": ("dav1d_tpu_torch/csrc/ipred.cu",
                   "dav1d_tpu/recon/device_intra.py:260"),
}
# kernels that the main stream's default decode does not launch
OTHER_PATHS = LR_KERNELS + ("fg",) + INTRA_KERNELS + ("cdef_filter_band",)

# the card's peak rates for the bounds (H100 SXM data sheet, at 700 W):
# device memory, and 32-bit scalar operations outside the tensor cores
# (the float32 rate; integer operations issue at most as fast, so the
# operation bound is a lower bound)
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
# the JAX package's replicated MC border (dav1d_tpu/pipeline.py MC_PAD):
# windows beyond it took the reference's slowest tier
MC_PAD = 64


class SmokeError(RuntimeError):
    pass


def _jax_modules():
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib"))


def _require(cond, msg):
    if not cond:
        raise SmokeError(msg)


# ---- inputs at the decoder's shapes ------------------------------------

def _plane(rng, H, W, bitdepth):
    """Blocky content with small steps and flat/noisy regions, so the
    deblock decision lattice takes every branch (narrow, wd6/8 flat,
    wd16 flat) and CDEF sees directional structure."""
    import numpy as np

    F = 1 << (bitdepth - 8)
    maxp = (1 << bitdepth) - 1
    nby, nbx = -(-H // 8), -(-W // 8)
    base = rng.integers(100, 140, (nby, nbx)) * F
    base = np.repeat(np.repeat(base, 8, 0), 8, 1)[:H, :W]
    flat = np.repeat(np.repeat(rng.random((-(-H // 32), -(-W // 32)))
                               < 0.5, 32, 0), 32, 1)[:H, :W]
    noise = np.where(flat, rng.integers(0, 2, (H, W)),
                     rng.integers(-8, 9, (H, W))) * F
    yy, xx = np.mgrid[0:H, 0:W]
    ramp = ((xx + 2 * yy) % 16) * F * (~flat)
    return np.clip(base + noise + ramp, 0, maxp).astype(np.int32)


def _spikes(rng, H, W, bitdepth, top=False):
    """A flat plane with sparse small bright spikes: under strong CDEF
    strengths the filter overshoots and the [min, max] clip bites, also
    next to the plane edge where sentinel taps must not lower the min.
    ``top``: the spikes at the largest pixel value, 2^bitdepth - 1."""
    import numpy as np

    s = bitdepth - 8
    base = (1 << bitdepth) - 1 - (4 << s) if top else 128 << s
    return base + ((rng.random((H, W)) < 0.1).astype(np.int32) << (2 + s))


def _cells(rng, H, W, luma, bitdepth):
    """Vertical and horizontal packed cell maps from a random transform
    tiling of each 32-px superblock (the bitstream's edge geometry:
    edges on transform boundaries, class 1 + min(cap, adjacent tx log
    sizes)), every width class present."""
    import numpy as np

    from dav1d_tpu_torch.state import lf_limits

    e_lut, i_lut = lf_limits(int(rng.integers(0, 8)))
    H4, W4 = -(-H // 4), -(-W // 4)
    cap = 2 if luma else 1
    maps = []
    for vertical in (True, False):
        t = rng.integers(0, 4, (-(-H4 // 8), -(-W4 // 8)))
        tc = np.repeat(np.repeat(t, 8, 0), 8, 1)[:H4, :W4]
        idx = np.arange(W4 if vertical else H4)
        if vertical:
            prev = np.concatenate([tc[:, :1], tc[:, :-1]], axis=1)
            on = (idx[None, :] > 0) & (idx[None, :] % (1 << tc) == 0)
        else:
            prev = np.concatenate([tc[:1], tc[:-1]], axis=0)
            on = (idx[:, None] > 0) & (idx[:, None] % (1 << tc) == 0)
        cls = 1 + np.minimum(cap, np.minimum(prev, tc))
        L = rng.integers(1, 64, (H4, W4))
        pk = (e_lut[L].astype(np.int64) | (i_lut[L].astype(np.int64) << 8)
              | ((L >> 4) << 16) | (cls << 24))
        maps.append(np.where(on, pk, 0).astype(np.int32))
        _require(set(np.unique(cls[on])) == set(range(1, cap + 2)),
                 "cell map misses a class")
    return maps


def _units(rng, nb, nc, bitdepth):
    import numpy as np

    s = bitdepth - 8
    on = rng.random((nb, nc)) < 0.7
    pri = rng.integers(0, 16, (nb, nc)) * on
    sec = rng.integers(0, 4, (nb, nc))
    sec = (sec + (sec == 3)) * on
    return ((pri << s).astype(np.int32), (sec << s).astype(np.int32))


# 1080p 4:2:0, superblock-aligned allocation (decode/frame.FrameContext):
# (alloc rows, alloc cols, coded rows, coded cols)
SHAPES = {"luma": (1088, 1920, 1080, 1920),
          "chroma": (544, 960, 540, 960)}


def _band_cases(label, n, plane, pm, sm, maps, ph, pw, w, h, damping, bd,
                luma, l422):
    """K2's band form on every band with filtered rows of ``plane`` cut
    into ``n`` bands as the mesh cuts it (mesh.Mesh.band_rows): the
    band's canvas with 2 halo rows of each neighbour (none above the
    first band, none below the band holding row ph - 1), its rows of the
    unit grids and of the maps."""
    import torch

    from dav1d_tpu_torch.ops import cdef as ocdef

    H, W = plane.shape
    bh = mesh_of(plane.device, n).band_rows(ph)
    out = []
    for b in range(n):
        y0 = b * bh
        if y0 >= ph:
            continue
        top, bottom = 2 if b else 0, 2 if y0 + bh < ph else 0
        canvas = torch.zeros((top + bh + bottom, W), dtype=torch.int32,
                             device=plane.device)
        rows = plane[y0 - top:min(H, y0 + bh + bottom)]
        canvas[:rows.shape[0]] = rows
        ph_b = min(bh, ph - y0)
        u0, nb = y0 // h, -(-ph_b // h)
        out.append((
            f"{label}: band {b} top {top} bottom {bottom} bd{bd}",
            ocdef.filter_plane, ocdef.filter_plane_plain,
            (canvas, pm[u0:u0 + nb], sm[u0:u0 + nb],
             maps[0][u0:u0 + nb], maps[1][u0:u0 + nb], ph_b, pw, w, h,
             damping, bd, luma, l422, top, bottom)))
    return out


def _mc_args(rng, device, bitdepth, shapes=SHAPES, n_refs=3, per=8,
             blocks=None, compound=False):
    """MC kernel arguments as a frame gives them: ``n_refs`` references
    of (luma, chroma, chroma) planes, allocation-sized with junk beyond
    the coded size; ``per`` jobs per (plane, block size) for every block
    size the 4:2:0 selection takes (or, with ``blocks``, {plane kind:
    (w, h)}, that one size per plane), a third of them inside the plane,
    a third over an edge, the rest anywhere up to 2*MC_PAD outside;
    filter rows from the subpel table, identity rows and random signed
    taps.  With ``compound``, two jobs in three blend a second reference
    (the same plane of the next reference, another job's origin and
    filter rows), by CT_AVG or CT_WEIGHTED_AVG with a jnt weight of the
    codec's table, among the single-reference jobs of one launch."""
    import numpy as np
    import torch

    from dav1d_tpu_torch import tables
    from dav1d_tpu_torch.ops import mc as omc

    planes, coded, sub = [], [], []
    for _ in range(n_refs):
        for kind in ("luma", "chroma", "chroma"):
            H, W, vh, vw = shapes[kind]
            p = rng.integers(0, 1 << bitdepth, (H, W))
            junk = rng.integers(-(1 << 20), 1 << 20, (H, W))
            p[vh:] = junk[vh:]
            p[:, vw:] = junk[:, vw:]
            planes.append(torch.from_numpy(p.astype(np.int32)).to(device))
            coded.append((vh, vw))
            sub.append(kind == "chroma")
    bdim = tables.block_dimensions[:22]
    subf = tables.mc_subpel_filters.astype(np.int32)
    cols = []
    sizes = [(int(bw4) * 4, int(bh4) * 4)
             for bw4, bh4 in bdim[(bdim[:, 0] > 1) & (bdim[:, 1] > 1), :2]]
    for e, (vh, vw) in enumerate(coded):
        for w, h in ([(w >> sub[e], h >> sub[e]) for w, h in sizes]
                     if blocks is None else
                     [blocks["chroma" if sub[e] else "luma"]]):
            dy = rng.integers(-h - 2 * MC_PAD, vh + 2 * MC_PAD, per)
            dx = rng.integers(-w - 2 * MC_PAD, vw + 2 * MC_PAD, per)
            q = per // 3
            dy[:q] = rng.integers(0, vh - h, q)
            dx[:q] = rng.integers(0, vw - w, q)
            dy[q:2 * q] = rng.integers(-h - 4, 4, q)
            dx[q:2 * q] = rng.integers(vw - w - 4, vw + 4, q)
            fl = []
            for side in (w, h):
                sets = rng.integers(0, 3, per)
                sets = sets if side > 4 else 3 + (sets & 1)
                rows = subf[sets, rng.integers(0, 15, per)]
                kind = rng.integers(0, 3, per)
                rows[kind == 1] = 0
                rows[kind == 1, 3] = 64
                rows[kind == 2] = rng.integers(-64, 128, (per, 8))[kind == 2]
                fl.append(rows)
            cols.append((np.full(per, e), dy, dx, np.full(per, w),
                         np.full(per, h), *fl))
    e, dy, dx, w, h, fh, fv = (np.concatenate(c) for c in zip(*cols))
    order = rng.permutation(len(e))
    comp = None
    if compound:
        # another job of the same plane and size lends its origin and
        # filter rows to the second reference
        n = len(e)
        key = (e % 3) * (1 << 20) + w * 1024 + h
        o = np.argsort(key * n + rng.permutation(n), kind="stable")
        lend = np.empty(n, np.int64)
        lend[o] = np.roll(o, 1)
        lend = np.where(key[lend] == key, lend, np.arange(n))
        ct = np.where(rng.integers(0, 2, n) == 0, omc.CT_AVG,
                      omc.CT_WEIGHTED_AVG)
        ct[rng.integers(0, 3, n) == 0] = omc.CT_NONE
        jw = rng.choice([2, 3, 4, 5, 7, 9, 11, 12, 13, 14], n)
        comp = tuple(a[order] for a in ((e + 3) % (3 * n_refs), dy[lend],
                                        dx[lend], fh[lend], fv[lend], ct,
                                        jw))
    # output: each job's block in a row of blocks 128 wide (stride 128)
    size = (128 * h)[order].astype(np.int64)
    off = np.cumsum(size) - size
    jobs, tiles, n_pix = omc.job_table(e[order], dy[order], dx[order],
                                       w[order], h[order], off, 128,
                                       fh[order], fv[order],
                                       int(size.sum()), compound=comp)
    return (planes, coded, torch.from_numpy(jobs).to(device),
            torch.from_numpy(tiles).to(device), n_pix, int(size.sum()),
            bitdepth)


def _itx_args(rng, device, bitdepth, per=48):
    """itx kernel arguments as a frame gives them: ``per`` blocks of
    every valid (tx, txtp) pair, shuffled, in a coefficient arena with
    gaps between blocks; coefficients random within +-(1 << (bd + 7))
    (WHT_WHT, the lossless transform whose residuals are pixel
    differences: +-(1 << (bd + 1))), a few blocks at the extremes, which
    drive the row and column clips, and a DC-only block per pair."""
    import numpy as np
    import torch

    from dav1d_tpu_torch.ops import itx as oitx

    pairs = [(tx, tp) for tx in range(oitx.N_TX)
             for tp in range(oitx.N_TXTP) if oitx.valid_pair(tx, tp)]
    chunks, offs, txs, tps, eobs = [], [], [], [], []
    pos = 0
    for tx, txtp in pairs:
        w, h, _, _ = oitx._txinfo(tx)
        nc = min(w, 32) * min(h, 32)
        cmax = 1 << (bitdepth + 1 if txtp == 16 else bitdepth + 7)
        cf = rng.integers(-cmax, cmax, (per, nc)).astype(np.int32)
        cf[0] = cmax - 1
        cf[1] = -cmax
        cf[2] = np.where(rng.random(nc) < 0.5, cmax - 1, -cmax)
        cf[3, 1:] = 0
        for row in cf:
            gap = int(rng.integers(0, 5))
            chunks += [np.zeros(gap, np.int32), row]
            offs.append(pos + gap)
            pos += gap + nc
            txs.append(tx)
            tps.append(txtp)
            eobs.append(int(rng.integers(0, nc)))
    return _itx_table(device, bitdepth, chunks, offs, txs, tps, eobs,
                      rng.permutation(len(offs)))


def _itx_table(device, bitdepth, chunks, offs, txs, tps, eobs, perm):
    """itx kernel arguments from the blocks ``chunks`` (gaps and
    coefficient windows) taken in the order ``perm``."""
    import numpy as np
    import torch

    from dav1d_tpu_torch.ops import itx as oitx

    arena = np.concatenate(chunks)
    _, jobs, groups, n_out = oitx.job_table(
        *(np.asarray(c)[perm] for c in (offs, txs, tps, eobs)), len(arena))
    return (torch.from_numpy(arena).to(device),
            torch.from_numpy(jobs).to(device),
            torch.from_numpy(groups).to(device), n_out, bitdepth)


def _itx_plain(cf, jobs, groups, n_out, bitdepth):
    """The plain itx version on the wrapper's arguments (the groups are
    the kernel's schedule, not an input of the function)."""
    from dav1d_tpu_torch.ops import itx as oitx

    return oitx.itx_frame_plain(cf, jobs, n_out, bitdepth)


def _itx_sparse_args(rng, device, bitdepth, per=11):
    """itx kernel arguments of sparse blocks, ``per`` of each pattern
    for every valid (tx, txtp) pair: nonzero rows 0, sh/3 and sh-1 with
    zero rows between them; a lone coefficient in the last column of the
    last coded row; DC only; one nonzero row in the middle, its first
    column zero.  ``per`` is no multiple of a group's job count, so the
    last group of each tx size is partly full and ends where the size
    changes."""
    import numpy as np

    from dav1d_tpu_torch.ops import itx as oitx

    chunks, offs, txs, tps, eobs = [], [], [], [], []
    pos = 0
    for tx in range(oitx.N_TX):
        for txtp in range(oitx.N_TXTP):
            if not oitx.valid_pair(tx, txtp):
                continue
            w, h, _, _ = oitx._txinfo(tx)
            sw, sh = min(w, 32), min(h, 32)
            cmax = 1 << (bitdepth + 1 if txtp == 16 else bitdepth + 7)
            for pat in range(4):
                cf = np.zeros((per, sw, sh), np.int64)  # [x][y]
                vals = rng.integers(1, cmax, (per, sw, sh)) * \
                    rng.choice([-1, 1], (per, sw, sh))
                if pat == 0:
                    rows = [0, max(1, sh // 3), sh - 1]
                    cf[:, :, rows] = vals[:, :, rows]
                elif pat == 1:
                    cf[:, sw - 1, sh - 1] = vals[:, 0, 0]
                elif pat == 2:
                    cf[:, 0, 0] = vals[:, 0, 0]
                else:
                    y = sh // 2
                    cf[:, 1:, y] = vals[:, 1:, y]
                for row in cf.reshape(per, -1).astype(np.int32):
                    gap = int(rng.integers(0, 5))
                    chunks += [np.zeros(gap, np.int32), row]
                    offs.append(pos + gap)
                    pos += gap + len(row)
                    txs.append(tx)
                    tps.append(txtp)
                    eobs.append(int(np.flatnonzero(row).max(initial=0)))
    return _itx_table(device, bitdepth, chunks, offs, txs, tps, eobs,
                      rng.permutation(len(offs)))


def _dir_ties(rng, H, W, bitdepth):
    """A plane of 8x8 blocks whose direction costs tie: flat blocks
    (at mid grey every cost is 0), blocks at 0 and at 2^bd - 1, and
    transpose-symmetric blocks (f(y) + f(x), g(y + x), max(f(y), f(x)):
    the costs of hv0 and hv1, alt0 and alt3, alt1 and alt2 tie, so the
    first maximum must win), with 0 / 2^bd - 1 checkerboards, the
    largest partial sums."""
    import numpy as np

    hi = (1 << bitdepth) - 1
    nby, nbx = -(-H // 8), -(-W // 8)
    n = nby * nbx
    yy, xx = np.mgrid[0:8, 0:8]
    f = rng.integers(0, hi + 1, (n, 8))
    g = rng.integers(0, hi + 1, (n, 15))
    lvl = rng.integers(0, hi + 1, n)[:, None, None]
    kinds = np.stack([
        (f[:, yy] + f[:, xx]) // 2, g[:, yy + xx],
        np.maximum(f[:, yy], f[:, xx]),
        np.broadcast_to(lvl, (n, 8, 8)),
        np.full((n, 8, 8), 128 << (bitdepth - 8)),
        np.zeros((n, 8, 8), np.int64), np.full((n, 8, 8), hi),
        np.broadcast_to(((yy + xx) % 2) * hi, (n, 8, 8))])
    b = kinds[rng.integers(0, len(kinds), n), np.arange(n)]
    plane = b.reshape(nby, nbx, 8, 8).transpose(0, 2, 1, 3)
    return plane.reshape(nby * 8, nbx * 8)[:H, :W].astype(np.int32)


def _sr_frame(denom=16):
    """The attributes decode/frame.superres_geometry reads, for a 1080p
    4:2:0 frame upscaled to 1920 from the super-res denominator ``denom``
    (9-16; obu.py: w0 = (1920 * 8 + denom // 2) // denom): 16 is the 1080p
    super-res stream's, coded 960 wide (bw = 240 4-px columns)."""
    from types import SimpleNamespace

    w0 = (1920 * 8 + (denom >> 1)) // denom
    hdr = SimpleNamespace(width=(w0, 1920), height=1080)
    return SimpleNamespace(frame_hdr=hdr, ss_hor=1, ss_ver=1,
                           bw=((w0 + 7) >> 3) << 1)


def _sr_planes(rng, shapes, bd, denom=16, makes=None):
    """A frame's three planes and, with two ``makes``, its snapshot's as
    the device chain resizes them: (planes, geometries); each plane
    (H, W) with the shapes' rows and its coded width rounded up to 64
    columns, junk (2^20) in the rows from h and the columns from src_w."""
    import numpy as np

    from dav1d_tpu_torch.decode.frame import superres_geometry

    planes, geoms = [], []
    for make in makes or (_plane,):
        for pl in range(3):
            g = superres_geometry(_sr_frame(denom), pl)
            H = shapes["luma" if pl == 0 else "chroma"][0]
            src_w, h = g[1], g[4]
            px = np.full((H, (src_w + 63) & ~63), 1 << 20, np.int32)
            px[:h, :src_w] = make(rng, h, src_w, bd)
            planes.append(px)
            geoms.append(g)
    return planes, geoms


def _extremes(rng, H, W, bitdepth):
    """8x8 blocks of the pixels {0, 1, 2^bd-2, 2^bd-1}: half near-flat
    (0/1 or 2^bd-2/2^bd-1: the largest box sums with x_by_x near 255,
    the largest self-guided A products), half mixed (the largest
    variance terms p * s)."""
    import numpy as np

    hi = (1 << bitdepth) - 1
    vals = np.array([0, 1, hi - 1, hi], np.int32)
    nby, nbx = -(-H // 8), -(-W // 8)
    mixed = rng.random((nby, nbx)) < 0.5
    base = rng.integers(0, 2, (nby, nbx)) * 2

    def up(a):
        return np.repeat(np.repeat(a, 8, 0), 8, 1)[:H, :W]

    pick = np.where(up(mixed), rng.integers(0, 4, (H, W)),
                    up(base) + rng.integers(0, 2, (H, W)))
    return vals[pick]


# unit widths and stripe heights of the 1080p restoration streams: units
# of 128 or 256 columns (up to 1.5 units at the right edge), stripes of
# 64 rows (56 the first), 32 and 28 in chroma
LR_UW = (128, 192, 256, 384)
LR_SH = (28, 32, 56, 64)
# Wiener units narrower than a 16-byte copy or a 64-column chunk, and
# stripes that are not a multiple of a 16-row band
LR_NARROW = [(uw, sh) for uw in (1, 2, 3, 37, 65) for sh in (4, 13, 28)]


def _lr_jobs(rng, W, h, per, kind, variant=0, sizes=None):
    """A job table (ops/lr.py job_table columns) of ``per`` units of each
    (width, stripe height) of ``sizes`` (default LR_UW x LR_SH), placed
    row by row with 4 pixels around each (so every edge combination reads
    inside the plane), the 16 edge combinations spread over them; every
    second unit's plane height ends just below its bottom context, where
    min(y + sh + 1, h - 1) clamps.  Wiener: half filters in the
    bitstream's ranges; self-guided: the strengths of a sgr_params entry
    of ``variant``, weights in their ranges.  Returns (jobs, rows the
    units take)."""
    import numpy as np

    from dav1d_tpu_torch import tables

    sizes = sizes or [(uw, sh) for uw in LR_UW for sh in LR_SH]
    geo = sizes * per
    rows, x, y, row_h = [], 4, 4, 0
    for i, (uw, sh) in enumerate(geo):
        if x + uw + 4 > W:
            x, y, row_h = 4, y + row_h + 8, 0
        rows.append([x, y, uw, sh, i % 16, y + sh + 1 if i % 2 else h])
        x += uw + 8
        row_h = max(row_h, sh)
    n = len(rows)
    if kind == "w":
        prm = [rng.integers(-5, 11, n), rng.integers(-23, 9, n),
               rng.integers(-17, 47, n), rng.integers(-5, 11, n),
               rng.integers(-23, 9, n), rng.integers(-17, 47, n)]
    else:
        s0, s1 = (int(v) for v in tables.sgr_params[
            {2: 0, 0: 14, 1: 10}[variant]])
        w0 = rng.integers(-96, 32, n)
        prm = [np.full(n, s0), np.full(n, s1), w0,
               128 - (w0 + rng.integers(-32, 96, n)), np.full(n, variant),
               np.zeros(n, np.int64)]
    jobs = np.concatenate([np.asarray(rows), np.stack(prm, 1)], 1)
    return jobs.astype(np.int32), y + row_h + 4



# ---- film grain and intra inputs (K9-K12) --------------------------------

def _fg_data(rng, overlap, csfl, restricted):
    """Random film-grain parameters in the bitstream's ranges (2..14
    luma scaling points, up to 10 per chroma plane, AR lag 3)."""
    from dav1d_tpu_torch.headers import FilmGrainData

    def points(n):
        xs = sorted(rng.choice(256, n, replace=False))
        return [(int(x), int(rng.integers(0, 256))) for x in xs]

    d = FilmGrainData()
    d.seed = int(rng.integers(0, 1 << 16))
    d.num_y_points = int(rng.integers(2, 15))
    d.y_points = points(d.num_y_points)
    d.chroma_scaling_from_luma = csfl
    for uv in range(2):
        n = 0 if csfl else int(rng.integers(1, 11))
        d.num_uv_points[uv], d.uv_points[uv] = n, points(n)
        d.uv_mult[uv] = int(rng.integers(-128, 128))
        d.uv_luma_mult[uv] = int(rng.integers(-128, 128))
        d.uv_offset[uv] = int(rng.integers(-256, 256))
    d.scaling_shift = int(rng.integers(8, 12))
    d.ar_coeff_lag = 3
    d.ar_coeffs_y = [int(v) for v in rng.integers(-40, 40, 24)]
    d.ar_coeffs_uv = [[int(v) for v in rng.integers(-40, 40, 25)]
                      for _ in range(2)]
    d.ar_coeff_shift = int(rng.integers(6, 10))
    d.grain_scale_shift = int(rng.integers(0, 2))
    d.overlap_flag, d.clip_to_restricted_range = overlap, restricted
    return d


# (label, width, height, chroma_scaling_from_luma, overlap, restricted,
# first column of the planes in their allocation: 1, in allocations of
# 1924 / 964 columns (row strides a multiple of 16 bytes), puts no row of
# any plane on a 16-byte boundary, so every group takes the kernel's
# ragged path)
FG_VARIANTS = [("1080p uv_mult overlap", 1920, 1080, 0, 1, 0, 0),
               ("1080p from luma no overlap restricted", 1920, 1080, 1, 0,
                1, 0),
               ("1919x1079 uv_mult overlap restricted", 1919, 1079, 0, 1,
                1, 0),
               ("1919x1079 at column 1 uv_mult overlap", 1919, 1079, 0, 1,
                0, 1)]


def _fg_cases(rng, device, bd, shapes=SHAPES):
    """K9 cases: every plane with grain of pictures of FG_VARIANTS on
    allocation-sized 1080p planes (junk beyond the picture)."""
    import types

    import numpy as np
    import torch

    from dav1d_tpu_torch.headers import PixelLayout
    from dav1d_tpu_torch.ops import fg as ofg
    from dav1d_tpu_torch.recon import filmgrain as rfg

    out = []
    for label, w, h, csfl, overlap, restricted, col in FG_VARIANTS:
        d = _fg_data(rng, overlap, csfl, restricted)
        pic = types.SimpleNamespace(
            frame_hdr=types.SimpleNamespace(
                film_grain=types.SimpleNamespace(data=d)),
            seq_hdr=types.SimpleNamespace(mtrx=1), layout=PixelLayout.I420,
            bitdepth=bd, width=w, height=h)
        # (a row stride 4 columns wider keeps every row off the boundary)
        pad = 4 if col else 0
        planes = [torch.from_numpy(_plane(
            rng, shapes[k][0], shapes[k][1] + pad, bd)).to(device)[
                :, col:col + shapes[k][1]]
            for k in ("luma", "chroma", "chroma")]
        if col % 4:
            _require(all(p.data_ptr() % 16 and p.stride(0) % 4 == 0
                         for p in planes), f"{label}: a row is aligned")
        _, tabs = rfg.grain_tables(pic)
        prm = rfg.plane_params(pic)
        offs = torch.from_numpy(ofg.row_offsets(
            d.seed, overlap, -(-h // 32), -(-w // 32))).to(device)
        for pl, (lut, sc) in tabs.items():
            sx = sy = 1 if pl else 0
            out.append((f"{('Y', 'U', 'V')[pl]} {label} bd{bd}",
                        ofg.apply_plane, ofg.apply_plane_plain,
                        (planes[pl], planes[0],
                         torch.from_numpy(lut).to(device),
                         torch.from_numpy(sc).to(device), offs,
                         (w + sx) >> sx, (h + sy) >> sy, w, prm[pl])))
    return out


# the angles of tests/test_ops_ipred.py:50,58,69 and the angle key's flags
# (bit 9 smooth, bit 10 edge filter)
Z_ANGLES = {6: (3, 23, 45, 64, 87), 7: (93, 113, 135, 157, 177),
            8: (183, 203, 225, 247, 267)}
Z_FLAGS = (0, 512, 1024, 1536)


def _unit_params(w, h):
    """[(mode, angle key, Z2 max_w, Z2 max_h)] of every resolved mode
    (levels.py numbering), angle and flag for a w x h unit."""
    rows = [(m, 0, 0, 0) for m in (0, 1, 2, 3, 4, 5, 9, 10, 11, 12)]
    for mode, angles in Z_ANGLES.items():
        for a in angles:
            for f in Z_FLAGS:
                rows.append((mode, a | f, w, h) if mode == 7 else
                            (mode, a | f, 0, 0))
                if mode == 7:
                    rows.append((mode, a | f, max(4, w // 2),
                                 max(4, h // 2)))
    if w <= 32 and h <= 32:
        rows += [(13, i, 0, 0) for i in range(5)]
    return rows


def _level_units(rng, H, W, ph, sizes):
    """Job rows (ops/ipred.py columns) of one level of units on an
    (H, W) canvas of ph-row planes: random sizes, modes, angles and edge
    availability (have_left / have_top, partial left / top extents,
    bottom-left / top-right spans), in grid rows 4 columns apart, each
    followed by a gap as tall as its tallest unit plus 4, so that no unit
    reads a cell another writes, as in a schedule's level."""
    import numpy as np

    rows, y = [], 4
    while True:
        row, x = [], 4
        while True:
            w, h = sizes[rng.integers(0, len(sizes))]
            if x + w > W - 4:
                break
            row.append((x, w, h))
            x += w + 4 + 4 * int(rng.integers(0, 3))
        hmax = max(h for _, _, h in row)
        half_end = (y // ph + 1) * ph
        if half_end > H:
            break
        if y + 2 * hmax + 4 > half_end:
            y = half_end + 4
            continue
        for x, w, h in row:
            prm = _unit_params(w, h)
            mode, akey, kmw, kmh = prm[rng.integers(0, len(prm))]
            hl, ht = int(rng.integers(0, 2)), int(rng.integers(0, 2))
            pxl = int(rng.integers(1, h + 1)) if hl else 0
            pxt = int(rng.integers(1, w + 1)) if ht else 0
            pxbl = int(rng.integers(0, h + 1)) if pxl == h else 0
            pxtr = int(rng.integers(0, w + 1)) if pxt == w else 0
            rows.append([y, x, w, h, hl, ht, pxl, pxbl, pxt, pxtr, akey, kmw,
                         kmh, int(mode == 7 and rng.integers(0, 2)), mode,
                         0])
        y += 2 * hmax + 4
    return np.asarray(rows, np.int32).reshape(-1, 16)


IP_SIZES = [(4, 4), (8, 4), (4, 8), (8, 8), (16, 8), (8, 16), (16, 16),
            (32, 8), (4, 16), (16, 4), (32, 32), (64, 16), (16, 64),
            (32, 64), (64, 32), (64, 64)]
IP_CHROMA_SIZES = [s for s in IP_SIZES if max(s) <= 32]


def _walk_schedule(rng, H, W, ph, YH, YW, n_levels, sizes, bd, kinds,
                   per=None):
    """A chain's walk table (ops/ipred.walk) of ``n_levels`` levels on an
    (H, W) canvas of ph-row planes: each level a :func:`_level_units`
    layout (``per`` of its units, when given), so that no unit reads a
    cell another unit of its level writes while each level reads what
    the levels below it wrote; each unit of a kind drawn from ``kinds``
    (0 prediction, 1 CFL up to 32x32: a DC variant, an origin in the
    (YH, YW) luma canvas, alpha, padding; 2 palette: colours, an index
    map), sorted by kind within its level.  Returns (jobs, tags, counts,
    index maps)."""
    import numpy as np

    rows, tags, counts, maps, off = [], [], [], [], 0
    for level in range(n_levels):
        J = _level_units(rng, H, W, ph, sizes)
        if per is not None:
            J = J[np.sort(rng.choice(len(J), min(per, len(J)),
                                     replace=False))]
        kind = rng.choice(np.asarray(kinds), len(J))
        kind[(kind == 1) & (np.maximum(J[:, 2], J[:, 3]) > 32)] = 0
        order = np.argsort(kind, kind="stable")
        for r, k in zip(J[order], kind[order]):
            w, h = int(r[2]), int(r[3])
            if k == 1:
                r[14] = rng.choice([0, 3, 4, 5])  # the DC variants
                r[10], r[11] = rng.integers(0, YH), rng.integers(0, YW)
                r[12] = rng.integers(-16, 17)  # alpha
                r[13], r[15] = rng.integers(0, w // 4), rng.integers(0,
                                                                     h // 4)
            elif k == 2:
                r[4], r[8:16] = off, rng.integers(0, 1 << bd, 8)
                maps.append(rng.integers(0, 8, w * h).astype(np.uint8))
                off += w * h
            rows.append(r)
            tags.append(level << 2 | int(k))
        counts.append(len(J))
    return (np.asarray(rows, np.int32).reshape(-1, 16),
            np.asarray(tags, np.int32), np.asarray(counts, np.int32),
            np.concatenate(maps + [np.zeros(1, np.uint8)]))


def _ipred_cases(rng, device, bd, shapes=SHAPES):
    """K10-K12 and walk cases on 1080p-shaped canvases: prediction units
    on the luma canvas and on the stacked chroma pair (every size 4..64,
    mode, angle, edge combination), CFL units on the stacked chroma pair
    with the luma canvas, palette units on the luma canvas; walks of six
    levels mixing prediction and palette units (luma) and all three kinds
    (stacked chroma), and one of 300 levels of 6 units each (luma, the
    handoff between levels over and over); random and extreme pixels.
    Each call works on a copy of the canvas (the kernels write in
    place)."""
    import numpy as np
    import torch

    from dav1d_tpu_torch.ops import ipred as oip

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    (YH, YW), (CH, CW) = shapes["luma"][:2], shapes["chroma"][:2]
    r = 1 << bd
    pred, cfl, pal, walk = [], [], [], []

    def walk_case(label, canvas, luma, resid, ph, ss, sched):
        J, T, C, pidx = sched
        walk.append((f"{label} {len(C)} levels {len(J)} units bd{bd}",
                     lambda c, *a: oip.walk(c.clone(), *a),
                     lambda c, *a: oip.walk_plain(c.clone(), *a),
                     (canvas, luma, resid, dev(J), dev(T), dev(C), dev(pidx),
                      ph, ss, ss, bd)))

    for extremes in (False, True):
        lbl = " extremes" if extremes else ""
        make = _extremes if extremes else (
            lambda g, h_, w_, b: g.integers(0, 1 << b, (h_, w_)).astype(
                np.int32))
        luma = dev(make(rng, YH, YW, bd))
        chroma = dev(make(rng, 2 * CH, CW, bd))
        rl = dev(rng.integers(-r, r, (YH, YW)).astype(np.int32))
        rc = dev(rng.integers(-r, r, (2 * CH, CW)).astype(np.int32))
        for label, canvas, resid, ph, sizes in (
                ("luma", luma, rl, YH, IP_SIZES),
                ("stacked chroma", chroma, rc, CH, IP_CHROMA_SIZES)):
            jobs = _level_units(rng, canvas.shape[0], canvas.shape[1], ph,
                                sizes)
            pred.append((f"{label} {len(jobs)} units{lbl} bd{bd}",
                         lambda c, *a: oip.pred_level(c.clone(), *a),
                         lambda c, *a: oip.pred_level_plain(c.clone(), *a),
                         (canvas, resid, dev(jobs), ph, bd)))
        jobs = _level_units(rng, 2 * CH, CW, CH, IP_CHROMA_SIZES)
        for j in jobs:
            w, h = int(j[2]), int(j[3])
            j[14] = rng.choice([0, 3, 4, 5])  # the DC variants
            j[10] = rng.integers(0, YH - 2 * h + 1)  # luma origin
            j[11] = rng.integers(0, YW - 2 * w + 1)
            j[12] = rng.integers(-16, 17)  # alpha
            j[13], j[15] = rng.integers(0, w // 4), rng.integers(0, h // 4)
        cfl.append((f"stacked chroma {len(jobs)} units{lbl} bd{bd}",
                    lambda c, *a: oip.cfl_level(c.clone(), *a),
                    lambda c, *a: oip.cfl_level_plain(c.clone(), *a),
                    (chroma, luma, rc, dev(jobs), CH, 1, 1, bd)))
        jobs = _level_units(rng, YH, YW, YH, [(8, 8), (16, 16), (32, 32),
                                              (64, 64), (16, 8), (32, 64)])
        maps, off = [], 0
        for j in jobs:
            n = int(j[2] * j[3])
            j[4], j[8:16] = off, rng.integers(0, r, 8)
            maps.append(rng.integers(0, 8, n).astype(np.uint8))
            off += n
        pidx = dev(np.concatenate(maps))
        pal.append((f"luma {len(jobs)} units{lbl} bd{bd}",
                    lambda c, *a: oip.pal_level(c.clone(), *a),
                    lambda c, *a: oip.pal_level_plain(c.clone(), *a),
                    (luma, rl, dev(jobs), pidx, bd)))
        walk_case(f"luma{lbl}", luma, None, rl, YH, 0, _walk_schedule(
            rng, YH, YW, YH, YH, YW, 6, IP_SIZES, bd, (0, 2)))
        walk_case(f"stacked chroma{lbl}", chroma, luma, rc, CH, 1,
                  _walk_schedule(rng, 2 * CH, CW, CH, YH, YW, 6,
                                 IP_CHROMA_SIZES, bd, (0, 1, 2)))
        if not extremes:
            walk_case("luma deep", luma, None, rl, YH, 0, _walk_schedule(
                rng, YH, YW, YH, YH, YW, 300, IP_SIZES, bd, (0, 2), per=6))
    return {"ipred": pred, "ipred_cfl": cfl, "ipred_pal": pal,
            "ipred_walk": walk}

def make_cases(device, shapes=SHAPES, seed=0):
    """Kernel inputs at the main path's shapes for bit depths 8/10/12:
    {kernel: [(label, kernel_fn, plain_fn, args), ...]}."""
    import numpy as np
    import torch

    from dav1d_tpu_torch.ops import cdef as ocdef
    from dav1d_tpu_torch.ops import itx as oitx
    from dav1d_tpu_torch.ops import lf as olf
    from dav1d_tpu_torch.ops import lr as olr
    from dav1d_tpu_torch.ops import mc as omc
    from dav1d_tpu_torch.ops import resize as oresize

    rng = np.random.default_rng(seed)

    def dev(a):
        return torch.from_numpy(a).to(device)

    cases = {k: [] for k in KERNELS}
    for bd in (8, 10, 12):
        dmaps = None
        for plane_kind, (H, W, ph, pw) in shapes.items():
            luma = plane_kind == "luma"
            plane = dev(_plane(rng, H, W, bd))
            vc, hc = (dev(m) for m in _cells(rng, H, W, luma, bd))
            for name, cells, vert in (("deblock_v", vc, True),
                                      ("deblock_h", hc, False)):
                cases[name].append((
                    f"{plane_kind} bd{bd}", olf.deblock, olf.deblock_plain,
                    (plane, cells, vert, bd, luma)))
            if luma:
                cases["cdef_dir"].append((
                    f"{plane_kind} bd{bd}", ocdef.find_dir_maps,
                    ocdef.find_dir_maps_plain, (plane, bd)))
                cases["cdef_dir"].append((
                    f"{plane_kind} ties bd{bd}", ocdef.find_dir_maps,
                    ocdef.find_dir_maps_plain,
                    (dev(_dir_ties(rng, H, W, bd)), bd)))
                dmaps = ocdef.find_dir_maps_plain(plane, bd)
            w = h = 8 if luma else 4
            pm, sm = (dev(m) for m in _units(rng, -(-ph // h), -(-pw // w),
                                              bd))
            damping = 3 + int(rng.integers(0, 4)) + bd - 8 - (not luma)
            for l422 in ((False,) if luma else (False, True)):
                cases["cdef_filter"].append((
                    f"{plane_kind}{' 4:2:2 dirs' if l422 else ''} bd{bd}",
                    ocdef.filter_plane, ocdef.filter_plane_plain,
                    (plane, pm, sm, *dmaps, ph, pw, w, h, damping, bd, luma,
                     l422)))
            strong = [torch.full_like(pm, 15 << (bd - 8)),
                      torch.full_like(sm, 4 << (bd - 8))]
            for top in (False, True):
                cases["cdef_filter"].append((
                    f"{plane_kind} spikes{' at 2^bd-1' if top else ''} "
                    f"bd{bd}", ocdef.filter_plane, ocdef.filter_plane_plain,
                    (dev(_spikes(rng, H, W, bd, top)), *strong, *dmaps, ph,
                     pw, w, h, damping, bd, luma, False)))
        # a 4:2:2 chroma plane (luma rows, chroma columns): 4x8 units,
        # the luma direction maps
        (H, _, ph, _), (_, W, _, pw) = shapes["luma"], shapes["chroma"]
        pm, sm = (dev(m) for m in _units(rng, -(-ph // 8), -(-pw // 4), bd))
        damping = 2 + int(rng.integers(0, 4)) + bd - 8
        for label, plane, maps in (
                ("", _plane(rng, H, W, bd), (pm, sm)),
                (" spikes", _spikes(rng, H, W, bd),
                 (torch.full_like(pm, 15 << (bd - 8)),
                  torch.full_like(sm, 4 << (bd - 8))))):
            cases["cdef_filter"].append((
                f"chroma 4:2:2 4x8 units{label} bd{bd}", ocdef.filter_plane,
                ocdef.filter_plane_plain,
                (dev(plane), *maps, *dmaps, ph, pw, 4, 8, damping, bd,
                 False, True)))
        # K2's band form at the mesh's 1080p band geometry: every band of
        # the 4:2:0 luma and chroma planes and of a 4:2:2-shaped chroma
        # plane, cut into 2, 4 and 8 bands (recon/mesh_cdef.py)
        for kind, (H, W, ph, pw), w, h, l422 in (
                ("luma", shapes["luma"], 8, 8, False),
                ("chroma", shapes["chroma"], 4, 4, False),
                ("chroma 4:2:2", shapes["luma"][:1] + shapes["chroma"][1:2]
                 + shapes["luma"][2:3] + shapes["chroma"][3:], 4, 8, True)):
            luma = kind == "luma"
            plane = dev(_plane(rng, H, W, bd))
            pm, sm = (dev(m) for m in _units(rng, -(-ph // h), -(-pw // w),
                                              bd))
            damping = 3 + int(rng.integers(0, 4)) + bd - 8 - (not luma)
            for n in BAND_CASE_BANDS:
                cases["cdef_filter_band"] += _band_cases(
                    f"{kind} {n} bands", n, plane, pm, sm, dmaps, ph, pw,
                    w, h, damping, bd, luma, l422)
        cases["mc"].append((
            f"3 refs x 3 planes, all sizes bd{bd}", omc.put_8tap_resident,
            omc.put_8tap_resident_plain, _mc_args(rng, device, bd, shapes)))
        cases["mc"].append((
            f"128x128 luma, 4x4 chroma only bd{bd}", omc.put_8tap_resident,
            omc.put_8tap_resident_plain,
            _mc_args(rng, device, bd, shapes, per=24,
                     blocks={"luma": (128, 128), "chroma": (4, 4)})))
        # compound jobs (avg and distance-weighted) among single ones
        cases["mc"].append((
            f"compound, 3 refs x 3 planes, all sizes bd{bd}",
            omc.put_8tap_resident, omc.put_8tap_resident_plain,
            _mc_args(rng, device, bd, shapes, compound=True)))
        cases["mc"].append((
            f"compound 128x128 luma, 4x4 chroma only bd{bd}",
            omc.put_8tap_resident, omc.put_8tap_resident_plain,
            _mc_args(rng, device, bd, shapes, per=24, compound=True,
                     blocks={"luma": (128, 128), "chroma": (4, 4)})))
        cases["itx"].append((
            f"194 pairs x 48 blocks bd{bd}", oitx.itx_frame,
            _itx_plain, _itx_args(rng, device, bd)))
        cases["itx"].append((
            f"194 pairs x 44 sparse bd{bd}", oitx.itx_frame,
            _itx_plain, _itx_sparse_args(rng, device, bd)))
        # super-res: one plane a launch at the stream's denominator (16)
        # and at 9 and 12 (a phase for up to every lane of a warp), on
        # random and extreme pixels; the frame's three planes and its
        # snapshot's in one launch, as the device chain makes it; junk in
        # the rows beyond the frame and the columns beyond the coded width
        for denom, makes in ((16, (_plane, _extremes)), (9, (_plane,)),
                             (12, (_plane,))):
            for make in makes:
                planes, geoms = _sr_planes(rng, shapes, bd, denom, (make,))
                for kind, px, g in (("luma", planes[0], geoms[0]),
                                    ("chroma", planes[1], geoms[1])):
                    cases["resize"].append((
                        f"{kind} {g[1]}->{g[0]} 1/{denom}"
                        f"{' extremes' if make is _extremes else ''} bd{bd}",
                        oresize.resize_plane, oresize.resize_plane_plain,
                        (dev(px), *g, bd)))
        planes, geoms = _sr_planes(rng, shapes, bd, 16, (_plane, _extremes))
        cases["resize"].append((
            f"6 planes (frame and snapshot) 1/16 bd{bd}",
            oresize.resize_planes, oresize.resize_planes_plain,
            ([dev(p) for p in planes], geoms, bd)))
        # restoration: the planes' post-CDEF pixels and snapshot
        for kind in ("luma", "chroma"):
            H, W, h, _ = shapes[kind]
            per = 4 if kind == "luma" else 1
            for label, make in (("", _plane), (" extremes", _extremes)):
                post, pre = (dev(make(rng, H, W, bd)) for _ in range(2))
                # (bands as the wrapper chooses them, and whole stripes)
                for what, sizes, band in (("", None, 0),
                                          (" 64-row bands", None, 64),
                                          (" narrow/short", LR_NARROW, 0)):
                    jobs, used = _lr_jobs(rng, W, h, per, "w", sizes=sizes)
                    _require(used <= H, f"{kind}: units take {used} rows")
                    cases["lr_wiener"].append((
                        f"{kind} {len(jobs)}{what} units{label} bd{bd}",
                        functools.partial(olr.wiener, chunks=dev(
                            olr.chunk_table(jobs, band))), olr.wiener_plain,
                        (post, pre, dev(jobs), bd)))
                # (bands as the wrapper chooses them, and 8-row bands)
                for variant in (0, 1, 2):
                    for what, sizes, band in (("", None, 0),
                                              (" 8-row bands", None, 8),
                                              (" narrow/short", LR_NARROW,
                                               0)):
                        jobs, _ = _lr_jobs(rng, W, h, per, "s", variant,
                                           sizes=sizes)
                        cases["lr_sgr"].append((
                            f"{kind} {len(jobs)}{what} units variant "
                            f"{variant}{label} bd{bd}",
                            functools.partial(olr.sgr, chunks=dev(
                                olr.chunk_table(jobs, band, sgr=True))),
                            olr.sgr_plain, (post, pre, dev(jobs), bd)))
        cases["fg"] += _fg_cases(rng, device, bd, shapes)
        for k, items in _ipred_cases(rng, device, bd, shapes).items():
            cases[k] += items
    return cases


def _max_abs_err(a, b):
    import torch

    if isinstance(a, (tuple, list)):
        _require(len(a) == len(b), f"{len(a)} outputs vs {len(b)}")
        return max(_max_abs_err(x, y) for x, y in zip(a, b))
    _require(a.shape == b.shape and a.dtype == b.dtype,
             f"shape/dtype {tuple(a.shape)} {a.dtype} vs "
             f"{tuple(b.shape)} {b.dtype}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def compare_kernels(cases, sync):
    """Every kernel against its plain version on the same inputs; exact
    agreement required.  Returns {kernel: max_abs_err}."""
    errs = {}
    for name, items in cases.items():
        errs[name] = 0
        for label, kfn, pfn, args in items:
            got = kfn(*args)
            sync()
            want = pfn(*args)
            e = _max_abs_err(got, want)
            print(f"  {name:12s} {label:22s} max_abs_err={e}", flush=True)
            errs[name] = max(errs[name], e)
        _require(errs[name] == 0, f"{name} disagrees with its plain "
                 f"version (max_abs_err {errs[name]})")
    return errs


# ---- decode ------------------------------------------------------------

def mesh_of(device, bands):
    """``bands`` row bands on ``device`` (Settings.mesh), or None for 0."""
    from dav1d_tpu_torch.mesh import Mesh

    return Mesh([device] * bands) if bands else None


def decode(data, device, hashing=True, device_intra=False, bands=0,
           n_threads=0, two_pass=True, container="ivf", check_refs=False):
    """Decode a stream with the port's public API (``bands``: a mesh of
    that many bands on ``device``; ``n_threads``: Settings.n_threads;
    ``two_pass=False``: fused mode; ``container``: ivf, or annexb and
    section5 through containers.open_stream; ``check_refs``: at the end,
    every reference slot's host planes must equal its resident planes);
    returns (frames, md5 over every plane of every picture, inter
    frames)."""
    from dav1d_tpu_torch.containers import open_stream, read_ivf
    from dav1d_tpu_torch.decoder import Decoder, Settings

    dec = Decoder(Settings(two_pass=two_pass, max_frame_delay=4,
                           mesh=mesh_of(device, bands), n_threads=n_threads),
                  device=device, device_intra=device_intra)
    h = hashlib.md5()
    n = n_inter = 0
    units = read_ivf(data) if container == "ivf" else open_stream(data)
    for tu, _ in units:
        dec.send_data(tu)
        while (pic := dec.get_picture()) is not None:
            if hashing:
                for pl in range(len(pic.planes)):
                    h.update(pic.plane_bytes(pl))
            n += 1
            n_inter += bool(pic.frame_hdr.frame_type.is_inter_or_switch)
    if check_refs:
        check_ref_slots(dec)
    dec.close()
    return n, h.hexdigest(), n_inter


def check_ref_slots(dec):
    """Every reference slot's host planes (what the next frame's fused
    pass 1 and the host replay read) equal its resident device planes
    (what the device MC and film grain read)."""
    import torch

    seen = set()
    for i, slot in enumerate(dec.refs):
        if slot.dev_planes is None or id(slot) in seen:
            continue
        seen.add(id(slot))
        _require(len(slot.dev_planes) == len(slot.planes), f"ref slot {i}: "
                 f"{len(slot.dev_planes)} device planes for "
                 f"{len(slot.planes)} host planes")
        for pl, (host, dev) in enumerate(zip(slot.planes, slot.dev_planes)):
            h, w = host.shape
            _require(dev.shape[0] >= h and dev.shape[1] >= w,
                     f"ref slot {i} plane {pl}: device plane "
                     f"{tuple(dev.shape)} smaller than the host plane "
                     f"{host.shape}")
            got = dev[:h, :w].cpu().to(torch.int64)
            ref = torch.from_numpy(host).to(torch.int64)
            if not torch.equal(got, ref):
                y, x = (got != ref).nonzero()[0].tolist()
                raise SmokeError(f"ref slot {i} plane {pl}: device plane "
                                 f"differs from the host plane first at "
                                 f"(y, x) = ({y}, {x}): {int(got[y, x])} "
                                 f"against {int(ref[y, x])}")


def decode_checked(name, device, device_intra=False, bands=0,
                   n_threads=0):
    """Decode a committed stream, check its md5; returns (frames, inter
    frames)."""
    want = json.loads((DATA / "md5.json").read_text())[name]
    n, md5, n_inter = decode((DATA / name).read_bytes(), device,
                             device_intra=device_intra, bands=bands,
                             n_threads=n_threads)
    how = (" device_intra" if device_intra else "") + \
        (f" mesh of {bands} bands" if bands else "") + \
        (f" n_threads={n_threads}" if n_threads else "")
    print(f"  {name}{how}: {n} frames ({n_inter} inter) md5 {md5} (want "
          f"{want['md5']})", flush=True)
    _require((n, md5) == (want["frames"], want["md5"]),
             f"{name}: decoded {n} frames md5 {md5}, want "
             f"{want['frames']} frames md5 {want['md5']}")
    return n, n_inter


# ---- timing ------------------------------------------------------------

def cuda_ms(fn, reps=20):
    """ms per call of ``fn`` over ``reps`` calls after a warm-up call
    (fewer calls for a function slower than 10 ms: at least 0.2 s of
    timed calls)."""
    import torch

    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    reps = max(1, min(reps, int(0.2 / max(time.perf_counter() - t, 1e-9))))
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def launch_ms(kfn, args, reps=20):
    """Device ms per launch of the C entry point that ``kfn(*args)``
    calls: one wrapper call captures the launch (``devrt.CAPTURE``),
    then ``reps`` bare calls of the C entry point with those arguments
    run back to back behind a spin kernel (:func:`replay_ms`).  Returns
    (ms, host ms of queueing the ``reps`` calls)."""
    from dav1d_tpu_torch import devrt

    devrt.CAPTURE = []
    try:
        result = kfn(*args)  # noqa: F841 (its output buffer stays alive)
        captured = devrt.CAPTURE
    finally:
        devrt.CAPTURE = None
    _require(len(captured) == 1, f"{len(captured)} launches captured")
    return replay_ms(captured, reps)


def tile_list_host_ms(mc_calls, n_frames, reps=20):
    """Host ms per decoded frame (``n_frames``, the unit of the stage
    spans) that the MC tile list adds to the ``pass2.mc.launch`` span,
    on the decode's own job lists (each the median of ``reps``): building
    it (``ops.mc.tile_list``), and uploading the jobs
    and tiles in one copy as the pipeline does, against the jobs alone
    (each upload followed by a synchronize)."""
    import numpy as np
    import torch

    from dav1d_tpu_torch import devrt
    from dav1d_tpu_torch.ops import mc as omc

    def median_ms(fn):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts)) * 1e3

    def up(a, dev):
        devrt.upload(a, dev)
        torch.cuda.synchronize()

    out = {"tile_list": 0.0, "upload_jobs_and_tiles": 0.0,
           "upload_jobs": 0.0}
    for args in mc_calls:
        jobs, dev = args[2].cpu().numpy(), args[2].device
        w, h = jobs[:, omc.J_W], jobs[:, omc.J_H]
        tiles = omc.tile_list(w, h)
        both = np.concatenate([jobs.ravel(), tiles.ravel()])
        out["tile_list"] += median_ms(lambda: omc.tile_list(w, h))
        out["upload_jobs_and_tiles"] += median_ms(lambda: up(both, dev))
        out["upload_jobs"] += median_ms(lambda: up(jobs, dev))
    out = {k: v / n_frames for k, v in out.items()}
    out["added"] = (out["tile_list"] + out["upload_jobs_and_tiles"]
                    - out["upload_jobs"])
    return out


def time_kernels(timed):
    """ms per call of each kernel and its plain version on the inputs of
    ``timed`` {name: (label, kernel_fn, plain_fn, args)}, in turns
    plain, kernel, kernel, plain (best of two each)."""
    out = {}
    for name, (label, kfn, pfn, args) in timed.items():
        times = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            fn = kfn if which == "kernel" else pfn
            times[which].append(cuda_ms(lambda: fn(*args)))
        out[name] = (min(times["kernel"]), min(times["plain"]), label)
    return out


# ---- bounds ------------------------------------------------------------

def _kernel_of(tag, args):
    """KERNELS name of a ``devrt.call`` record (the deblock wrapper is one
    call for both directions)."""
    if tag == "deblock":
        return "deblock_v" if args[2] else "deblock_h"
    return tag

def _mc_footprint(coded, jobs):
    """Distinct reference pixels the jobs' clamped windows read (a
    clamped window is a rectangle of its plane): 2-D difference array of
    the rectangles, integrated, counted where covered."""
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


class _Ops:
    """A lane that counts the operations done on it: the port's 1-D
    transforms (recon/itx.py) are polymorphic over the lane container."""

    n = 0

    def _op(self, *_):
        _Ops.n += 1
        return self

    __add__ = __radd__ = __sub__ = __rsub__ = __mul__ = __rmul__ = _op
    __rshift__ = __neg__ = _op


def _clip2(v):
    _Ops.n += 2  # a min and a max
    return v


def _itx_1d_ops(lsz, kind):
    """Operations of one 1-D transform of length 4 << lsz (clips count
    2)."""
    from dav1d_tpu_torch.recon.itx import _1D_FNS, wht4

    lanes = [_Ops() for _ in range(4 << lsz)]
    _Ops.n = 0
    if kind == "wht":
        wht4(lanes, 0, 1)
    else:
        _1D_FNS[(lsz, kind)](lanes, 0, 1, _clip2)
    return _Ops.n


def _itx_ops(tx, txtp, rows):
    """Operations of one 2-D transform whose first ``rows`` rows hold a
    nonzero coefficient (an all-zero row transforms to zero, so its row
    transform is not work the data needs): the rect2 pre-scale (3 per
    coefficient), the row transforms, the rounding shift and column clip
    (4 per row element), the column transforms and the final (v+8)>>4
    (2 per residual); WHT_WHT: cf>>2, four row and four column wht4."""
    from dav1d_tpu_torch.levels import TxfmType
    from dav1d_tpu_torch.ops.itx import _txinfo
    from dav1d_tpu_torch.recon.itx import TX1D_TYPES

    w, h, lw, lh = _txinfo(tx)
    if txtp == TxfmType.WHT_WHT:
        return 16 + 8 * _itx_1d_ops(0, "wht")
    row_t, col_t = TX1D_TYPES[TxfmType(txtp)]
    rect2 = 3 * min(w, 32) * min(h, 32) if abs(lw - lh) == 1 else 0
    return (rect2 + rows * (_itx_1d_ops(lw, row_t) + 4 * w)
            + w * _itx_1d_ops(lh, col_t) + 2 * h * w)


def _itx_work(cf, jobs, groups, n_out, bitdepth):
    """(bytes, operations) of an itx call: the coefficients of every job
    read, the job rows read, the residuals written (the groups are the
    kernel's schedule, not the function's input); the operations of
    :func:`_itx_ops` for each job's rows with a nonzero coefficient."""
    import functools

    import torch

    from dav1d_tpu_torch.ops.itx import _txinfo

    ops_of = functools.lru_cache(maxsize=None)(_itx_ops)
    j = jobs.long()
    n_coef = ops = 0
    for tx in torch.unique(j[:, 1]).tolist():
        g = j[j[:, 1] == tx]
        w, h, _, _ = _txinfo(tx)
        sw, sh = min(w, 32), min(h, 32)
        n_coef += len(g) * sw * sh
        coef = cf[g[:, 0, None] + torch.arange(sw * sh, device=cf.device)]
        rows = (coef.reshape(len(g), sw, sh) != 0).any(1).sum(1)
        pairs = torch.stack([g[:, 2], rows], 1)
        uniq, cnt = torch.unique(pairs, dim=0, return_counts=True)
        for (txtp, r), c in zip(uniq.tolist(), cnt.tolist()):
            ops += c * ops_of(tx, txtp, r)
    nbytes = (4 * n_coef + jobs.numel() * 4
              + n_out * (2 if bitdepth <= 10 else 4))
    return nbytes, ops


def work(name, args):
    """(bytes, 32-bit operations) that the function needs on ``args``:
    each input byte read once and each output byte written once, and
    the operations of the plain algorithm counted from below."""
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
        plane, pm, sm, dmap, vmap = args[:5]
        w, h, luma = args[7], args[8], args[11]
        # the band form reads its halo rows and writes its rows alone
        halo = sum(args[13:15]) * plane.shape[1]
        # the map words of the units the grids hold (a direction per
        # unit, and a variance in luma), not the maps' whole extent
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
        # jobs; writes: the predicted pixels (the tiles are the kernel's
        # schedule, not the function's input)
        nbytes = (4 * _mc_footprint(coded, jobs) + jobs.numel() * 4
                  + n_pix * (1 if bitdepth == 8 else 2))
        # separable 8-tap: (h+7)*w horizontal and h*w vertical sums of
        # 8 products (15 operations), each rounded (2) and clipped (2)
        ops = int(((h + 7) * w * 17 + h * w * 19).sum())
        return nbytes, ops
    if name == "itx":
        return _itx_work(*args)
    if name == "resize":
        # one plane (resize_plane's arguments) or a batch (resize_planes'):
        # reads: each source rectangle; writes: each whole output plane;
        # per resampled pixel 8 multiply-adds (16), the rounding shift and
        # the clip (3)
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
        # reads: the plane, for chroma the luma rows under it (every
        # (1 << ss_y)-th row, 2w wide with ss_x), the tables; writes: the
        # plane.  Per pixel: the grain offset and LUT address (4), the
        # apply (multiply, round, shift, add, clip: 6); chroma adds the
        # luma average (3) and, without chroma-from-luma, the combine
        # and its clip (6)
        luma = h * (w << p.ss_x) if p.pl else 0
        nbytes = 4 * (2 * pix + luma + lut.numel() + sc.numel()
                      + offs.numel())
        ops = pix * (10 + (3 + 6 * (not p.csfl) if p.pl else 0))
        return nbytes, ops
    if name in INTRA_KERNELS:
        return _ipred_work(name, args)
    raise KeyError(name)


def _units_work(kind, jobs, ss_hor=0, ss_ver=0):
    """(bytes, operations) of units of one kind, counted from below: per
    unit its job row, its edge reads (2w + 2h + 1 canvas pixels; none for
    palette), its residual window and output window (for CFL the luma
    pixels under it, for palette its index map); per pixel the
    prediction's one blend (2), the residual add (1) and the clip (2)."""
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
    """(bytes, operations) of one intra launch: a level of one kind
    (K10-K12), or a walk (its units of each kind, its tags and level
    counts)."""
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
    """(bytes, operations) of a restoration launch, counted from below:
    reads the units' pixels and their snapshot context rows (2 above with
    a top edge, 2 below with a bottom edge), writes the units' pixels,
    reads the job rows.  Wiener: a 7-tap horizontal sum (13 operations)
    and its rounding and clip (4) per pixel of the (sh + 6)-row
    intermediate, the same vertically per output pixel.  Self-guided,
    per radius used: the horizontal box sums and square sums (7 / 13 per
    element of (sh + 6) x (uw + 2)), the vertical sums (4 / 8) and the
    (A, B) derivation (15) per (A, B) position (every row of sh + 2 for
    the 3x3, odd rows for the 5x5), the weighted neighbourhood of A and
    B and the correction (24 / 20 per output pixel); the blend and clip
    (7 per output pixel)."""
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


def bound(name, args):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the operation rate."""
    nbytes, ops = work(name, args)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def itx_call_stats(args):
    """What an itx call holds: jobs by tx size (w x h), nonzero
    coefficients of all, and the mean count of coded rows with a nonzero
    coefficient (the rows the kernel transforms) per job of each size."""
    import torch

    from dav1d_tpu_torch.ops.itx import _txinfo

    cf, jobs = args[0], args[1].long()
    by_size, rows, nz, n = {}, {}, 0, 0
    for tx in torch.unique(jobs[:, 1]).tolist():
        g = jobs[jobs[:, 1] == tx]
        w, h, _, _ = _txinfo(tx)
        sw, sh = min(w, 32), min(h, 32)
        coef = cf[g[:, 0, None] + torch.arange(sw * sh, device=cf.device)]
        coef = coef.reshape(len(g), sw, sh) != 0
        key = f"{w}x{h}"
        by_size[key] = len(g)
        rows[key] = round(float(coef.any(1).sum(1).float().mean()), 2)
        nz += int(coef.sum())
        n += coef.numel()
    return {"jobs_by_size": by_size, "nonzero_coefs": nz, "coefs": n,
            "mean_nonzero_rows": rows}


def itx_occupancy():
    """Registers, static shared memory and resident CTAs per SM of the
    itx kernel at 8/10-bit and at 12-bit (cudaFuncGetAttributes,
    cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    import ctypes

    from dav1d_tpu_torch.kernels import build

    v = (ctypes.c_int * 6)()
    rc = build.lib().dtpu_itx_occupancy(v)
    _require(rc == 0, f"dtpu_itx_occupancy: {build.error_string(rc)}")
    return {bd: {"registers": v[i], "shared_bytes": v[i + 1],
                 "ctas_per_sm": v[i + 2]}
            for bd, i in (("8/10-bit", 0), ("12-bit", 3))}


def restore_grain_attrs():
    """Registers and shared bytes of the fg (luma and chroma), lr_wiener,
    lr_sgr and resize kernels (cudaFuncGetAttributes: static shared
    memory, for resize plus its dynamic shared memory and its resident
    CTAs per SM): {name: {...}}."""
    import ctypes

    from dav1d_tpu_torch.kernels import build

    lib = build.lib()
    f, w, r = (ctypes.c_int * 4)(), (ctypes.c_int * 4)(), (ctypes.c_int * 3)()
    for fn, v in ((lib.dtpu_fg_attrs, f), (lib.dtpu_lr_attrs, w),
                  (lib.dtpu_resize_attrs, r)):
        rc = fn(v)
        _require(rc == 0, f"kernel attributes: {build.error_string(rc)}")
    luma = {"registers": f[0], "shared_bytes": f[1]}
    chroma = {"registers": f[2], "shared_bytes": f[3]}
    return {"fg": {"registers": max(f[0], f[2]), "shared_bytes": f[1],
                   "luma": luma, "chroma": chroma},
            "lr_wiener": {"registers": w[0], "shared_bytes": w[1]},
            "lr_sgr": {"registers": w[2], "shared_bytes": w[3]},
            "resize": {"registers": r[0], "shared_bytes": r[1],
                       "ctas_per_sm": r[2]}}


class ChainLog:
    """Frame by frame, what the device filter chain did during a decode:
    a context that wraps recon/device_chain.filter_chain_device (frames
    finish one after the other: Settings.n_threads is 0) and records for
    each frame whether it uses super-res and loop restoration, the
    kernel launches and restoration units it added (devrt.LAUNCHES,
    devrt.COUNTS), the stage spans it entered and the bytes of each
    plane upload (state.upload_planes) it made."""

    def __enter__(self):
        from dav1d_tpu_torch import devrt, state
        from dav1d_tpu_torch.recon import device_chain

        self.frames = []
        self._saved = (device_chain.filter_chain_device, devrt.span,
                       state.upload_planes)
        chain, span, upload = self._saved
        cur = {}

        def logged_chain(f, device):
            l0 = collections.Counter(devrt.LAUNCHES)
            c0 = collections.Counter(devrt.COUNTS)
            cur.update(spans=[], uploads=[])
            chain(f, device)
            hdr = f.frame_hdr
            self.frames.append({
                "resize": hdr.width[0] != hdr.width[1],
                "lossless": bool(hdr.all_lossless),
                "lr": bool(f.restore_planes and (f.inloop_filters & 4)),
                "launches": dict(devrt.LAUNCHES - l0),
                "units": dict(devrt.COUNTS - c0), **cur})
            cur.clear()

        def logged_span(tag):
            if "spans" in cur:
                cur["spans"].append(tag)
            return span(tag)

        def logged_upload(planes, bitdepth, device):
            out = upload(planes, bitdepth, device)
            if "uploads" in cur:
                cur["uploads"].append(sum(t.numel() for t in out)
                                      * (1 if bitdepth == 8 else 2))
            return out

        device_chain.filter_chain_device = logged_chain
        devrt.span, state.upload_planes = logged_span, logged_upload
        return self

    def __exit__(self, *exc):
        from dav1d_tpu_torch import devrt, state
        from dav1d_tpu_torch.recon import device_chain

        (device_chain.filter_chain_device, devrt.span,
         state.upload_planes) = self._saved
        return False


class FrameLog:
    """Frame by frame, what film grain and the device intra stage did
    during a decode: wraps recon/filmgrain.apply_grain (the planes that
    get grain, the fg launches and transfer bytes it added),
    recon/device_intra.intra_frame_device (whether the frame ran on the
    device, the intra launches and the schedule's counts it added, and,
    when devrt.CAPTURE is on, the slice of captured launches it made) and
    ops/ipred.walk (each walk's chain, 0 luma or 1 the stacked chroma
    pair, and units; with ``keep_walks``, copies of its input canvas and
    luma canvas, its other arguments and a copy of its output)."""

    def __init__(self, keep_walks=False):
        self.keep_walks = keep_walks

    def __enter__(self):
        from dav1d_tpu_torch import devrt
        from dav1d_tpu_torch.ops import ipred as oip
        from dav1d_tpu_torch.recon import device_intra, filmgrain

        self.grain, self.intra = [], []
        self._saved = (filmgrain.apply_grain,
                       device_intra.intra_frame_device, oip.walk)
        grain, intra, walk = self._saved
        walks = []

        def logged_grain(pic, device, dev_planes=None):
            planes = len(filmgrain.grain_tables(pic)[1])
            l0, x0 = devrt.LAUNCHES["fg"], dict(devrt.XFER or {})
            grain(pic, device, dev_planes)
            self.grain.append({
                "planes": planes, "fg": devrt.LAUNCHES["fg"] - l0,
                "resident": dev_planes is not None,
                "bytes": {k: v - x0.get(k, 0)
                          for k, v in (devrt.XFER or {}).items()}})

        def logged_intra(f, st):
            l0 = collections.Counter(devrt.LAUNCHES)
            c0 = collections.Counter(devrt.COUNTS)
            k0 = len(devrt.CAPTURE or ())
            walks.clear()
            ok = intra(f, st)
            self.intra.append({
                "device": ok, "captured": (k0, len(devrt.CAPTURE or ())),
                "launches": {k: devrt.LAUNCHES[k] - l0[k]
                             for k in INTRA_KERNELS},
                "counts": dict(devrt.COUNTS - c0), "walks": list(walks)})
            return ok

        def logged_walk(canvas, luma, resid, jobs, tags, counts, pidx,
                        *rest, **kw):
            rec = {"chain": int(luma is not None
                                and luma.data_ptr() != canvas.data_ptr()),
                   "units": int(jobs.shape[0])}
            if self.keep_walks:
                rec["args"] = (canvas.clone(), (canvas if luma is None
                                                else luma).clone(), resid,
                               jobs, tags, counts,
                               None if pidx is None else pidx.clone(), *rest)
                rec["kw"] = kw
            out = walk(canvas, luma, resid, jobs, tags, counts, pidx, *rest,
                       **kw)
            if self.keep_walks:
                rec["out"] = out.clone()
            walks.append(rec)
            return out

        filmgrain.apply_grain = logged_grain
        device_intra.intra_frame_device = logged_intra
        oip.walk = logged_walk
        return self

    def __exit__(self, *exc):
        from dav1d_tpu_torch.ops import ipred as oip
        from dav1d_tpu_torch.recon import device_intra, filmgrain

        (filmgrain.apply_grain, device_intra.intra_frame_device,
         oip.walk) = self._saved
        return False


def replay_ms(captured, reps=1):
    """Device ms of one pass over the captured launches (devrt.CAPTURE
    entries) run again back to back (``devrt.replay_ms``), and the host
    ms of queueing them; a failure is the run's."""
    from dav1d_tpu_torch import devrt

    try:
        return devrt.replay_ms(captured, reps)
    except RuntimeError as e:
        raise SmokeError(str(e)) from e


def check_grain_frames(name, frames, n):
    """One fg launch per plane with grain, on every picture."""
    _require(len(frames) == n, f"{name}: grain ran on {len(frames)} of "
             f"{n} pictures")
    for i, fr in enumerate(frames):
        _require(fr["planes"] > 0 and fr["fg"] == fr["planes"],
                 f"{name} picture {i}: {fr['fg']} fg launches for "
                 f"{fr['planes']} planes with grain")


def check_intra_frames(name, frames):
    """Per frame of a device_intra decode: on a frame the device stage
    took, one ipred_walk launch per chain holding units (luma, the
    stacked chroma pair: each at most once, none without units), as many
    as the stage counted, and no launch of a per-level kernel; on a frame
    it handed to the host walk, none.  Returns (launches per kernel, host
    frames)."""
    total = collections.Counter()
    host = 0
    for i, fr in enumerate(frames):
        k, c, walks = fr["launches"], fr["counts"], fr["walks"]
        if not fr["device"]:
            host += 1
            _require(not any(k.values()) and not walks, f"{name} frame "
                     f"{i}: host-walk frame with intra launches {k}")
            continue
        _require(not any(k[t] for t in LEVEL_KERNELS), f"{name} frame {i}: "
                 f"per-level launches {k}")
        chains = [w["chain"] for w in walks]
        units = sum(c.get(f"intra_{kind}_units", 0)
                    for kind in ("pred", "cfl", "pal"))
        _require(k["ipred_walk"] == len(walks) == len(set(chains))
                 == c.get("intra_walk_launches", 0) <= 2
                 and all(w["units"] > 0 for w in walks)
                 and sum(w["units"] for w in walks) == units,
                 f"{name} frame {i}: {k['ipred_walk']} ipred_walk launches "
                 f"for the walks (chain, units) "
                 f"{[(w['chain'], w['units']) for w in walks]}, {units} "
                 f"units, counts {c}")
        total.update(k)
    return dict(total), host


def key_frame_walks(walks, reps=20):
    """The walks of one frame (FrameLog records with ``keep_walks``):
    each run ``reps`` times from a copy of its input canvas, every result
    bitwise equal to the first, to the decode's own output and to the
    frame's levels replayed through the per-level kernels (K10-K12) from
    the same canvas.  Times (CUDA events): the replay's launches as the
    Python loop issues them, and again back to back behind a spin kernel
    (device time); the walk's wrapper, and its bare launch behind a spin
    kernel (device time).  Returns one dict a walk."""
    import numpy as np
    import torch

    from dav1d_tpu_torch import devrt
    from dav1d_tpu_torch.ops import ipred as oip

    out = []
    for w in walks:
        before, luma, resid, jobs, tags, counts, pidx, ph, ssh, ssv, bd = \
            w["args"]
        first = None
        for _ in range(reps):
            c = before.clone()
            oip.walk(c, luma, resid, jobs, tags, counts, pidx, ph, ssh, ssv,
                     bd, **w["kw"])
            torch.cuda.synchronize()
            if first is None:
                first = c
            _require(torch.equal(c, first), f"chain {w['chain']}: a repeated "
                     "walk differs from the first")
        _require(torch.equal(first, w["out"]), f"chain {w['chain']}: the "
                 "walk differs from the decode's")
        T = tags.cpu().numpy()
        ends = np.cumsum(counts.cpu().numpy())
        c = before.clone()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        devrt.CAPTURE = []
        try:
            torch.cuda.synchronize()
            e0.record()
            for a, b in zip(np.concatenate([[0], ends[:-1]]), ends):
                for kind in range(3):
                    sel = np.flatnonzero((T[a:b] & 3) == kind)
                    if not len(sel):
                        continue
                    J = jobs[a + int(sel[0]):a + int(sel[-1]) + 1]
                    if kind == 0:
                        oip.pred_level(c, resid, J, ph, bd)
                    elif kind == 1:
                        oip.cfl_level(c, luma, resid, J, ph, ssh, ssv, bd)
                    else:
                        oip.pal_level(c, resid, J, pidx, bd)
            e1.record()
            captured = devrt.CAPTURE
        finally:
            devrt.CAPTURE = None
        torch.cuda.synchronize()
        _require(torch.equal(c, first), f"chain {w['chain']}: the walk "
                 "differs from its levels through the per-level kernels")
        levels_ms = e0.elapsed_time(e1)
        levels_dev_ms, queue_ms = replay_ms(captured)
        scratch = before.clone()
        args = (scratch, luma, resid, jobs, tags, counts, pidx, ph, ssh, ssv,
                bd)
        kfn = functools.partial(oip.walk, **w["kw"])
        walk_ms = min(cuda_ms(lambda: kfn(*args)) for _ in range(2))
        walk_dev_ms, _ = launch_ms(kfn, args)
        out.append({"chain": w["chain"], "levels": len(ends),
                    "units": int(ends[-1]), "repeats": reps,
                    "level_launches": len(captured),
                    "levels_ms": levels_ms, "levels_device_ms": levels_dev_ms,
                    "levels_host_queue_ms": queue_ms, "walk_ms": walk_ms,
                    "walk_device_ms": walk_dev_ms})
    return out


def walk_floor_ms(device, levels=4096):
    """Device ms a level of a walk of ``levels`` levels of one unit each,
    a 4x4 palette unit (one phase) or a 4x4 DC_128 prediction unit
    (gather, prep, output), every level on the canvas's same cells: one
    handoff through L2 plus the smallest unit, the least a dependent
    level can cost.  Bare launches behind a spin kernel (launch_ms)."""
    import numpy as np
    import torch

    from dav1d_tpu_torch.ops import ipred as oip

    out = {}
    canvas = torch.zeros((64, 64), dtype=torch.int32, device=device)
    resid = torch.zeros_like(canvas)
    for name, kind, row in (
            ("pal", 2, [4, 4, 4, 4, 0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8]),
            ("pred", 0, [4, 4, 4, 4, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 5, 0])):
        J = np.tile(np.asarray(row, np.int32), (levels, 1))
        T = (np.arange(levels, dtype=np.int32) << 2) | kind
        C = np.ones(levels, np.int32)
        pidx = torch.zeros(16, dtype=torch.uint8, device=device)
        args = (canvas, None, resid, *(torch.from_numpy(a).to(device)
                                       for a in (J, T, C)),
                pidx, 64, 0, 0, 8)
        kfn = functools.partial(oip.walk, max_ctas=oip.walk_ctas(C))
        ms, _ = launch_ms(kfn, args, reps=5)
        out[name] = ms / levels
    return out


def check_lr_frames(name, frames, n):
    """The restoration streams' frame-by-frame launch checks (phase 4)."""
    _require(len(frames) == n, f"{name}: {len(frames)} chain runs for "
             f"{n} frames")
    for i, fr in enumerate(frames):
        k, u = fr["launches"], fr["units"]
        # one launch for the frame's planes and the snapshot's
        _require(k.get("resize", 0) == int(fr["resize"]), f"{name} frame "
                 f"{i}: super-res {fr['resize']} with {k.get('resize', 0)} "
                 f"resize launches, want one a super-res frame: {k}")
        if u.get("lr_wiener_units"):
            _require(k.get("lr_wiener", 0) >= 1, f"{name} frame {i}: "
                     f"Wiener units without a lr_wiener launch: {k}")
        if u.get("lr_sgr_units"):
            _require(k.get("lr_sgr", 0) >= 1, f"{name} frame {i}: "
                     f"self-guided units without a lr_sgr launch: {k}")
        if fr["resize"] or fr["lr"]:
            _require("chain.upload_final" not in fr["spans"] and
                     len(fr["uploads"]) == 1, f"{name} frame {i}: the "
                     f"final planes went up again: spans {fr['spans']}, "
                     f"plane uploads {fr['uploads']}")


def check_band_launches(where, fr, bands, live):
    """One frame of a mesh decode (a ChainLog record): each band kernel
    launched once per band or share that the mesh counted for it, the
    direction search on every band with luma rows (``live`` of them) or
    on none, the restoration kernels once per share holding their units,
    every share of a plane holding some, resize once on a super-res
    frame.  Returns the frame's launch counts by kind of band work."""
    k, u = fr["launches"], fr["units"]
    got = {}
    for d in ("v", "h"):
        got[d], want = k.get(f"deblock_{d}", 0), \
            u.get(f"mesh_deblock_{d}_bands", 0)
        _require(got[d] == want, f"{where}: {got[d]} deblock_{d} launches "
                 f"for {want} bands with edges")
    n_dir, want = k.get("cdef_dir", 0), u.get("mesh_cdef_dir_bands", 0)
    _require(n_dir == want in (0, live), f"{where}: {n_dir} cdef_dir "
             f"launches, {want} bands searched, {live} luma bands")
    got["cdef"] = k.get("cdef_filter", 0) + k.get("cdef_filter_band", 0)
    want = u.get("mesh_cdef_bands", 0)
    _require(got["cdef"] == want, f"{where}: {got['cdef']} CDEF filter "
             f"launches for {want} bands and planes with units")
    for kind in ("wiener", "sgr"):
        n_lr = k.get(f"lr_{kind}", 0)
        want = u.get(f"mesh_lr_{kind}_shares", 0)
        units = u.get(f"lr_{kind}_units", 0)
        _require(n_lr == want >= min(units, bands), f"{where}: {n_lr} "
                 f"lr_{kind} launches for {want} shares holding {units} "
                 "units")
    _require(k.get("resize", 0) == int(fr["resize"]), f"{where}: super-res "
             f"{fr['resize']} with {k.get('resize', 0)} resize launches")
    return got


def check_mesh_frames(name, frames, n, bands, ph, bh):
    """A mesh decode's frame-by-frame launch checks (phase 4): per frame,
    :func:`check_band_launches`, with K1 on every band with filtered luma
    rows and K2 on at least one band (these streams deblock and
    CDEF-filter every frame).  ``ph``: the luma plane's rows, ``bh``: its
    bands' rows.  Returns the halo bytes of each frame."""
    _require(len(frames) == n, f"{name}: {len(frames)} chain runs for "
             f"{n} frames")
    live = -(-ph // bh)
    halo = []
    for i, fr in enumerate(frames):
        where = f"{name} mesh of {bands} frame {i}"
        got = check_band_launches(where, fr, bands, live)
        _require(min(got["v"], got["h"]) >= live and got["cdef"] >= 1,
                 f"{where}: deblock launches {got['v']} / {got['h']} for "
                 f"{live} bands with luma rows, {got['cdef']} CDEF filter "
                 "launches")
        halo.append(fr["units"].get("halo_bytes", 0))
    return halo


# the CLI in a subprocess, its launch counts printed at its end
_CLI_RUN = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from dav1d_tpu_torch import cli, devrt
devrt.LAUNCHES.clear()
rc = cli.main(sys.argv[2:])
print("launches " + json.dumps(dict(devrt.LAUNCHES)), file=sys.stderr)
sys.exit(rc)
"""


def _cli(*args, timeout=300):
    """``python -m dav1d_tpu_torch.cli`` in a subprocess on its default
    device, the card: (exit code, stderr, launches)."""
    r = subprocess.run([sys.executable, "-c", _CLI_RUN, str(ROOT),
                        *map(str, args)], capture_output=True, text=True,
                       cwd=ROOT, timeout=timeout)
    launches = {}
    for line in r.stderr.splitlines():
        if line.startswith("launches "):
            launches = json.loads(line[len("launches "):])
    return r.returncode, r.stderr, launches


def _stitched(parts):
    h = hashlib.md5()
    for _, path in parts:
        h.update(Path(path).read_bytes())
    return sum(c for c, _ in parts), h.hexdigest()


def entry_points(device, card) -> dict:
    """Phase 6: the port's entry points on the card (module docstring)."""
    import re
    import tempfile

    import torch

    from dav1d_tpu_torch import devrt, entry, gop, scaling

    md5s = json.loads((DATA / "md5.json").read_text())
    main = md5s[MAIN_STREAM]
    report = {}
    work = ROOT / "dav1d_tpu_torch" / "_build"
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        tmp = Path(tmp)
        # the CLI: md5 muxer with --verify of the JAX CLI's digest, and a
        # wrong digest
        t0 = time.perf_counter()
        rc, err, launches = _cli("-i", DATA / MAIN_STREAM, "--muxer", "md5",
                                 "-o", tmp / "out.md5", "--verify",
                                 main["cli_md5"])
        wall = time.perf_counter() - t0
        print(f"  cli --muxer md5 --verify: exit {rc}; "
              f"{err.strip().splitlines()[-3:]}", flush=True)
        _require(rc == 0 and "verify OK" in err,
                 f"cli: exit {rc}, stderr {err[-2000:]}")
        got = (tmp / "out.md5").read_text().split()[0]
        _require(got == main["cli_md5"], f"cli md5 {got}, want "
                 f"{main['cli_md5']} (the JAX CLI's)")
        m = re.search(r"decoded (\d+)/(\d+) frames in ([\d.]+)s "
                      r"\(([\d.]+) fps\)", err)
        _require(m is not None, f"cli: no status line in {err[-2000:]}")
        frames = int(m.group(1))
        _require(frames == main["frames"], f"cli decoded {frames} frames")
        for k in CLI_KERNELS:
            want = frames - 1 if k == "mc" else frames
            _require(launches.get(k, 0) >= want, f"cli: {k} launched "
                     f"{launches.get(k, 0)} times, want >= {want}")
        for k in ("itx", "cdef_dir"):
            _require(launches.get(k, 0) == frames, f"cli: {k} launched "
                     f"{launches.get(k, 0)} times for {frames} frames")
        rc_bad, err_bad, _ = _cli("-i", DATA / MAIN_STREAM, "--muxer",
                                  "null", "--verify", "0" * 32)
        _require(rc_bad == 1 and "verify FAILED" in err_bad,
                 f"cli --verify with a wrong digest: exit {rc_bad}")
        report["cli"] = {"md5": got, "fps_status_line": float(m.group(4)),
                         "decode_s": float(m.group(3)),
                         "process_s": wall,
                         "launches": {k: launches.get(k, 0)
                                      for k in CLI_KERNELS},
                         "verify_wrong_exit": rc_bad}
        print(f"  cli on {MAIN_STREAM}: md5 {got} (the JAX CLI's), "
              f"{m.group(4)} fps on the status line ({m.group(3)} s of "
              f"decode, {wall:.1f} s for the process) on {card}; launches "
              f"{report['cli']['launches']}; --verify with a wrong digest "
              f"exits {rc_bad}", flush=True)
        # the player's PPM dump of the first two frames
        ppm = tmp / "ppm"
        r = subprocess.run([sys.executable, "-m", "dav1d_tpu_torch.play",
                            "-i", str(DATA / MAIN_STREAM), "--ppm", str(ppm),
                            "--no-pace", "--limit", "2"], capture_output=True,
                           text=True, cwd=ROOT, timeout=300)
        _require(r.returncode == 0, f"player: exit {r.returncode}, "
                 f"{r.stderr[-2000:]}")
        h = hashlib.md5()
        files = sorted(ppm.iterdir())
        for f in files:
            h.update(f.read_bytes())
        _require(len(files) == 2 and h.hexdigest() == main["ppm_md5"],
                 f"player: {len(files)} files md5 {h.hexdigest()}, want 2 "
                 f"md5 {main['ppm_md5']} (the JAX player's)")
        report["play_ppm_md5"] = h.hexdigest()
        print(f"  player --ppm, 2 frames: md5 {h.hexdigest()} (the JAX "
              f"player's)", flush=True)
        # GOP-parallel (2 workers) and relay (2 segments) decodes
        data = (DATA / GOP_STREAM).read_bytes()
        want = (md5s[GOP_STREAM]["frames"], md5s[GOP_STREAM]["md5"])
        for kind, run in (("gop_decode", lambda d: gop.gop_decode(
                data, jobs=2, workdir=d, device=device)),
                          ("relay_decode", lambda d: gop.relay_decode(
                              data, segments=2, workdir=d, device=device))):
            d = tmp / kind
            d.mkdir()
            t0 = time.perf_counter()
            parts = run(str(d))
            wall = time.perf_counter() - t0
            got = _stitched(parts)
            print(f"  {kind} of {GOP_STREAM}: {len(parts)} segments "
                  f"{[c for c, _ in parts]} frames, md5 {got[1]} (want "
                  f"{want[1]}), {wall:.1f} s with process starts",
                  flush=True)
            _require(len(parts) == 2 and got == want,
                     f"{kind}: {len(parts)} segments, {got}, want {want}")
            report[kind] = {"segments": [c for c, _ in parts],
                            "md5": got[1], "wall_s": wall}
    # the fused step, held against its plain version on CPU tensors
    fn, ex = entry.entry(device)
    devrt.LAUNCHES.clear()
    out = fn(*ex)
    torch.cuda.synchronize()
    step_launches = {k: v for k, v in devrt.LAUNCHES.items() if v}
    ref = fn(*(t.cpu() for t in ex))
    e = _max_abs_err(out.cpu(), ref)
    _require(e == 0 and out.shape == ref.shape and
             step_launches == {"mc": 1, "itx": 1},
             f"entry step: max_abs_err {e}, launches {step_launches}")
    step_ms = cuda_ms(lambda: fn(*ex))
    report["entry_step"] = {"shape": list(out.shape), "max_abs_err": e,
                            "launches": step_launches, "ms": step_ms}
    print(f"  entry(): {tuple(out.shape)} equal to its plain version "
          f"(max_abs_err {e}), launches {step_launches}, {step_ms:.4f} ms "
          f"a step", flush=True)
    report["dryrun_multichip"] = []
    for n in (2, 4):
        try:
            r = entry.dryrun_multichip(n, device)
        except AssertionError as exc:
            raise SmokeError(f"dryrun_multichip({n}): {exc}") from exc
        report["dryrun_multichip"].append(r)
        print(f"  dryrun_multichip({n}): {r}", flush=True)
    # the scaling tool, parts A and B
    a = scaling.part_a(MAIN_STREAM, SCALING_BANDS, device)
    _require(a["byte_equal_all"], f"scaling part A: a mesh decode differs "
             f"from the one-device decode: {a}")
    b = scaling.part_b((MAIN_STREAM, LR_STREAM), SCALING_BANDS, device)
    _require({r["bands"] for r in b["rows"]} == set(SCALING_BANDS),
             f"scaling part B: rows for {[r['bands'] for r in b['rows']]}")
    print(json.dumps({"scaling": {"A": a, "B": b, "card": card}}),
          flush=True)
    for r in b["rows"]:
        if "luma_band0" in r:
            print(f"  K2b, {r['stream']} at {r['bands']} bands: the first "
                  f"luma band alone {r['luma_band0']}", flush=True)
    report["scaling"] = {
        "A": [{k: r[k] for k in ("bands", "byte_equal", "wall_fps",
                                 "halo_bytes_per_frame",
                                 "bytes_between_bands_per_frame")}
              for r in a["runs"]],
        "B": [{k: r[k] for k in ("stream", "kernel", "bands", "calls",
                                 "device_ms_per_call",
                                 "full_device_ms_per_frame",
                                 "share_device_ms_per_frame", "efficiency",
                                 "wrapper_efficiency")}
              for r in b["rows"]]}
    for r in report["scaling"]["B"]:
        _require(r["device_ms_per_call"] is not None and
                 r["device_ms_per_call"] > 0, f"scaling part B: no device "
                 f"time for {r}")
    return report


def check_feature_frames(where, mode, frames, grain, intra, launches,
                         pictures, grained):
    """Phase 7's frame-by-frame launch checks of one decode (``frames``:
    ChainLog records, one a decoded frame; ``grain`` / ``intra``:
    FrameLog records; ``grained``: film grain on each of the
    ``pictures``)."""
    n_decoded = len(frames)
    for i, fr in enumerate(frames):
        k = fr["launches"]
        _require(k.get("resize", 0) == int(fr["resize"]), f"{where} frame "
                 f"{i}: super-res {fr['resize']} with {k.get('resize', 0)} "
                 f"resize launches, want one a super-res frame")
        if fr["lossless"]:
            _require(not any(k.get(t, 0) for t in FILTER_KERNELS),
                     f"{where} frame {i}: a coded-lossless frame launched "
                     f"{k}")
    if mode == "fused":
        _require(not launches.get("mc") and not launches.get("itx"),
                 f"{where}: fused mode launched mc / itx: {launches}")
    else:
        # one itx launch a frame with coefficients
        _require(1 <= launches.get("itx", 0) <= n_decoded, f"{where}: "
                 f"{launches.get('itx', 0)} itx launches for {n_decoded} "
                 "decoded frames")
    if grained:
        check_grain_frames(where, grain, pictures)
    if mode == "device_intra":
        check_intra_frames(where, intra)


def _call_plains():
    from dav1d_tpu_torch.ops import cdef as ocdef
    from dav1d_tpu_torch.ops import itx as oitx
    from dav1d_tpu_torch.ops import lr as olr
    from dav1d_tpu_torch.ops import mc as omc
    from dav1d_tpu_torch.ops import resize as oresize

    return {"mc": (omc.put_8tap_resident, omc.put_8tap_resident_plain),
            "itx": (oitx.itx_frame, _itx_plain),
            "cdef_filter": (ocdef.filter_plane, ocdef.filter_plane_plain),
            "resize": (oresize.resize_planes, oresize.resize_planes_plain),
            "lr_wiener": (olr.wiener, olr.wiener_plain),
            "lr_sgr": (olr.sgr, olr.sgr_plain)}


def features(device, card) -> dict:
    """Phase 7: the JAX suite's AV1 feature streams on the card (module
    docstring).  Returns its report; its "launches" are the kernels'
    launches over its decodes, counted from 0 before each."""
    import tempfile

    import torch

    from dav1d_tpu_torch import devrt
    from dav1d_tpu_torch.ops import fg as ofg

    md5s = json.loads((FEATURE_DIR / "md5.json").read_text())
    _require(md5s, f"no feature streams in {FEATURE_DIR}")
    plains = _call_plains()
    report = {"decodes": [], "mesh": [], "calls": {}, "card": card}
    totals = collections.Counter()
    fg_hbd = []
    for name in sorted(md5s):
        e = md5s[name]
        data = (FEATURE_DIR / name).read_bytes()
        chain = {}
        for mode in FEATURE_MODES:
            if mode == "device_intra" and name in FEATURE_NO_INTRA:
                continue
            devrt.LAUNCHES.clear()
            devrt.COUNTS.clear()
            keep = mode == "two_pass" and (
                name in FEATURE_CALLS or (e["bitdepth"] > 8 and
                                          name in FEATURE_GRAIN))
            devrt.SINK = [] if keep else None
            t0 = time.perf_counter()
            try:
                with ChainLog() as clog, FrameLog() as flog:
                    n, md5, _ = decode(
                        data, device, two_pass=mode != "fused",
                        device_intra=mode == "device_intra",
                        container=e["container"], check_refs=True)
            finally:
                sink, devrt.SINK = devrt.SINK, None
            wall = time.perf_counter() - t0
            launches = {k: v for k, v in sorted(devrt.LAUNCHES.items()) if v}
            where = f"{name} [{mode}]"
            print(f"  {where}: {n} frames, md5 {md5} "
                  f"{'held' if md5 == e['md5'] else 'WANT ' + e['md5']}, "
                  f"launches {launches}, {n / wall:.3f} frames/s "
                  f"({e['width']}x{e['height']} {e['layout']} "
                  f"{e['bitdepth']}-bit)", flush=True)
            _require((n, md5) == (e["frames"], e["md5"]), f"{where}: "
                     f"decoded {n} frames md5 {md5}, want {e['frames']} "
                     f"frames md5 {e['md5']}")
            check_feature_frames(where, mode, clog.frames, flog.grain,
                                 flog.intra, launches, n,
                                 name in FEATURE_GRAIN)
            chain[mode] = [{k: v for k, v in fr["launches"].items()
                            if k not in ("mc", "itx")}
                           for fr in clog.frames]
            totals.update(launches)
            report["decodes"].append({"stream": name, "mode": mode,
                                      "frames": n, "fps": n / wall})
            for tag, fn, args, kw in sink or ():
                if tag == "fg":
                    if args[8].pl:
                        fg_hbd.append((name, args))
                    continue
                if tag not in plains:
                    continue
                kfn, pfn = plains[tag]
                # of the keywords only the restoration calls' chunk tables
                kw = {k: v for k, v in kw.items() if k == "chunks"}
                err = _max_abs_err(kfn(*args, **kw), pfn(*args))
                c = report["calls"].setdefault(tag, {"calls": 0,
                                                     "max_abs_err": 0})
                c["calls"] += 1
                c["max_abs_err"] = max(c["max_abs_err"], err)
                _require(err == 0, f"{where}: a {tag} call of the decode "
                         f"disagrees with its plain version (max_abs_err "
                         f"{err})")
            del sink
        # fused mode: the chain's launches of two-pass mode, frame by frame
        _require(chain["fused"] == chain["two_pass"], f"{name}: the fused "
                 f"decode's chain launches {chain['fused']} differ from "
                 f"the two-pass decode's {chain['two_pass']}")
    print(f"  the decodes' own calls against the plain versions: "
          f"{report['calls']}", flush=True)
    for tag in CALL_TAGS:
        _require(report["calls"].get(tag, {}).get("calls", 0) > 0,
                 f"phase 7: no {tag} call of the held decodes")
    # the odd geometries with bands on the card
    for name in FEATURE_MESH:
        e = md5s[name]
        data = (FEATURE_DIR / name).read_bytes()
        for bands in FEATURE_MESH_BANDS:
            devrt.LAUNCHES.clear()
            devrt.COUNTS.clear()
            t0 = time.perf_counter()
            with ChainLog() as clog:
                n, md5, _ = decode(data, device, bands=bands,
                                   container=e["container"],
                                   check_refs=True)
            wall = time.perf_counter() - t0
            launches = {k: v for k, v in sorted(devrt.LAUNCHES.items()) if v}
            where = f"{name} [mesh of {bands}]"
            print(f"  {where}: {n} frames, md5 {md5} "
                  f"{'held' if md5 == e['md5'] else 'WANT ' + e['md5']}, "
                  f"launches {launches}, {n / wall:.3f} frames/s", flush=True)
            _require((n, md5) == (e["frames"], e["md5"]), f"{where}: "
                     f"decoded {n} frames md5 {md5}, want {e['frames']} "
                     f"frames md5 {e['md5']}")
            live = -(-e["height"] // mesh_of(device, bands)
                     .band_rows(e["height"]))
            for i, fr in enumerate(clog.frames):
                check_band_launches(f"{where} frame {i}", fr, bands, live)
            _require(launches.get("itx", 0) == devrt.COUNTS.get(
                "mesh_itx_shares", 0) >= len(clog.frames), f"{where}: "
                f"{launches.get('itx', 0)} itx launches for "
                f"{devrt.COUNTS.get('mesh_itx_shares', 0)} shares")
            totals.update(launches)
            report["mesh"].append({"stream": name, "bands": bands,
                                   "frames": n, "fps": n / wall})
    # the CLI in fused mode
    e = md5s[FEATURE_CLI]
    with tempfile.TemporaryDirectory(dir=ROOT / "dav1d_tpu_torch"
                                     / "_build") as tmp:
        out = Path(tmp) / "out.md5"
        rc, err, cli_launches = _cli("-i", FEATURE_DIR / FEATURE_CLI,
                                     "--muxer", "md5", "-o", out,
                                     "--twopass", "0", "--verify", e["md5"])
        _require(rc == 0 and "verify OK" in err, f"cli --twopass 0 on "
                 f"{FEATURE_CLI}: exit {rc}, stderr {err[-2000:]}")
        got = out.read_text().split()[0]
    _require(got == e["md5"], f"cli --twopass 0: md5 {got}, want "
             f"{e['md5']}")
    _require(not cli_launches.get("mc") and not cli_launches.get("itx")
             and cli_launches.get("deblock_v", 0) >= 1, f"cli --twopass 0:"
             f" launches {cli_launches}")
    report["cli_fused"] = {"stream": FEATURE_CLI, "md5": got,
                           "launches": cli_launches}
    print(f"  cli --twopass 0 on {FEATURE_CLI}: md5 {got} held, launches "
          f"{cli_launches}", flush=True)
    # film grain on 10-bit chroma: the decodes' calls, and the committed
    # 352x288 10-bit stream's
    devrt.SINK = []
    try:
        decode((DATA / FG_HBD_STREAM).read_bytes(), device, hashing=False)
    finally:
        sink, devrt.SINK = devrt.SINK, None
    fg_hbd += [(FG_HBD_STREAM, a) for t, _, a, _ in sink
               if t == "fg" and a[8].pl]
    _require(fg_hbd, "no 10-bit chroma fg call")
    for name, args in fg_hbd:
        err = _max_abs_err(ofg.apply_plane(*args),
                           ofg.apply_plane_plain(*args))
        _require(err == 0, f"{name}: a 10-bit chroma fg call disagrees with "
                 f"its plain version (max_abs_err {err})")
    report["fg_10bit_chroma"] = []
    for name in sorted({r[0] for r in fg_hbd}):
        # the largest chroma plane of the stream
        args = max((a for n_, a in fg_hbd if n_ == name),
                   key=lambda a: a[5] * a[6])
        l_ms, _ = launch_ms(ofg.apply_plane, args)
        b_ms, b_by = bound("fg", args)
        r = {"stream": name, "plane": int(args[8].pl),
             "w": int(args[5]), "h": int(args[6]), "launch_ms": l_ms,
             "bound_ms": b_ms, "bound_by": b_by,
             "calls": sum(n_ == name for n_, _ in fg_hbd)}
        report["fg_10bit_chroma"].append(r)
        print(f"  fg 10-bit chroma, {name} plane {r['plane']} "
              f"({r['w']}x{r['h']}): launch {l_ms:.4f} ms, bound "
              f"{b_ms:.5f} ms ({b_by}), share {b_ms / l_ms:.3f}; "
              f"{r['calls']} chroma calls held exactly", flush=True)
    report["launches"] = dict(totals)
    return report


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SmokeError("CUDA is not available: the smoke run needs a GPU")
    _require((ROOT / "dav1d_tpu_torch").is_dir() and DATA.is_dir(),
             f"no dav1d_tpu_torch package beside {Path(__file__).name}: "
             "run from a checkout of the repository")
    _require(not _jax_modules(), f"jax already imported: {_jax_modules()}")
    sys.path.insert(0, str(ROOT))
    from dav1d_tpu_torch.ops import mc as omc

    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    print("== 1. card", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    _require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"  python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    print("== 2. build", flush=True)
    from dav1d_tpu_torch import devrt
    from dav1d_tpu_torch.kernels import build

    native = {}

    def _native():
        t = time.perf_counter()
        from dav1d_tpu_torch import native as nat

        native["lib"], native["s"] = nat.lib, time.perf_counter() - t

    t0 = time.perf_counter()
    th = threading.Thread(target=_native)
    th.start()  # cc of native/ beside the nvcc builds
    try:
        so = build.build()
        build.lib()
    finally:
        th.join()
    print(f"  {so.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    _require(native.get("lib") is not None,
             "the port's native C did not build (dav1d_tpu_torch/native)")
    print(f"  native C {native['lib']._name.rsplit('/', 1)[-1]} in "
          f"{native['s']:.1f} s", flush=True)
    for line in build.build_log().splitlines():
        if any(w in line for w in ("entry function", "registers", "spill",
                                   "error")):
            print("  ptxas:", line.strip(), flush=True)
    occ = itx_occupancy()
    print(f"  itx kernel (64 threads a CTA): {occ}", flush=True)
    attrs = restore_grain_attrs()
    print(f"  fg / lr_wiener / lr_sgr / resize kernels (registers, shared "
          f"bytes): {attrs}", flush=True)

    # (ops/itx imports the port's recon/itx, which loads the native C:
    # after its timed build above)
    from dav1d_tpu_torch.ops import cdef as ocdef
    from dav1d_tpu_torch.ops import itx as oitx

    print("== 3. kernels vs plain versions on the card (exact)",
          flush=True)
    cases = make_cases(device)
    errs = compare_kernels(cases, torch.cuda.synchronize)

    print("== 4. decode through Decoder(device='cuda')", flush=True)
    data = (DATA / MAIN_STREAM).read_bytes()
    devrt.LAUNCHES.clear()
    devrt.COUNTS.clear()
    nframes, ninter = decode_checked(MAIN_STREAM, device)
    launches = {k: devrt.LAUNCHES[k] for k in KERNELS}
    blocks = dict(devrt.COUNTS)
    print(f"  launches in the {MAIN_STREAM} decode: {launches}", flush=True)
    print(f"  MC kernel predicted {blocks.get('mc_blocks', 0)} of "
          f"{blocks.get('inter_blocks', 0)} inter blocks; itx kernel "
          f"transformed {blocks.get('itx_blocks', 0)} blocks", flush=True)
    for k, n in launches.items():
        if k in OTHER_PATHS:  # not on this decode: counted below
            continue
        want = ninter if k == "mc" else nframes
        _require(n >= want, f"{k}: {n} launches, want >= {want} "
                 f"({nframes} frames, {ninter} inter)")
    # one itx launch per frame; every frame of the stream searches the
    # CDEF directions of its luma plane, once
    for k in ("itx", "cdef_dir"):
        _require(launches[k] == nframes, f"{k}: {launches[k]} launches "
                 f"for {nframes} frames, want one per frame")
    _require(ninter >= 3, f"{MAIN_STREAM}: {ninter} inter frames")
    devrt.LAUNCHES.clear()
    devrt.COUNTS.clear()
    decode_checked(HBD_STREAM, device)
    hbd = {k: devrt.LAUNCHES[k] for k in KERNELS}
    print(f"  launches in the {HBD_STREAM} decode: {hbd}; MC kernel "
          f"predicted {devrt.COUNTS['mc_blocks']} of "
          f"{devrt.COUNTS['inter_blocks']} inter blocks; itx kernel "
          f"transformed {devrt.COUNTS['itx_blocks']} blocks", flush=True)
    _require(hbd["cdef_filter"] > 0, "10-bit decode ran no CDEF kernel")
    _require(hbd["mc"] > 0, "10-bit decode ran no MC kernel")
    _require(hbd["itx"] > 0, "10-bit decode ran no itx kernel")
    lr_frames = {}
    for name in (SR_STREAM, LR_STREAM):
        devrt.LAUNCHES.clear()
        devrt.COUNTS.clear()
        with ChainLog() as log:
            n_lr, _ = decode_checked(name, device)
        got = {k: devrt.LAUNCHES[k] for k in KERNELS}
        print(f"  launches in the {name} decode: {got}; counts "
              f"{dict(devrt.COUNTS)}", flush=True)
        for i, fr in enumerate(log.frames):
            print(f"    frame {i}: super-res {fr['resize']}, restoration "
                  f"{fr['lr']}, launches {fr['launches']}, units "
                  f"{fr['units']}, plane uploads {fr['uploads']} B",
                  flush=True)
        check_lr_frames(name, log.frames, n_lr)
        if name == SR_STREAM:
            _require(all(fr["resize"] for fr in log.frames),
                     f"{SR_STREAM}: a frame without super-res")
        lr_frames[name] = n_lr
        for k in LR_KERNELS:
            launches[k] = launches.get(k, 0) + got[k]
    _require(launches["lr_sgr"] >= 1, f"{LR_STREAM}: no lr_sgr launch")
    _require(launches["resize"] == lr_frames[SR_STREAM],
             f"{SR_STREAM}: {launches['resize']} resize launches for "
             f"{lr_frames[SR_STREAM]} super-res frames")
    # film grain: one fg launch per plane with grain on every picture
    for name in (FG_STREAM, FG_HBD_STREAM):
        devrt.LAUNCHES.clear()
        devrt.COUNTS.clear()
        with FrameLog() as log:
            n_fg, _ = decode_checked(name, device)
        check_grain_frames(name, log.grain, n_fg)
        print(f"  {name}: fg launches per picture "
              f"{[fr['fg'] for fr in log.grain]} (planes with grain "
              f"{[fr['planes'] for fr in log.grain]}; resident planes "
              f"{[fr['resident'] for fr in log.grain]})", flush=True)
        if (name, False) == PATH_OF["fg"]:
            launches["fg"] = devrt.LAUNCHES["fg"]
    decode_checked(SCREEN_STREAM, device)
    # device intra: the same md5s; per frame one walk per chain holding
    # units, no per-level launch, none on host-walk or all-inter frames
    intra_report, walk_logs = {}, {}
    for name in INTRA_STREAMS:
        devrt.LAUNCHES.clear()
        devrt.COUNTS.clear()
        with FrameLog(keep_walks=name in LEVEL_STREAM.values()) as log:
            decode_checked(name, device, device_intra=True)
        got, host = check_intra_frames(name, log.intra)
        counts = {k: v for k, v in devrt.COUNTS.items()
                  if k.startswith("intra_")}
        intra_report[name] = {"launches": got, "host_walk_frames": host,
                              "counts": counts,
                              "frames": len(log.intra)}
        print(f"  {name} device_intra: launches {got}, host-walk frames "
              f"{host}, counts {counts}, walks per frame (chain, units) "
              f"{[[(w['chain'], w['units']) for w in fr['walks']] for fr in log.intra]}",
              flush=True)
        _require(got.get("ipred_walk", 0) >= 1, f"{name}: no ipred_walk "
                 "launch with device_intra")
        if PATH_OF["ipred_walk"] == (name, True):
            for k in INTRA_KERNELS:
                launches[k] = got.get(k, 0)
        walk_logs[name] = log.intra
    for k in ("fg", "ipred_walk"):
        _require(launches.get(k, 0) >= 1, f"{k}: no launch on "
                 f"{PATH_OF[k][0]}")
    # the main stream's key frame: its walks repeated, and replayed level
    # by level through K10-K12, from the same canvas (outside the counted
    # decodes)
    key = walk_logs[MAIN_STREAM][0]
    _require(key["device"] and key["walks"], f"{MAIN_STREAM}: the key "
             "frame made no walk")
    key_walks = key_frame_walks(key["walks"])
    for r in key_walks:
        print(f"  {MAIN_STREAM} key frame chain {r['chain']}: {r['levels']} "
              f"levels, {r['units']} units; {r['repeats']} walks bitwise "
              f"equal to each other, to the decode's and to its "
              f"{r['level_launches']} per-level launches; walk "
              f"{r['walk_ms']:.4f} ms (device {r['walk_device_ms']:.4f}), "
              f"per-level launches {r['levels_ms']:.3f} ms as issued "
              f"(device {r['levels_device_ms']:.3f} back to back, "
              f"{r['levels_host_queue_ms']:.1f} ms to queue them)",
              flush=True)
    floor = walk_floor_ms(device)
    print(f"  walk latency floor a level (one handoff plus the smallest "
          f"unit): {floor['pal'] * 1e3:.3f} us (4x4 palette), "
          f"{floor['pred'] * 1e3:.3f} us (4x4 DC_128 prediction)",
          flush=True)
    # multi-device decode: 2 and 4 bands on the card (Settings.mesh), frame
    # by frame through the chain, launch counts zeroed before each decode
    md5s = json.loads((DATA / "md5.json").read_text())
    mesh_report = {}
    mesh_totals = {}
    for name in MESH_STREAMS:
        ph = md5s[name]["height"]
        for bands in MESH_BANDS:
            devrt.LAUNCHES.clear()
            devrt.COUNTS.clear()
            with ChainLog() as log:
                n_m, _ = decode_checked(name, device, bands=bands)
            got = dict(devrt.LAUNCHES)
            counts = dict(devrt.COUNTS)
            halo = check_mesh_frames(name, log.frames, n_m, bands, ph,
                                     mesh_of(device, bands).band_rows(ph))
            _require(got.get("itx", 0) == counts.get("mesh_itx_shares", 0)
                     == bands * n_m, f"{name} mesh of {bands}: "
                     f"{got.get('itx', 0)} itx launches, "
                     f"{counts.get('mesh_itx_shares', 0)} shares, want "
                     f"{bands} a frame")
            mesh_totals[(name, bands)] = got
            mesh_report[f"{name} bands={bands}"] = {
                "launches": got, "halo_bytes_per_frame": halo,
                "counts": {k: v for k, v in counts.items()
                           if k.startswith("mesh_")}}
            print(f"  {name} mesh of {bands}: launches {got}; halo bytes "
                  f"per frame {halo}; band work "
                  f"{mesh_report[f'{name} bands={bands}']['counts']}",
                  flush=True)
            if (name, bands) == (MAIN_STREAM, MESH_PATH):
                launches["cdef_filter_band"] = got.get("cdef_filter_band", 0)
    _require(launches["cdef_filter_band"] >= 1, "cdef_filter_band: no "
             f"launch in the {MAIN_STREAM} mesh decode")
    # worker threads (Settings.n_threads): the same md5s and, over the
    # decode, the same launches as one after the other (the frame-by-frame
    # records above need frames that finish in order, so none here)
    threads_report = {}
    for name, bands in [(s_, 0) for s_ in THREAD_STREAMS] + \
            [(MAIN_STREAM, MESH_PATH)]:
        if bands:
            alone = mesh_totals[(name, bands)]
        else:
            devrt.LAUNCHES.clear()
            decode_checked(name, device)
            alone = dict(devrt.LAUNCHES)
        devrt.LAUNCHES.clear()
        decode_checked(name, device, bands=bands, n_threads=N_THREADS)
        got = dict(devrt.LAUNCHES)
        _require(got == alone, f"{name} n_threads={N_THREADS}"
                 f"{f' mesh of {bands}' if bands else ''}: launches {got}, "
                 f"{alone} with n_threads=0")
        threads_report[f"{name} bands={bands}"] = sum(got.values())
    print(f"  n_threads={N_THREADS}: md5s and launches as with 0 "
          f"(launches per decode: {threads_report})", flush=True)
    # the other layouts, one device and a 2-band mesh
    for name in LAYOUT_STREAMS:
        for bands in (0, 2):
            devrt.LAUNCHES.clear()
            decode_checked(name, device, bands=bands)
            print(f"    launches {dict(devrt.LAUNCHES)}", flush=True)

    print("== 5. timing", flush=True)
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        n, _, _ = decode(data, device, hashing=False)
        runs.append(n / (time.perf_counter() - t0))
    fps = max(runs)
    print(f"  {MAIN_STREAM}: {fps:.3f} frames/s (best of 3 after the "
          f"warm-up decode; runs {[round(r, 3) for r in runs]}) on "
          f"{card}", flush=True)
    # the mesh decode: bands on one card, so no scaling measurement; what
    # the band work and the halo exchanges cost beside one device
    mesh_fps = {}
    for bands in MESH_BANDS:
        mruns = []
        for _ in range(3):
            t0 = time.perf_counter()
            n, _, _ = decode(data, device, hashing=False, bands=bands)
            mruns.append(n / (time.perf_counter() - t0))
        # and once more with the stage spans on
        devrt.SPANS = {}
        n, _, _ = decode(data, device, hashing=False, bands=bands)
        mspans, devrt.SPANS = devrt.SPANS, None
        mesh_fps[bands] = {"fps": max(mruns), "runs": mruns,
                           "stage_ms_per_frame": {
                               k: round(v * 1e3 / n, 3)
                               for k, v in sorted(mspans.items())}}
        print(f"  {MAIN_STREAM} mesh of {bands} bands on the one card: "
              f"{max(mruns):.3f} frames/s (best of 3; runs "
              f"{[round(r, 3) for r in mruns]}; one device {fps:.3f}) on "
              f"{card}; stages (ms) "
              f"{mesh_fps[bands]['stage_ms_per_frame']}", flush=True)
    # one more decode with the stage spans and transfer counters on,
    # capturing the MC and itx kernels' calls
    devrt.SPANS, devrt.XFER, devrt.SINK = {}, {"up": 0, "down": 0}, []
    t0 = time.perf_counter()
    n, _, _ = decode(data, device, hashing=False)
    wall = time.perf_counter() - t0
    spans, xfer = devrt.SPANS, devrt.XFER
    calls = [(_kernel_of(tag, args), args) for tag, _, args, _ in devrt.SINK]
    mc_calls = [args for name, args in calls if name == "mc"]
    itx_calls = [args for name, args in calls if name == "itx"]
    cdef_calls = [args for name, args in calls if name == "cdef_filter"]
    devrt.SPANS = devrt.XFER = devrt.SINK = None
    stages = {k: round(v * 1e3 / n, 3) for k, v in sorted(spans.items())}
    xfer_frame = {k: v // n for k, v in xfer.items()}
    print(f"  per frame: wall {wall * 1e3 / n:.3f} ms, stages (ms) "
          f"{stages}, upload {xfer['up'] // n} B, download "
          f"{xfer['down'] // n} B", flush=True)
    # the least device time per frame of each kernel on the decode's own
    # calls (compare with tools/torch_decode_profile.py's device times)
    frame_bound = {k: sum(bound(k, a)[0] for name, a in calls if name == k)
                   / n for k in KERNELS if k not in OTHER_PATHS}
    print(f"  bound per frame on the decode's calls (ms): "
          f"{ {k: round(v, 5) for k, v in frame_bound.items()} }",
          flush=True)
    _require(mc_calls, "the traced decode made no MC call")
    for i, args in enumerate(mc_calls):
        e = _max_abs_err(omc.put_8tap_resident(*args),
                         omc.put_8tap_resident_plain(*args))
        print(f"  mc decode call {i}: {args[2].shape[0]} jobs, "
              f"{args[3].shape[0]} tiles, {args[4]} "
              f"pixels, max_abs_err={e}", flush=True)
        errs["mc"] = max(errs["mc"], e)
    _require(errs["mc"] == 0, "mc disagrees with its plain version on "
             "the decode's calls")
    tl_ms = tile_list_host_ms(mc_calls, n)
    print(f"  mc tile list, host ms per frame (medians of 20): "
          f"tile_list {tl_ms['tile_list']:.4f}, upload of jobs and tiles "
          f"{tl_ms['upload_jobs_and_tiles']:.4f} against jobs alone "
          f"{tl_ms['upload_jobs']:.4f}: {tl_ms['added']:.4f} added",
          flush=True)
    _require(len(cdef_calls) >= n, f"the traced decode made "
             f"{len(cdef_calls)} cdef_filter calls for {n} frames")
    for i, args in enumerate(cdef_calls):
        e = _max_abs_err(ocdef.filter_plane(*args),
                         ocdef.filter_plane_plain(*args))
        pm, sm = args[1] > 0, args[2] > 0
        print(f"  cdef_filter decode call {i}: "
              f"{'luma' if args[11] else 'chroma'} {tuple(args[0].shape)}, "
              f"units {args[7]}x{args[8]}: {int((pm & sm).sum())} both "
              f"strengths, {int((pm & ~sm).sum())} primary only, "
              f"{int((sm & ~pm).sum())} secondary only, {pm.numel()} in all; "
              f"max_abs_err={e}", flush=True)
        errs["cdef_filter"] = max(errs["cdef_filter"], e)
    _require(errs["cdef_filter"] == 0, "cdef_filter disagrees with its "
             "plain version on the decode's calls")
    _require(len(itx_calls) == n, f"the traced decode made "
             f"{len(itx_calls)} itx calls for {n} frames")
    itx_stats = []
    for i, args in enumerate(itx_calls):
        e = _max_abs_err(oitx.itx_frame(*args), _itx_plain(*args))
        st = itx_call_stats(args)
        itx_stats.append(st)
        print(f"  itx decode call {i}: {args[1].shape[0]} jobs in "
              f"{args[2].shape[0]} groups, {args[3]} residuals, "
              f"max_abs_err={e}; {st}", flush=True)
        errs["itx"] = max(errs["itx"], e)
    _require(errs["itx"] == 0, "itx disagrees with its plain version on "
             "the decode's calls")
    # the restoration streams: frames/s, stages and transfers, and every
    # resize / Wiener / self-guided call of one decode against the plain
    # version
    from dav1d_tpu_torch.ops import lr as olr
    from dav1d_tpu_torch.ops import resize as oresize

    plain_of = {"resize": oresize.resize_planes_plain,
                "lr_wiener": olr.wiener_plain, "lr_sgr": olr.sgr_plain}
    kernel_of = {"resize": oresize.resize_planes, "lr_wiener": olr.wiener,
                 "lr_sgr": olr.sgr}
    lr_calls = {k: [] for k in LR_KERNELS}
    lr_report = {}
    for name in (SR_STREAM, LR_STREAM):
        sdata = (DATA / name).read_bytes()
        sruns = []
        for _ in range(3):
            t0 = time.perf_counter()
            sn, _, _ = decode(sdata, device, hashing=False)
            sruns.append(sn / (time.perf_counter() - t0))
        devrt.SPANS, devrt.XFER, devrt.SINK = {}, {"up": 0, "down": 0}, []
        t0 = time.perf_counter()
        sn, _, _ = decode(sdata, device, hashing=False)
        swall = time.perf_counter() - t0
        sspans, sxfer, ssink = devrt.SPANS, devrt.XFER, devrt.SINK
        devrt.SPANS = devrt.XFER = devrt.SINK = None
        # of the keywords only the restoration calls' chunk tables (the
        # kernels' schedules; an ``out`` would hold the decode's result)
        scalls = [(tag, args, {k: v for k, v in kw.items() if k == "chunks"})
                  for tag, _, args, kw in ssink if tag in LR_KERNELS]
        sbound = {k: sum(bound(k, a)[0] for t, a, _ in scalls if t == k)
                  / sn for k in LR_KERNELS}
        lr_report[name] = {
            "fps": max(sruns), "fps_runs": sruns,
            "wall_ms_per_frame": swall * 1e3 / sn,
            "stage_ms_per_frame": {k: round(v * 1e3 / sn, 3)
                                   for k, v in sorted(sspans.items())},
            "xfer_bytes_per_frame": {k: v // sn for k, v in sxfer.items()},
            "bound_ms_per_frame": sbound}
        print(f"  {name}: {max(sruns):.3f} frames/s (best of 3 after the "
              f"warm-up decode; runs {[round(r, 3) for r in sruns]}) on "
              f"{card}", flush=True)
        print(f"  {name} per frame: wall {swall * 1e3 / sn:.3f} ms, stages "
              f"(ms) {lr_report[name]['stage_ms_per_frame']}, upload "
              f"{sxfer['up'] // sn} B, download {sxfer['down'] // sn} B; "
              f"bound (ms) { {k: round(v, 5) for k, v in sbound.items()} }",
              flush=True)
        for i, (tag, args, kw) in enumerate(scalls):
            # kw: a restoration call's chunk table (the kernel's schedule)
            e = _max_abs_err(kernel_of[tag](*args, **kw),
                             plain_of[tag](*args))
            what = (f"{len(args[0])} planes "
                    f"{[tuple(p.shape) for p in args[0]]} -> "
                    f"{[g[0] for g in args[1]]} wide"
                    if tag == "resize" else f"{args[2].shape[0]} units "
                    f"on {tuple(args[0].shape)}")
            print(f"  {tag} {name} call {i}: {what}, max_abs_err={e}",
                  flush=True)
            errs[tag] = max(errs[tag], e)
            lr_calls[tag].append((name, args, kw))
    for k in LR_KERNELS:
        _require(lr_calls[k], f"the traced decodes made no {k} call")
        _require(errs[k] == 0, f"{k} disagrees with its plain version on "
                 "the decodes' calls")

    # film grain: spans and transfer bytes per picture, the decode's calls
    from dav1d_tpu_torch.ops import fg as ofg
    from dav1d_tpu_torch.ops import ipred as oip

    devrt.SPANS, devrt.XFER, devrt.SINK = {}, {"up": 0, "down": 0}, []
    with FrameLog() as log:
        gn, _, _ = decode((DATA / FG_STREAM).read_bytes(), device,
                          hashing=False)
    gspans, gsink = devrt.SPANS, devrt.SINK
    devrt.SPANS = devrt.XFER = devrt.SINK = None
    fg_calls = [args for tag, _, args, _ in gsink if tag == "fg"]
    grain_report = {
        "span_ms_per_picture": {k: v * 1e3 / gn for k, v in
                                sorted(gspans.items())
                                if k.startswith("grain")},
        "bytes_per_picture": {
            k: sum(fr["bytes"].get(k, 0) for fr in log.grain) / gn
            for k in ("up", "down")},
        "planes_resident": sum(fr["resident"] for fr in log.grain)}
    print(f"  {FG_STREAM}: grain per picture: spans (ms) "
          f"{ {k: round(v, 3) for k, v in grain_report['span_ms_per_picture'].items()} }, "
          f"bytes {grain_report['bytes_per_picture']}, pictures read from "
          f"resident planes {grain_report['planes_resident']} of {gn}",
          flush=True)
    # device intra: the pass2.intra.* spans with it off and on, and every
    # walk launch of the decode again, back to back behind a spin kernel
    # (the walks' device time without the host between them; in place on
    # the finished canvases, which no unit's control flow depends on)
    intra_calls = {}
    for name in INTRA_STREAMS:
        sdata = (DATA / name).read_bytes()
        rep = intra_report[name]
        rep["spans_ms_per_frame"] = {}
        for di in (False, True):
            devrt.SPANS = {}
            if di:
                devrt.SINK, devrt.CAPTURE = [], []
            with FrameLog() as log:
                sn, _, _ = decode(sdata, device, hashing=False,
                                  device_intra=di)
            sspans, ssink, scap = devrt.SPANS, devrt.SINK, devrt.CAPTURE
            devrt.SPANS = devrt.SINK = devrt.CAPTURE = None
            rep["spans_ms_per_frame"]["on" if di else "off"] = {
                k: v * 1e3 / sn for k, v in sorted(sspans.items())
                if k.startswith("pass2.intra")}
            if not di:
                continue
            intra_calls[name] = [args for tag, _, args, _ in ssink
                                 if tag == "ipred_walk"]
            rep["walks_back_to_back"] = []
            for fr in log.intra:
                a, b = fr["captured"]
                cap = [c for c in scap[a:b] if c[0] in INTRA_KERNELS]
                if cap:
                    ms, host_ms = replay_ms(cap)
                    rep["walks_back_to_back"].append(
                        {"launches": len(cap), "ms": ms,
                         "host_queue_ms": host_ms})
            del scap
        print(f"  {name}: pass2.intra spans per frame (ms) off "
              f"{ {k: round(v, 3) for k, v in rep['spans_ms_per_frame']['off'].items()} }"
              f", on "
              f"{ {k: round(v, 3) for k, v in rep['spans_ms_per_frame']['on'].items()} }"
              f"; levels {rep['counts'].get('intra_levels', 0)}, units "
              f"{ {k: rep['counts'].get(f'intra_{k}_units', 0) for k in ('pred', 'cfl', 'pal')} }"
              f", host-walk frames {rep['host_walk_frames']}; each "
              f"frame's walks again back to back (device ms, launches, "
              f"host ms to queue them): "
              f"{[(round(r['ms'], 4), r['launches'], round(r['host_queue_ms'], 2)) for r in rep['walks_back_to_back']]}",
              flush=True)

    # the least device time per frame of K9, the walk, and K10-K12 (their
    # kind's units of the walks) on their decodes' calls
    path_bound = {"fg": sum(bound("fg", a)[0] for a in fg_calls) / gn}
    path_bound["ipred_walk"] = sum(
        bound("ipred_walk", a)[0] for a in intra_calls[MAIN_STREAM]) \
        / intra_report[MAIN_STREAM]["frames"]
    for k in LEVEL_KERNELS:
        stream = LEVEL_STREAM[k]
        nbytes = sum(_units_work(KIND_OF[k], a[3][(a[4] & 3) == KIND_OF[k]],
                                 a[8], a[9])[0]
                     for a in intra_calls[stream])
        path_bound[k] = nbytes / HBM_BYTES_PER_S * 1e3 \
            / intra_report[stream]["frames"]
    print(f"  bound per frame on their decodes' calls (ms): "
          f"{ {k: round(v, 6) for k, v in path_bound.items()} }",
          flush=True)

    timed = {name: items[0] for name, items in cases.items()}
    big = max(fg_calls, key=lambda a: a[5] * a[6])
    timed["fg"] = (f"{FG_STREAM} plane {big[8].pl} ({big[5]}x{big[6]}) of "
                   "the decode", ofg.apply_plane, ofg.apply_plane_plain, big)
    plains = {"ipred": (oip.pred_level, oip.pred_level_plain),
              "ipred_cfl": (oip.cfl_level, oip.cfl_level_plain),
              "ipred_pal": (oip.pal_level, oip.pal_level_plain)}
    for k in LEVEL_KERNELS:
        # the largest level of the kind in the stream's walks, on a copy
        # of its walk's input canvas (timing only: phase 3 and the key
        # frame hold the results)
        stream, unit_kind, best = LEVEL_STREAM[k], KIND_OF[k], (0, None, 0, 0)
        for fr in walk_logs[stream]:
            for w in fr["walks"]:
                T = w["args"][4].cpu().numpy()
                ends = np.cumsum(w["args"][5].cpu().numpy())
                for a, b in zip(np.concatenate([[0], ends[:-1]]), ends):
                    sel = np.flatnonzero((T[a:b] & 3) == unit_kind)
                    if len(sel) > best[0]:
                        best = (len(sel), w, a + int(sel[0]),
                                a + int(sel[-1]) + 1)
        n, w, a, b = best
        _require(n > 0, f"the {stream} walks hold no {k} units")
        canvas, luma, resid, jobs, _, _, pidx, ph, ssh, ssv, bd = w["args"]
        J = jobs[a:b]
        args = {0: (canvas.clone(), resid, J, ph, bd),
                1: (canvas.clone(), luma, resid, J, ph, ssh, ssv, bd),
                2: (canvas.clone(), resid, J, pidx, bd)}[unit_kind]
        timed[k] = (f"{stream} level of {n} units (largest)", *plains[k],
                    args)
    # the walk: the main key frame's luma chain
    wl = next(w for w in key["walks"] if w["chain"] == 0)
    wkey = next(r for r in key_walks if r["chain"] == 0)
    wargs = (wl["args"][0].clone(),) + wl["args"][1:]
    timed["ipred_walk"] = (
        f"{MAIN_STREAM} key frame luma walk ({wkey['levels']} levels, "
        f"{wkey['units']} units)", functools.partial(oip.walk, **wl["kw"]),
        oip.walk_plain, wargs)
    # resize: the decode's call (the frame's planes and the snapshot's),
    # and below its luma plane alone and phase 3's denominator-9 luma
    # plane
    name, big, _ = max(lr_calls["resize"], key=lambda c: len(c[1][0]))
    timed["resize"] = (f"{name} frame call, {len(big[0])} planes",
                       oresize.resize_planes, oresize.resize_planes_plain,
                       big)
    resize_more = {
        "one_plane_luma": (
            f"{name} luma plane alone {tuple(big[0][0].shape)}",
            oresize.resize_plane, oresize.resize_plane_plain,
            (big[0][0], *big[1][0], big[2])),
        "denominator_9_luma": next(
            c for c in cases["resize"] if c[0].startswith("luma")
            and "1/9 " in c[0] and c[0].endswith("bd8"))}
    for k in ("lr_wiener", "lr_sgr"):
        name, big, kw = max(lr_calls[k], key=lambda c: c[1][2].shape[0])
        timed[k] = (f"{name} call of {big[2].shape[0]} units "
                    f"{tuple(big[0].shape)}",
                    functools.partial(kernel_of[k], **kw), plain_of[k], big)
    big = max(mc_calls, key=lambda a: a[4])
    timed["mc"] = (f"1080p inter frame of the decode ({big[2].shape[0]} "
                   f"jobs)", omc.put_8tap_resident,
                   omc.put_8tap_resident_plain, big)
    # itx on two calls: the one with the most jobs (the key frame's,
    # mostly small) here, the one with the most 64x64 jobs below
    big = max(itx_calls, key=lambda a: a[1].shape[0])
    timed["itx"] = (f"1080p frame of the decode ({big[1].shape[0]} jobs)",
                    oitx.itx_frame, _itx_plain, big)
    others = [i for i, a in enumerate(itx_calls) if a is not big]
    i64 = max(others or [0], key=lambda i: itx_stats[i]["jobs_by_size"]
              .get("64x64", 0))
    timed_inter = (f"1080p inter frame of the decode with the most 64x64 "
                   f"jobs (call {i64}, {itx_calls[i64][1].shape[0]} jobs)",
                   oitx.itx_frame, _itx_plain, itx_calls[i64])
    big = max((a for a in cdef_calls if a[11]), key=lambda a: a[0].numel())
    timed["cdef_filter"] = (
        f"1080p luma call of the decode {tuple(big[0].shape)}",
        ocdef.filter_plane, ocdef.filter_plane_plain, big)
    times = time_kernels({k: v for k, v in timed.items()
                          if k != "ipred_walk"})
    # the walk's plain version runs the key frame's levels one by one:
    # timed once, from the walk's input canvas, and it must equal the walk
    label, wkfn, _, wargs = timed["ipred_walk"]
    c = wl["args"][0].clone()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    e0.record()
    oip.walk_plain(c, *wl["args"][1:])
    e1.record()
    torch.cuda.synchronize()
    errs["ipred_walk"] = max(errs["ipred_walk"], _max_abs_err(c, wl["out"]))
    _require(errs["ipred_walk"] == 0, "ipred_walk disagrees with its plain "
             f"version on the {MAIN_STREAM} key frame")
    print(f"  ipred_walk {label}: walk_plain equal to the walk "
          f"(max_abs_err 0)", flush=True)
    times["ipred_walk"] = (min(cuda_ms(lambda: wkfn(*wargs))
                               for _ in range(2)), e0.elapsed_time(e1),
                           label)
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        ms, plain_ms, label = times[name]
        l_ms, host_ms = launch_ms(timed[name][1], timed[name][3])
        bound_ms, bound_by = bound(name, timed[name][3])
        print(f"  {name:12s} {label}: wrapper {ms:.4f} ms, launch "
              f"{l_ms:.4f} ms (20 launches queued in {host_ms:.2f} "
              f"ms of host time), plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), share "
              f"{bound_ms / l_ms:.3f}", flush=True)
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": errs[name], "ms": ms,
                        "launch_ms": l_ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "share": bound_ms / l_ms, "library_ms": None,
                        "on_path": name not in LEVEL_KERNELS})
        if name in attrs:
            kernels[-1].update(registers=attrs[name]["registers"],
                               shared_bytes=attrs[name]["shared_bytes"])
            print(f"  {name:12s} {attrs[name]['registers']} registers, "
                  f"{attrs[name]['shared_bytes']} B of shared "
                  f"memory", flush=True)
        if name == "ipred_walk":
            # levels x one handoff plus the smallest unit: what a chain of
            # dependent levels cannot beat
            kernels[-1]["latency_floor_ms"] = wkey["levels"] * floor["pal"]
            print(f"  {name:12s} latency floor {wkey['levels']} levels x "
                  f"{floor['pal'] * 1e3:.3f} us = "
                  f"{kernels[-1]['latency_floor_ms']:.4f} ms, share "
                  f"{kernels[-1]['latency_floor_ms'] / l_ms:.3f}",
                  flush=True)
    def extra_call(name, entry):
        """Wrapper, launch and plain ms, bound and share of one more call
        of kernel ``name``: entry = (label, kernel_fn, plain_fn, args)."""
        label, kfn, _, args = entry
        ms, plain_ms, _ = time_kernels({name: entry})[name]
        l_ms, host_ms = launch_ms(kfn, args)
        bound_ms, bound_by = bound(name, args)
        print(f"  {name:12s} {label}: wrapper {ms:.4f} ms, launch "
              f"{l_ms:.4f} ms (20 launches queued in {host_ms:.2f} ms "
              f"of host time), plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), share "
              f"{bound_ms / l_ms:.3f}", flush=True)
        return {"label": label, "ms": ms, "launch_ms": l_ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "share": bound_ms / l_ms}

    entry = {k["name"]: k for k in kernels}
    # the second itx call
    entry["itx"]["second_call"] = extra_call("itx", timed_inter)
    # resize: the frame call's luma plane alone, a denominator-9 luma plane
    for key, item in resize_more.items():
        entry["resize"][key] = extra_call("resize", item)
    # the empty launch: the floor under any launch's device time
    empty_ms, _ = launch_ms(build.empty_launch,
                            (torch.empty(1, device=device),))
    print(f"  empty launch (the floor under every launch): {empty_ms:.4f} "
          f"ms", flush=True)
    # lr_sgr: its timed call against the floor
    label = timed["lr_sgr"][0]
    entry["lr_sgr"]["launch_floor_ms"] = empty_ms
    print(f"  lr_sgr       {label}: launch {entry['lr_sgr']['launch_ms']:.4f}"
          f" ms; {entry['lr_sgr']['launch_ms'] / empty_ms:.2f}x the empty "
          f"launch", flush=True)
    print("== 6. entry points", flush=True)
    t6 = time.perf_counter()
    entry_report = entry_points(device, card)
    print(f"  phase 6 took {time.perf_counter() - t6:.1f} s", flush=True)
    print("== 7. the JAX suite's AV1 features", flush=True)
    t7 = time.perf_counter()
    feature_report = features(device, card)
    print(json.dumps({"features": feature_report}), flush=True)
    print(f"  phase 7 took {time.perf_counter() - t7:.1f} s", flush=True)
    for k in kernels:
        k["feature_launches"] = feature_report["launches"].get(k["name"], 0)
    _require(not _jax_modules(), f"jax was imported: {_jax_modules()}")
    print(json.dumps({"decode_fps": fps, "decode_fps_runs": runs,
                      "stage_ms_per_frame": stages, "stream": MAIN_STREAM,
                      "xfer_bytes_per_frame": xfer_frame,
                      "bound_ms_per_frame": frame_bound,
                      "mc_tile_list_host_ms_per_frame": tl_ms,
                      "itx_calls": itx_stats, "itx_occupancy": occ,
                      "restoration_streams": lr_report,
                      "mesh_fps": mesh_fps, "mesh_decodes": mesh_report,
                      "threads_launches": threads_report,
                      "grain": grain_report,
                      "bound_ms_per_frame_k9_walk": path_bound,
                      "device_intra": {
                          k: {kk: vv for kk, vv in v.items()}
                          for k, v in intra_report.items()},
                      "key_frame_walks": key_walks,
                      "walk_floor_ms_per_level": floor,
                      "empty_launch_ms": empty_ms,
                      "entry_points": entry_report,
                      "card": card}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
