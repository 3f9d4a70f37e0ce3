"""Device time of the intra walk (ops/ipred.walk, csrc/ipred.cu
ipred_walk) on a CUDA card: where a level's time goes.

Decodes a committed stream (default the 1080p inter stream) with
``Decoder(..., device_intra=True)`` and, on its key frame's walks
(chip_smoke.key_frame_walks), prints each chain's levels, units, the
walk's device time and the same levels through the per-level kernels
back to back; then the device time a level of walks of one unit a level
(1,024 levels, each unit at the same cells of a 256x256 canvas, bare
launches behind a spin kernel) for units of several kinds and sizes:
one handoff through L2 plus that unit's serial phases.  Run from the
repository root:

    python3 tools/torch_walk_probe.py [--stream NAME] [--tree DIR]

``--tree DIR``: the package and chip_smoke.py of another checkout (an
unpacked parent or variant, to compare two versions on one card, one
process each); the stream is read from this checkout's data directory.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# job rows (ops/ipred.py columns): dy, dx, w, h, have_left, have_top,
# left, bottom-left, top, top-right extents, angle key, Z2 max_w / max_h,
# Z2 top-left filter, mode, and the kind
UNITS = {
    "pal 4x4": ([64, 64, 4, 4, 0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8], 2),
    "pred DC_128 4x4": ([64, 64, 4, 4, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 5, 0],
                        0),
    "pred DC 4x4": ([64, 64, 4, 4, 1, 1, 4, 0, 4, 0, 0, 0, 0, 0, 0, 0], 0),
    "pred DC 16x16": ([64, 64, 16, 16, 1, 1, 16, 0, 16, 0, 0, 0, 0, 0, 0,
                       0], 0),
    "pred DC 64x64": ([64, 64, 64, 64, 1, 1, 64, 0, 64, 0, 0, 0, 0, 0, 0,
                       0], 0),
    "pred SMOOTH 16x16": ([64, 64, 16, 16, 1, 1, 16, 0, 16, 0, 0, 0, 0, 0, 9,
                           0], 0),
    "pred SMOOTH 64x64": ([64, 64, 64, 64, 1, 1, 64, 0, 64, 0, 0, 0, 0, 0, 9,
                           0], 0),
    "pred Z1 16x16 filtered": ([64, 64, 16, 16, 1, 1, 16, 16, 16, 16,
                                45 | 1024, 0, 0, 0, 6, 0], 0),
    "pred Z2 32x32 filtered": ([64, 64, 32, 32, 1, 1, 32, 0, 32, 0,
                                135 | 1024, 32, 32, 1, 7, 0], 0),
    "pred FILTER 32x32": ([64, 64, 32, 32, 1, 1, 32, 0, 32, 0, 0, 0, 0, 0,
                           13, 0], 0),
    "cfl DC 32x32": ([64, 64, 32, 32, 1, 1, 32, 0, 32, 0, 0, 0, 5, 0, 0, 0],
                     1),
    "pal 64x64": ([64, 64, 64, 64, 0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8], 2),
}


def unit_level_us(cs, device, levels=1024):
    """Device us a level of a walk of one unit a level, for each of
    UNITS."""
    import numpy as np
    import torch

    from dav1d_tpu_torch.ops import ipred as oip

    rng = np.random.default_rng(0)
    canvas = torch.from_numpy(rng.integers(0, 256, (256, 256)).astype(
        np.int32)).to(device)
    resid = torch.from_numpy(rng.integers(-64, 64, (256, 256)).astype(
        np.int32)).to(device)
    pidx = torch.from_numpy(rng.integers(0, 8, 4096).astype(np.uint8)).to(
        device)
    out = {}
    for name, (row, kind) in UNITS.items():
        J = np.tile(np.asarray(row, np.int32), (levels, 1))
        T = (np.arange(levels, dtype=np.int32) << 2) | kind
        C = np.ones(levels, np.int32)
        args = (canvas, canvas, resid, *(torch.from_numpy(a).to(device)
                                         for a in (J, T, C)),
                pidx, 256, 1, 1, 8)
        kfn = functools.partial(oip.walk, max_ctas=oip.walk_ctas(C))
        ms, _ = cs.launch_ms(kfn, args, reps=5)
        out[name] = ms / levels * 1e3
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--stream", default="inter_1080p_8bit.ivf")
    ap.add_argument("--tree", type=Path, default=ROOT)
    opt = ap.parse_args()
    sys.path.insert(0, str(opt.tree.resolve()))
    import chip_smoke as cs

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    data = (ROOT / "dav1d_tpu_torch" / "data" / opt.stream).read_bytes()
    cs.decode(data, device, hashing=False, device_intra=True)  # build
    with cs.FrameLog(keep_walks=True) as log:
        cs.decode(data, device, hashing=False, device_intra=True)
    key = next(fr for fr in log.intra if fr["walks"])
    walks = cs.key_frame_walks(key["walks"], reps=3)
    units = unit_level_us(cs, device)
    report = {"tree": str(opt.tree), "stream": opt.stream,
              "card": torch.cuda.get_device_name(0),
              "key_frame_walks": walks, "unit_level_us": units}
    for w in walks:
        print(f"chain {w['chain']}: {w['levels']} levels, {w['units']} "
              f"units: walk {w['walk_device_ms']:.4f} ms "
              f"({w['walk_device_ms'] / w['levels'] * 1e3:.3f} us a level), "
              f"per-level kernels back to back {w['levels_device_ms']:.4f}"
              " ms")
    for name, us in units.items():
        print(f"  a level of one {name}: {us:.3f} us")
    print(json.dumps(report))
    assert not cs._jax_modules()
    return 0


if __name__ == "__main__":
    sys.exit(main())
