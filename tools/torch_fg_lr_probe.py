"""Device time of the film-grain (fg), Wiener (lr_wiener), self-guided
(lr_sgr) and super-res (resize) kernels of a dav1d_tpu_torch tree on a
CUDA card, on the calls of its own decodes.

Decodes grain_1080p_8bit.ivf and the two 1080p restoration streams
(superres_lr_1080p_8bit.ivf, lr_1080p_8bit.ivf) with the package of
``--tree`` (default: this checkout), recording each fg / lr_wiener /
lr_sgr / resize call, and prints one JSON line per tree with
``copy_floor_ms``, the device time of a plain device-to-device copy of a
1080p luma plane's bytes, ``empty_launch_ms``, an empty kernel's launch
(where the tree has one: ``kernels.build.empty_launch``), and for each
kernel:

* ``launch_ms``: device ms per bare launch of the C entry point on the
  call chip_smoke.py times (the largest grained plane; the Wiener or
  self-guided call with the most units), ``reps`` launches queued behind
  a spin kernel and timed with CUDA events; ``launch_ms_chroma``: the
  same on the largest grained chroma plane; for resize
  ``launch_ms_luma``, the super-res decode's first luma plane alone
  (``ops.resize.resize_plane``, in every tree), ``launch_ms_frame``, the
  decode's call with the most planes (the frame's six in one launch where
  the tree batches them), and ``launch_ms_denominator_9``, a 1080p luma
  plane coded 1712 wide;
* ``per_frame_ms``: every call of the decode launched again back to back
  behind a spin kernel, device ms per picture (fg) or per frame
  (lr_wiener, lr_sgr, resize; each stream).

Run from the repository root on the machine with the card:

    python3 tools/torch_fg_lr_probe.py [--tree DIR] [--reps N]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FG_STREAM = "grain_1080p_8bit.ivf"
LR_STREAMS = ("superres_lr_1080p_8bit.ivf", "lr_1080p_8bit.ivf")


def _captured(devrt, fn, args, kw):
    """Call the wrapper once with launch capture on: (its result, the C
    entry point, its arguments)."""
    devrt.CAPTURE = []
    try:
        out = fn(*args, **kw)
        cap = devrt.CAPTURE
    finally:
        devrt.CAPTURE = None
    if len(cap) != 1:
        raise RuntimeError(f"{len(cap)} launches captured")
    return out, cap[0][1], cap[0][2]


def _back_to_back_ms(torch, launches, reps):
    """Device ms of one pass over ``launches`` [(cfn, cargs)], ``reps``
    passes queued behind a spin kernel.  The probe's own timer, not the
    package's ``devrt.replay_ms``: the trees it compares are timed
    alike, whatever each tree's package holds."""
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(20_000_000)
    e0.record()
    for _ in range(reps):
        for cfn, cargs in launches:
            rc = cfn(*cargs)
            if rc:
                raise RuntimeError(f"launch failed: {rc}")
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _copy_ms(torch, device, reps):
    """Device ms of a copy of a 1080 x 1920 int32 plane (8.3 MB read,
    8.3 MB written: the bytes of a 1080p luma grain plane), the same way:
    back to back behind a spin kernel."""
    src = torch.zeros((1080, 1920), dtype=torch.int32, device=device)
    dst = torch.empty_like(src)
    dst.copy_(src)
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    best = float("inf")
    for _ in range(3):
        torch.cuda._sleep(20_000_000)
        e0.record()
        for _ in range(reps):
            dst.copy_(src)
        e1.record()
        torch.cuda.synchronize()
        best = min(best, e0.elapsed_time(e1) / reps)
    return best


def _calls(chip_smoke, devrt, stream, device, tag):
    """(frames, [(fn, args, kw)] of ``tag``) of one decode of ``stream``."""
    data = (ROOT / "dav1d_tpu_torch" / "data" / stream).read_bytes()
    devrt.SINK = []
    try:
        n, _, _ = chip_smoke.decode(data, device, hashing=False)
        sink = devrt.SINK
    finally:
        devrt.SINK = None
    return n, [(fn, args, kw) for t, fn, args, kw in sink if t == tag]


def _measure(torch, devrt, calls, n, timed, reps):
    """launch_ms on each call of ``timed`` {name: index} and device ms per
    frame of all ``calls`` over ``n`` frames."""
    launches, keep = [], []
    for fn, args, kw in calls:
        out, cfn, cargs = _captured(devrt, fn, args, kw)
        keep.append(out)
        launches.append((cfn, cargs))
    out = {f"launch_ms{name}": min(
        _back_to_back_ms(torch, [launches[i]], reps) for _ in range(3))
        for name, i in timed.items()}
    out["per_frame_ms"] = min(_back_to_back_ms(torch, launches, 3)
                              for _ in range(3)) / n
    return out


def _resize(torch, devrt, chip_smoke, device, reps):
    """The resize calls of the super-res decode (per frame, the frame
    call, its first luma plane alone) and a denominator-9 luma plane."""
    from types import SimpleNamespace

    import numpy as np

    from dav1d_tpu_torch.decode.frame import superres_geometry
    from dav1d_tpu_torch.ops import resize as oresize

    n, calls = _calls(chip_smoke, devrt, LR_STREAMS[0], device, "resize")

    def planes(c):  # (planes, geometries, bitdepth) of a recorded call
        fn, args, _ = c
        if isinstance(args[0], (list, tuple)):
            return list(args[0]), list(args[1]), args[2]
        return [args[0]], [tuple(args[1:7])], args[7]

    frame = max(range(len(calls)), key=lambda i: len(planes(calls[i])[0]))
    ps, gs, bd = planes(calls[0])
    hdr = SimpleNamespace(width=((1920 * 8 + 4) // 9, 1920), height=1080)
    f9 = SimpleNamespace(frame_hdr=hdr, ss_hor=1, ss_ver=1,
                         bw=((hdr.width[0] + 7) >> 3) << 1)
    g9 = superres_geometry(f9, 0)
    rng = np.random.default_rng(9)
    p9 = torch.from_numpy(rng.integers(0, 256, (1088, (g9[1] + 63) & ~63))
                          .astype(np.int32)).to(device)
    extra = [(oresize.resize_plane, (ps[0], *gs[0], bd), {}),
             (oresize.resize_plane, (p9, *g9, 8), {})]
    rep = {"calls": len(calls), "frames": n,
           "frame_call_planes": len(planes(calls[frame])[0]),
           **_measure(torch, devrt, calls, n, {"_frame": frame}, reps)}
    rep.update({k: v for k, v in _measure(
        torch, devrt, extra, 1, {"_luma": 0, "_denominator_9": 1},
        reps).items() if k != "per_frame_ms"})
    return rep


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", type=Path, default=ROOT)
    ap.add_argument("--reps", type=int, default=20)
    opt = ap.parse_args()
    sys.path.insert(0, str(opt.tree.resolve()))
    import chip_smoke
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from dav1d_tpu_torch import devrt

    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    from dav1d_tpu_torch.kernels import build

    report = {"tree": str(opt.tree), "card": torch.cuda.get_device_name(0),
              "copy_floor_ms": _copy_ms(torch, device, opt.reps)}
    if hasattr(build, "empty_launch"):
        t = torch.empty(1, device=device)
        report["empty_launch_ms"] = _measure(
            torch, devrt, [(build.empty_launch, (t,), {})], 1, {"": 0},
            opt.reps)["launch_ms"]
    n, calls = _calls(chip_smoke, devrt, FG_STREAM, device, "fg")
    # the largest luma and chroma planes (args: ..., w, h, lw, params)
    timed = {tag: max((i for i, c in enumerate(calls)
                       if bool(c[1][8].pl) == chroma),
                      key=lambda i: calls[i][1][5] * calls[i][1][6])
             for tag, chroma in (("", False), ("_chroma", True))}
    report["fg"] = {"calls": len(calls), "pictures": n,
                    "timed": {k: f"{calls[i][1][5]}x{calls[i][1][6]}"
                              for k, i in timed.items()},
                    **_measure(torch, devrt, calls, n, timed, opt.reps)}
    for tag in ("lr_wiener", "lr_sgr"):
        report[tag] = {}
        for stream in LR_STREAMS:
            n, calls = _calls(chip_smoke, devrt, stream, device, tag)
            if not calls:
                continue
            big = max(range(len(calls)),
                      key=lambda i: calls[i][1][2].shape[0])
            rep = {"calls": len(calls), "frames": n,
                   "timed_units": int(calls[big][1][2].shape[0]),
                   **_measure(torch, devrt, calls, n, {"": big}, opt.reps)}
            report[tag][stream] = rep
    report["resize"] = _resize(torch, devrt, chip_smoke, device, opt.reps)
    report["seconds"] = time.perf_counter() - t0
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
