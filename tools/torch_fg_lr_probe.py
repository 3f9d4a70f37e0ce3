"""Device time of the film-grain (fg) and Wiener (lr_wiener) kernels of a
dav1d_tpu_torch tree on a CUDA card, on the calls of its own decodes.

Decodes grain_1080p_8bit.ivf and the two 1080p restoration streams
(superres_lr_1080p_8bit.ivf, lr_1080p_8bit.ivf) with the package of
``--tree`` (default: this checkout), recording each fg / lr_wiener call,
and prints one JSON line per tree with ``copy_floor_ms``, the device
time of a plain device-to-device copy of a 1080p luma plane's bytes,
and for each kernel:

* ``launch_ms``: device ms per bare launch of the C entry point on the
  call chip_smoke.py times (the largest grained plane; the Wiener call
  with the most units), ``reps`` launches queued behind a spin kernel
  and timed with CUDA events; ``launch_ms_chroma``: the same on the
  largest grained chroma plane;
* ``per_frame_ms``: every call of the decode launched again back to back
  behind a spin kernel, device ms per picture (fg) or per frame
  (lr_wiener, each stream).

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
    passes queued behind a spin kernel."""
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
    report = {"tree": str(opt.tree), "card": torch.cuda.get_device_name(0),
              "copy_floor_ms": _copy_ms(torch, device, opt.reps)}
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
    report["lr_wiener"] = {}
    for stream in LR_STREAMS:
        n, calls = _calls(chip_smoke, devrt, stream, device, "lr_wiener")
        big = max(range(len(calls)), key=lambda i: calls[i][1][2].shape[0])
        rep = {"calls": len(calls), "frames": n,
               "timed_units": int(calls[big][1][2].shape[0]),
               **_measure(torch, devrt, calls, n, {"": big}, opt.reps)}
        report["lr_wiener"][stream] = rep
    report["seconds"] = time.perf_counter() - t0
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
