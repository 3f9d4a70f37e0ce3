"""Where the time goes in a dav1d_tpu_torch decode on a CUDA card.

Decodes a committed stream (dav1d_tpu_torch/data/; default the 1080p
inter stream) once to warm up, once with the stage spans and transfer
counters on, then once under torch.profiler (CPU + CUDA activity), and
prints:

* the stage spans (host ms per frame) and the bytes uploaded and
  downloaded per frame;
* wall ms per frame of the profiled decode;
* device time per kernel / memcpy name (self device time, summed), per
  frame and per call;
* the device's busy share: summed device time over the decode's wall
  time (kernels and copies may overlap each other, so this is an upper
  bound of the busy share, and 1 minus it a lower bound of the idle
  share).

Like chip_smoke.py it fails if the decode imported jax.  Run from the
repository root; with a path argument the chrome trace is written there:

    python3 tools/torch_decode_profile.py [--stream NAME] [--tree DIR]
        [--device-intra] [trace.json]

``--tree DIR``: decode with the package and chip_smoke.py of another
checkout (an unpacked parent commit, to compare two versions on one
card); the stream is still read from this checkout's data directory.
``--device-intra``: decode with ``Decoder(..., device_intra=True)``.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--stream", default="inter_1080p_8bit.ivf")
    ap.add_argument("--tree", type=Path, default=ROOT)
    ap.add_argument("--device-intra", action="store_true")
    ap.add_argument("trace", nargs="?")
    opt = ap.parse_args()
    sys.path.insert(0, str(opt.tree.resolve()))
    import chip_smoke

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from dav1d_tpu_torch import devrt

    print(f"tree {opt.tree}, stream {opt.stream}"
          f"{', device intra' if opt.device_intra else ''}")
    device = torch.device("cuda", 0)
    data = (ROOT / "dav1d_tpu_torch" / "data" / opt.stream).read_bytes()
    kw = {"device_intra": True} if opt.device_intra else {}
    chip_smoke.decode(data, device, hashing=False, **kw)  # warm-up + build
    devrt.SPANS, devrt.XFER = {}, {"up": 0, "down": 0}
    n, _, _ = chip_smoke.decode(data, device, hashing=False, **kw)
    stages = {k: round(v * 1e3 / n, 3) for k, v in sorted(devrt.SPANS.items())}
    print(f"stages (host ms per frame): {stages}")
    print(f"bytes per frame: upload {devrt.XFER['up'] // n}, download "
          f"{devrt.XFER['down'] // n}")
    devrt.SPANS = devrt.XFER = None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n, _, _ = chip_smoke.decode(data, device, hashing=False, **kw)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    if opt.trace:
        Path(opt.trace).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(opt.trace)

    from torch.autograd import DeviceType

    rows = []
    for evt in prof.key_averages():
        # device-side activities only (kernels, memcpys): a CPU op's
        # device time repeats the activities it launched
        if evt.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, evt.count, evt.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    print(f"profiled decode: {n} frames, wall {wall_us / n / 1e3:.3f} "
          f"ms/frame")
    for dev_us, count, key in rows[:25]:
        print(f"  {dev_us / n / 1e3:9.4f} ms/frame  {count:5d} calls  "
              f"{dev_us / count / 1e3:9.4f} ms/call  {key[:80]}")
    print(f"device time {total / n / 1e3:.4f} ms/frame; busy share <= "
          f"{total / wall_us:.4f} of the decode wall time")
    assert not chip_smoke._jax_modules()
    return 0


if __name__ == "__main__":
    sys.exit(main())
