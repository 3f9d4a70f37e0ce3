"""Multi-device scaling of the port's mesh decode (the JAX package's
tools/scaling_bench.py for ``mesh.Mesh``).

A. Correctness and decomposition: a committed stream decoded with
   ``Settings(two_pass=True, mesh=Mesh([device] * n))`` for each n must
   be byte-equal to the one-device decode (no mesh).  Per n: the rows of
   a band in each plane, the halo bytes the bands received and the band
   work (``devrt.COUNTS["halo_bytes"]``, ``mesh_*``) per frame, the
   kernel launches per band per frame, and the host wall frames/s (bands
   on one device share it: an overhead figure, not scaling).
B. Kernel time at full size and at the 1/n share: every call of the band
   kernels (K1 on a band, K5 on a luma band, K2's band form, an itx
   share, a restoration share) that a mesh decode made, replayed and
   timed with CUDA events (the host clock on the CPU), beside the calls
   of the one-device decode.  Per kernel and n: ms per frame of the
   whole-plane calls, the mean share (the n-band total over n) and
   ``efficiency = t(full) / (n * t(share))``.
C. Bytes between bands per frame: from the geometry (every boundary
   between bands with filtered rows, in every plane: deblock's 8
   post-vertical rows and 8 written rows each way, CDEF's 2 rows each
   way, int32 pixels), beside the halo bytes counted in A and the bytes
   the mesh moved between devices (``devrt.XFER["mesh"]``: 0 when the
   bands share one device).

The JAX tool's link-rate bound (a TPU interconnect figure) and its
resumable timing loop have no counterpart here.

    python -m dav1d_tpu_torch.scaling [--part A|B] [--reps N]
        [--device cpu] [--json OUT]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

import torch

from . import devrt

DATA = Path(__file__).resolve().parent / "data"
MAIN_STREAM = "inter_1080p_8bit.ivf"
LR_STREAM = "lr_1080p_8bit.ivf"
BANDS = (1, 2, 4, 8)
# the calls part B times: a band kernel's tag and what it is called by
FAMILIES = ("deblock_v", "deblock_h", "cdef_dir", "cdef_filter", "itx",
            "lr_wiener", "lr_sgr")
# rows a boundary between two bands sends, per plane (module docstring)
DEBLOCK_ROWS = 32
CDEF_ROWS = 4


def _mesh(device, bands):
    from .mesh import Mesh

    return Mesh([device] * bands) if bands else None


def _decode(data, device, bands):
    """(frames, md5 over every plane of every picture, the allocation
    shape of each plane) of a decode with a mesh of ``bands`` bands on
    ``device`` (0: no mesh)."""
    from .containers import read_ivf
    from .decoder import Decoder, Settings

    dec = Decoder(Settings(two_pass=True, max_frame_delay=4,
                           mesh=_mesh(device, bands)), device=device)
    h = hashlib.md5()
    n = 0
    for tu, _ in read_ivf(data):
        dec.send_data(tu)
        while (pic := dec.get_picture()) is not None:
            n += 1
            for pl in range(len(pic.planes)):
                h.update(pic.plane_bytes(pl))
    slot = next(s for s in dec.refs if s.planes is not None)
    shapes = [tuple(p.shape) for p in slot.planes]
    dec.close()
    return n, h.hexdigest(), shapes


def _geometry(meta, shapes, mesh):
    """Per plane: the filtered rows, the rows of a band and the bands
    with filtered rows, for a mesh of ``mesh.n`` bands."""
    rows8 = -(-meta["height"] // 8) * 8
    out = []
    for pl, (_, w) in enumerate(shapes):
        ph = rows8 >> (pl and shapes[pl][0] < shapes[0][0])
        bh = mesh.band_rows(ph)
        out.append({"plane": pl, "filtered_rows": ph, "band_rows": bh,
                    "live_bands": min(mesh.n, -(-ph // bh)), "width": w})
    return out


def part_a(name=MAIN_STREAM, bands=BANDS, device="cuda") -> dict:
    """Byte equality and the decomposition per band count (module
    docstring, A and C)."""
    dev = devrt.resolve_device(device)
    data = (DATA / name).read_bytes()
    meta = json.loads((DATA / "md5.json").read_text())[name]
    n_ref, ref, shapes = _decode(data, dev, 0)
    runs, equal = [], True
    for n in bands:
        devrt.LAUNCHES.clear()
        devrt.COUNTS.clear()
        saved, devrt.XFER = devrt.XFER, {"up": 0, "down": 0, "mesh": 0}
        t0 = time.perf_counter()
        try:
            nn, got, _ = _decode(data, dev, n)
        finally:
            wall = time.perf_counter() - t0
            xfer, devrt.XFER = devrt.XFER, saved
        same = (nn, got) == (n_ref, ref)
        equal &= same
        geo = _geometry(meta, shapes, _mesh(dev, n))
        model = sum(4 * w * (DEBLOCK_ROWS + CDEF_ROWS) * (g["live_bands"] - 1)
                    for g, (_, w) in zip(geo, shapes))
        runs.append({
            "bands": n, "byte_equal": same, "frames": nn, "md5": got,
            "wall_fps": nn / wall, "planes": geo,
            "halo_bytes_per_frame": devrt.COUNTS["halo_bytes"] / nn,
            "band_work_per_frame": {k: v / nn for k, v in
                                    sorted(devrt.COUNTS.items())
                                    if k.startswith("mesh_")},
            "launches_per_band_per_frame": {
                k: v / nn / n for k, v in sorted(devrt.LAUNCHES.items())},
            "bytes_between_bands_per_frame": {
                "geometry": model, "halo_counted":
                devrt.COUNTS["halo_bytes"] / nn,
                "moved_between_devices": xfer["mesh"] / nn}})
    return {"part": "A", "stream": name, "device": str(dev),
            "frames": n_ref, "md5": ref, "byte_equal_all": equal,
            "runs": runs,
            "note": "wall_fps with n bands on one device measures what "
                    "the band work costs there, not scaling"}


def _family(tag, args):
    if tag == "deblock":
        return "deblock_v" if args[2] else "deblock_h"
    return tag


def _calls(data, device, bands):
    """(frames, [(family, fn, args, kw)]) of the band kernels' calls in
    one decode."""
    saved, devrt.SINK = devrt.SINK, []
    try:
        n, _, _ = _decode(data, device, bands)
        sink = devrt.SINK
    finally:
        devrt.SINK = saved
    return n, [(_family(tag, a), fn, a,
                {k: v for k, v in kw.items() if k != "out"})
               for tag, fn, a, kw in sink if _family(tag, a) in FAMILIES]


def _wrapper_ms(fn, args, kw, device, reps):
    """ms of one call of ``fn(*args, **kw)``, host work included: the
    mean of ``reps`` calls after a warm-up, by CUDA events on a CUDA
    device, by the host clock on the CPU."""
    fn(*args, **kw)
    if device.type == "cuda":
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        t0.record()
        for _ in range(reps):
            fn(*args, **kw)
        t1.record()
        torch.cuda.synchronize(device)
        return t0.elapsed_time(t1) / reps
    t = time.perf_counter()
    for _ in range(reps):
        fn(*args, **kw)
    return (time.perf_counter() - t) * 1e3 / reps


def _device_ms(fn, args, kw, device, reps):
    """Device ms of the kernel launches of one call of ``fn(*args,
    **kw)``: one call captures its launches (``devrt.CAPTURE``), then
    ``reps`` repeats of the bare C calls run back to back behind a spin
    kernel (``devrt.replay_ms``).  None on the CPU, where the wrappers
    launch nothing."""
    if device.type != "cuda":
        return None
    devrt.CAPTURE = []
    try:
        kept = fn(*args, **kw)  # noqa: F841 (its buffers stay alive)
        captured = devrt.CAPTURE
    finally:
        devrt.CAPTURE = None
    return devrt.replay_ms(captured, reps)[0]


def _timed(data, device, bands, reps):
    """{kernel: {"calls", "wrapper_ms", "device_ms"}} of one decode's band
    calls, the times per frame (device_ms None on the CPU)."""
    n, calls = _calls(data, device, bands)
    out = {}
    for fam, fn, args, kw in calls:
        wrapper = _wrapper_ms(fn, args, kw, device, reps)
        dev = _device_ms(fn, args, kw, device, reps)
        keys = (fam,)
        if fam == "cdef_filter" and (args[13] or args[14]):
            # K2's band form: a call with halo rows (top / bottom); the
            # first luma band (no top halo) also on its own
            keys += ("cdef_filter_band",)
            if args[11] and not args[13]:
                keys += ("cdef_filter_band_luma0",)
        for key in keys:
            row = out.setdefault(key, {"calls": 0, "wrapper_ms": 0.0,
                                       "device_ms": 0.0, "call_ms": 0.0,
                                       "rows": int(args[0].shape[0])})
            row["calls"] += 1
            row["wrapper_ms"] += wrapper / n
            if dev is None:
                row["device_ms"] = row["call_ms"] = None
            else:
                row["device_ms"] += dev / n
                row["call_ms"] += dev
    for row in out.values():
        if row["call_ms"] is not None:
            row["call_ms"] /= row["calls"]
    return out


def _ratio(full, share, n):
    return full / (n * share) if full is not None and share else None


def part_b(names=(MAIN_STREAM, LR_STREAM), bands=(1, 2, 4), device="cuda",
           reps=10) -> dict:
    """Kernel time of the whole-plane calls and of the 1/n shares
    (module docstring, B).  Per stream, kernel and band count: the calls,
    device and wrapper ms per frame of the one-device decode's calls
    (``full_*``) and of the mean share (the n-band total over n,
    ``share_*``), the device ms a call (``device_ms_per_call``; for K2's
    band form also the first luma band's, ``luma_band0``), and
    ``efficiency`` = full / (n * share) on device time
    (``wrapper_efficiency`` on wrapper time, which holds the host's work
    a call)."""
    dev = devrt.resolve_device(device)
    rows = []
    for name in names:
        data = (DATA / name).read_bytes()
        full = _timed(data, dev, 0, reps)
        for n in bands:
            share = _timed(data, dev, n, reps)
            for fam in FAMILIES + ("cdef_filter_band",):
                if fam not in share:
                    continue
                s = share[fam]
                f = full.get("cdef_filter" if fam == "cdef_filter_band"
                             else fam, {})
                s_dev = None if s["device_ms"] is None else \
                    s["device_ms"] / n
                s_wr = s["wrapper_ms"] / n
                row = {"stream": name, "kernel": fam, "bands": n,
                       "calls": s["calls"], "full_calls": f.get("calls"),
                       "device_ms_per_call": s["call_ms"],
                       "full_device_ms_per_frame": f.get("device_ms"),
                       "share_device_ms_per_frame": s_dev,
                       "full_wrapper_ms_per_frame": f.get("wrapper_ms"),
                       "share_wrapper_ms_per_frame": s_wr,
                       "efficiency": _ratio(f.get("device_ms"), s_dev, n),
                       "wrapper_efficiency": _ratio(f.get("wrapper_ms"),
                                                    s_wr, n)}
                if fam == "cdef_filter_band" and \
                        "cdef_filter_band_luma0" in share:
                    # the first luma band's call alone (its rows with the
                    # bottom halo), as the kernel table's bound counts it
                    l0 = share["cdef_filter_band_luma0"]
                    row["luma_band0"] = {"rows": l0["rows"],
                                         "calls": l0["calls"],
                                         "device_ms_per_call": l0["call_ms"]}
                rows.append(row)
    return {"part": "B", "device": str(dev), "clock":
            "cuda events" if dev.type == "cuda" else "host",
            "reps": reps, "rows": rows,
            "note": "efficiency(n) = t(full) / (n * t(share)), t(share) "
                    "the n-band total over n, on device time; the bands "
                    "of one device run one after another"}


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m dav1d_tpu_torch.scaling")
    p.add_argument("--part", choices=["A", "B"], default=None,
                   help="one part (default: A, then B)")
    p.add_argument("--json", default=None)
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    try:
        devrt.resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"dav1d_tpu: {e}", file=sys.stderr)
        return 1
    res = {}
    if args.part in ("A", None):
        res["A"] = part_a(device=args.device)
        if not res["A"]["byte_equal_all"]:
            print(json.dumps(res))
            print("scaling: a mesh decode differs from the one-device "
                  "decode", file=sys.stderr)
            return 1
    if args.part in ("B", None):
        res["B"] = part_b(device=args.device, reps=args.reps)
    print(json.dumps(res))
    if args.json:
        Path(args.json).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
