#!/usr/bin/env python3
"""GPU smoke run of dav1d_tpu_torch, the PyTorch/CUDA port of the
decoder, on one CUDA card.

Run from the root of a checkout, on a machine with a CUDA GPU, PyTorch
built for CUDA and nvcc (no libaom, no network needed):

    python3 chip_smoke.py

The port never imports jax, even where jax is installed: it consults
no part of the JAX package that picks jax device tiers, so only the
port's kernels touch the card.  The run fails if jax was imported.

Phases; any failure exits non-zero:

1. print the card's name and power limit (nvidia-smi);
2. build the port's kernels from csrc/ (nvcc, sm_90a);
3. hold each kernel against its plain PyTorch version on the card,
   exactly, at the decoder's 1080p shapes (4:2:0 luma and chroma planes,
   random edge/unit maps with every class present), bit depths 8/10/12;
4. decode the committed 1080p 8-bit inter stream (the main path) and the
   committed 10-bit stream with ``Decoder(..., device="cuda")`` through
   send_data/get_picture, and check the md5 of every output plane
   against the committed md5 (the JAX package's host tier).  The launch
   counts are zeroed just before the 1080p decode and read just after:
   every kernel must have launched at least once per frame;
5. time the 1080p decode (frames/s, best of 3 after the warm-up decode)
   and each kernel against its plain version (CUDA events, in turns
   plain, kernel, kernel, plain).

The line before the last is the kernels' JSON report; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import hashlib
import json
import struct
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DATA = ROOT / "dav1d_tpu_torch" / "data"
MAIN_STREAM = "inter_1080p_8bit.ivf"
HBD_STREAM = "hbd10_128x96.ivf"

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
}


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


def _spikes(rng, H, W, bitdepth):
    """A flat plane with sparse small bright spikes: under strong CDEF
    strengths the filter overshoots and the [min, max] clip bites, also
    next to the plane edge where sentinel taps must not lower the min."""
    import numpy as np

    return ((128 + 4 * (rng.random((H, W)) < 0.1)) << (bitdepth - 8)) \
        .astype(np.int32)


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


def make_cases(device, shapes=SHAPES, seed=0):
    """Kernel inputs at the main path's shapes for bit depths 8/10/12:
    {kernel: [(label, kernel_fn, plain_fn, args), ...]}."""
    import numpy as np
    import torch

    from dav1d_tpu_torch.ops import cdef as ocdef
    from dav1d_tpu_torch.ops import lf as olf

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
            cases["cdef_filter"].append((
                f"{plane_kind} spikes bd{bd}", ocdef.filter_plane,
                ocdef.filter_plane_plain,
                (dev(_spikes(rng, H, W, bd)), *strong, *dmaps, ph, pw, w, h,
                 damping, bd, luma, False)))
    return cases


def _max_abs_err(a, b):
    import torch

    if isinstance(a, tuple):
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

def read_ivf(data):
    """Temporal units of an IVF file (32-byte header, then 12-byte frame
    headers: size, pts)."""
    _require(data[:4] == b"DKIF", "not an IVF file")
    pos = struct.unpack_from("<H", data, 6)[0]
    while pos + 12 <= len(data):
        size = struct.unpack_from("<I", data, pos)[0]
        yield data[pos + 12:pos + 12 + size]
        pos += 12 + size


def decode(data, device, hashing=True):
    """Decode an IVF stream with the port's public API; returns
    (frames, md5 over every plane of every picture)."""
    from dav1d_tpu_torch.decoder import Decoder, Settings

    dec = Decoder(Settings(two_pass=True, max_frame_delay=4), device=device)
    h = hashlib.md5()
    n = 0
    for tu in read_ivf(data):
        dec.send_data(tu)
        while (pic := dec.get_picture()) is not None:
            if hashing:
                for pl in range(len(pic.planes)):
                    h.update(pic.plane_bytes(pl))
            n += 1
    dec.close()
    return n, h.hexdigest()


def decode_checked(name, device):
    want = json.loads((DATA / "md5.json").read_text())[name]
    n, md5 = decode((DATA / name).read_bytes(), device)
    print(f"  {name}: {n} frames md5 {md5} (want {want['md5']})",
          flush=True)
    _require((n, md5) == (want["frames"], want["md5"]),
             f"{name}: decoded {n} frames md5 {md5}, want "
             f"{want['frames']} frames md5 {want['md5']}")
    return n


# ---- timing ------------------------------------------------------------

def cuda_ms(fn, reps=20):
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def time_kernels(cases):
    """ms per call of each kernel and its plain version at the 8-bit
    1080p luma case, in turns plain, kernel, kernel, plain (best of
    two each)."""
    out = {}
    for name, items in cases.items():
        label, kfn, pfn, args = items[0]
        times = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            fn = kfn if which == "kernel" else pfn
            times[which].append(cuda_ms(lambda: fn(*args)))
        out[name] = (min(times["kernel"]), min(times["plain"]), label)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SmokeError("CUDA is not available: the smoke run needs a GPU")
    _require((ROOT / "dav1d_tpu_torch").is_dir() and DATA.is_dir(),
             f"no dav1d_tpu_torch package beside {Path(__file__).name}: "
             "run from a checkout of the repository")
    _require(not _jax_modules(), f"jax already imported: {_jax_modules()}")
    sys.path.insert(0, str(ROOT))
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

    t0 = time.perf_counter()
    so = build.build()
    build.lib()
    print(f"  {so.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in build.build_log().splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print("  ptxas:", line.strip(), flush=True)

    print("== 3. kernels vs plain versions on the card (exact)",
          flush=True)
    cases = make_cases(device)
    errs = compare_kernels(cases, torch.cuda.synchronize)

    print("== 4. decode through Decoder(device='cuda')", flush=True)
    data = (DATA / MAIN_STREAM).read_bytes()
    devrt.LAUNCHES.clear()
    nframes = decode_checked(MAIN_STREAM, device)
    launches = {k: devrt.LAUNCHES[k] for k in KERNELS}
    print(f"  launches in the {MAIN_STREAM} decode: {launches}", flush=True)
    for k, n in launches.items():
        _require(n >= nframes, f"{k}: {n} launches over {nframes} frames")
    devrt.LAUNCHES.clear()
    decode_checked(HBD_STREAM, device)
    hbd = {k: devrt.LAUNCHES[k] for k in KERNELS}
    print(f"  launches in the {HBD_STREAM} decode: {hbd}", flush=True)
    _require(hbd["cdef_filter"] > 0, "10-bit decode ran no CDEF kernel")

    print("== 5. timing", flush=True)
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        n, _ = decode(data, device, hashing=False)
        runs.append(n / (time.perf_counter() - t0))
    fps = max(runs)
    print(f"  {MAIN_STREAM}: {fps:.3f} frames/s (best of 3 after the "
          f"warm-up decode; runs {[round(r, 3) for r in runs]}) on "
          f"{card}", flush=True)
    # one more decode with the stage spans and transfer counters on
    devrt.SPANS, devrt.XFER = {}, {"up": 0, "down": 0}
    t0 = time.perf_counter()
    n, _ = decode(data, device, hashing=False)
    wall = time.perf_counter() - t0
    spans, xfer = devrt.SPANS, devrt.XFER
    devrt.SPANS = devrt.XFER = None
    stages = {k: round(v * 1e3 / n, 3) for k, v in sorted(spans.items())}
    print(f"  per frame: wall {wall * 1e3 / n:.3f} ms, stages (ms) "
          f"{stages}, upload {xfer['up'] // n} B, download "
          f"{xfer['down'] // n} B", flush=True)
    times = time_kernels(cases)
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        ms, plain_ms, label = times[name]
        print(f"  {name:12s} {label}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms", flush=True)
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": errs[name], "ms": ms,
                        "plain_ms": plain_ms})
    _require(not _jax_modules(), f"jax was imported: {_jax_modules()}")
    print(json.dumps({"decode_fps": fps, "decode_fps_runs": runs,
                      "stage_ms_per_frame": stages, "stream": MAIN_STREAM,
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
