"""The fused-step entry points of the port (the JAX package's
__graft_entry__.py over the port's kernels).

entry(device)            — the fused reconstruction step (the device side
                           of pass 2) over a superblock batch: batched
                           8-tap motion compensation (K3, ops/mc), a
                           16x16 DCT_DCT inverse transform per block (K4,
                           ops/itx), then the residual add and clip.
dryrun_multichip(n, dev) — the same step cut into ``n`` shares over a
                           ``mesh.Mesh([dev] * n)`` (bands on one card,
                           repeats allowed), equal to the single call;
                           and a multi-tile stream decoded with that mesh,
                           equal to the one-device decode.

On CPU tensors both kernels' wrappers run their plain versions; on CUDA
tensors they launch the kernels.  The device defaults to ``cuda``, and
asking for it without CUDA raises.

    python -m dav1d_tpu_torch.entry [--device cpu]

runs the step on the device against its plain version on the CPU, then
``dryrun_multichip`` with 2 and 4 bands.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

from . import devrt
from .levels import TxfmType
from .ops import itx as oitx
from .ops import mc as omc

_TX_16X16 = 2
_BITDEPTH = 8
DATA = Path(__file__).resolve().parent / "data"
DRYRUN_BANDS = (2, 4)
# __graft_entry__.dryrun_multichip's stream (tools/torch_smoke_streams.py)
MULTICHIP_STREAM = "tiles2x2_256x192.ivf"


def _example_batch(n_blocks: int, w: int = 16, h: int = 16, seed: int = 0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 256, size=(n_blocks, h + 7, w + 7)).astype(np.int32)
    fh = np.tile(np.array([-1, 3, -10, 35, 44, -11, 4, 0], dtype=np.int32),
                 (n_blocks, 1))
    fv = np.tile(np.array([0, 2, -7, 30, 48, -12, 3, 0], dtype=np.int32),
                 (n_blocks, 1))
    cf = rng.integers(-512, 512, size=(n_blocks, w * h)).astype(np.int32)
    return src, fh, fv, cf


def _recon_step(src, fh, fv, cf, w, h):
    """One fused pass-2 step: inter prediction + residual, (N, h, w)
    int32.  ``src`` (N, h+7, w+7) int32 windows, ``fh``/``fv`` (N, 8)
    int32 taps, ``cf`` (N, w*h) int32 coefficients in the arena's
    column-major order, all on one device.

    MC: the N windows stacked into one (N*(h+7), w+7) plane, one job row
    per block at origin (i*(h+7)+3, 3), so each job's clamped reads are
    exactly its window.  itx: one job per block at coefficient offset
    i*w*h, TX_16X16 DCT_DCT with an eob covering every coefficient;
    job_table keeps jobs of one key in input order, so block i's
    residuals land at i*h*w."""
    n = src.shape[0]
    dev = src.device
    plane = src.reshape(n * (h + 7), w + 7).contiguous()
    jobs, tiles, n_pix = omc.job_table(
        np.zeros(n), np.arange(n) * (h + 7) + 3, np.full(n, 3), w, h,
        np.arange(n) * (h * w), w, fh.cpu().numpy(), fv.cpu().numpy(),
        n * h * w)
    pred = omc.put_8tap_resident(
        [plane], [tuple(plane.shape)], devrt.upload(jobs, dev),
        devrt.upload(tiles, dev), n_pix, n * h * w, _BITDEPTH)
    order, ijobs, groups, n_out = oitx.job_table(
        np.arange(n) * (w * h), np.full(n, _TX_16X16),
        np.full(n, int(TxfmType.DCT_DCT)), np.full(n, w * h - 1), n * w * h)
    if not np.array_equal(order, np.arange(n)):
        raise AssertionError("itx job_table reordered the blocks")
    resid = oitx.itx_frame(cf.reshape(-1).contiguous(),
                           devrt.upload(ijobs, dev),
                           devrt.upload(groups, dev), n_out, _BITDEPTH)
    out = pred.to(torch.int32) + resid.to(torch.int32)
    return torch.clamp(out, 0, (1 << _BITDEPTH) - 1).reshape(n, h, w)


def _tensors(arrays, device):
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def entry(device="cuda"):
    """Return (fn, example_args): ``fn(src, fh, fv, cf)`` is the fused
    step on 16x16 blocks, ``example_args`` the example batch of 256
    blocks as int32 tensors on ``device``."""
    dev = devrt.resolve_device(device)
    w = h = 16

    def fn(src, fh, fv, cf):
        return _recon_step(src, fh, fv, cf, w, h)

    return fn, _tensors(_example_batch(256), dev)


def _sharded_batch_check(mesh, n_devices: int) -> None:
    """The fused step over ``n_devices * 4`` blocks, cut into one share of
    4 blocks a band on the band's device and stitched on the first, equals
    the single call."""
    w = h = 16
    n_blocks = n_devices * 4
    batch = _example_batch(n_blocks)
    parts = []
    for b in mesh.local:
        share = [a[b * 4:(b + 1) * 4] for a in batch]
        parts.append(_recon_step(*_tensors(share, mesh.device_of(b)), w, h))
    out = mesh.fetch(parts)
    ref = _recon_step(*_tensors(batch, mesh.devices[0]), w, h)
    if tuple(out.shape) != (n_blocks, h, w) or not torch.equal(out, ref):
        raise AssertionError("sharded reconstruction diverged from the "
                             "single-device result")


def _decode_md5(tus, settings, device):
    from .decoder import Decoder

    dec = Decoder(settings, device=device)
    h = hashlib.md5()
    n = 0
    for tu in tus:
        dec.send_data(tu)
        while (pic := dec.get_picture()) is not None:
            n += 1
            for pl in range(len(pic.planes)):
                h.update(pic.plane_bytes(pl))
    dec.close()
    if n == 0:
        raise AssertionError("the decode gave no picture")
    return n, h.hexdigest()


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """The synthetic fused step sharded over ``n_devices`` bands, and the
    committed 2x2-tile stream decoded with ``Settings(two_pass=True,
    mesh=Mesh([device] * n_devices))``; both must equal the one-device
    result (the decode also its committed md5).  Raises AssertionError
    on a difference; returns what it compared."""
    from .containers import read_ivf
    from .decoder import Settings
    from .mesh import Mesh

    dev = devrt.resolve_device(device)
    mesh = Mesh([dev] * n_devices)
    _sharded_batch_check(mesh, n_devices)
    tus = [tu for tu, _ in read_ivf((DATA / MULTICHIP_STREAM).read_bytes())]
    single = _decode_md5(tus, Settings(two_pass=True), dev)
    sharded = _decode_md5(tus, Settings(two_pass=True, mesh=mesh), dev)
    if sharded != single:
        raise AssertionError(f"mesh-sharded decode diverged: {sharded} != "
                             f"{single}")
    want = json.loads((DATA / "md5.json").read_text())[MULTICHIP_STREAM]
    if single != (want["frames"], want["md5"]):
        raise AssertionError(f"{MULTICHIP_STREAM}: {single}, want "
                             f"{(want['frames'], want['md5'])}")
    return {"bands": n_devices, "frames": single[0], "md5": single[1]}


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m dav1d_tpu_torch.entry")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    try:
        fn, ex = entry(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"dav1d_tpu: {e}", file=sys.stderr)
        return 1
    out = fn(*ex)
    ref = fn(*(t.cpu() for t in ex))
    if not torch.equal(out.cpu(), ref):
        print("entry: the step differs from its plain version",
              file=sys.stderr)
        return 1
    print(f"entry: {tuple(out.shape)} on {out.device}, equal to the plain "
          "version on the CPU")
    for n in DRYRUN_BANDS:
        print(f"dryrun_multichip({n}): {dryrun_multichip(n, args.device)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
