"""dav1d_tpu_torch player: decode AV1 with the port's decoder and render to
the terminal.

The JAX package's player (tools/dav1d_tpu_play.py, the analog of the
reference's examples/dav1dplay.c) over the port: decode loop, YUV->RGB
conversion, display scaling, frame-rate pacing and a stats line,
rendered as 24-bit ANSI half-block cells (each character cell shows two
vertical pixels via foreground/background colors).  The conversion and
rendering are numpy on the host, after the decode.

    python -m dav1d_tpu_torch.play -i clip.ivf            # play
    python -m dav1d_tpu_torch.play -i clip.ivf --zoom 2   # 2x downscale
    python -m dav1d_tpu_torch.play -i clip.ivf --ppm out  # dump RGB .ppm
    python -m dav1d_tpu_torch.play -i clip.ivf --device cpu

The decode runs on the card unless ``--device cpu`` is given; without
CUDA the player exits 1 and says why.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

import numpy as np

from .containers import ivf_meta, open_stream, probe_ivf
from .decoder import Decoder, Settings
from .headers import PixelLayout


def to_rgb(pic) -> np.ndarray:
    """(h, w, 3) uint8 BT.601 limited-range conversion (the reference
    player delegates this to SDL/placebo; reference examples/dp_fifo.c
    path feeds YUV textures)."""
    bd = pic.bitdepth
    sh = bd - 8
    y = (pic.planes[0] >> sh).astype(np.int32)
    h, w = y.shape
    if pic.layout == PixelLayout.I400 or len(pic.planes) == 1:
        u = np.full((h, w), 128, np.int32)
        v = u
    else:
        u = (pic.planes[1] >> sh).astype(np.int32)
        v = (pic.planes[2] >> sh).astype(np.int32)
        ry = -(-h // u.shape[0])  # 1 or 2
        rx = -(-w // u.shape[1])
        u = np.repeat(np.repeat(u, ry, 0), rx, 1)[:h, :w]
        v = np.repeat(np.repeat(v, ry, 0), rx, 1)[:h, :w]
    c = y - 16
    d = u - 128
    e = v - 128
    r = (298 * c + 409 * e + 128) >> 8
    g = (298 * c - 100 * d - 208 * e + 128) >> 8
    b = (298 * c + 516 * d + 128) >> 8
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def fit(rgb: np.ndarray, cols: int, rows_px: int) -> np.ndarray:
    """Integer-stride downscale to fit cols x rows_px (rows_px = 2 *
    terminal rows, two pixels per cell)."""
    h, w, _ = rgb.shape
    step = max(1, -(-w // cols), -(-h // rows_px))
    return rgb[::step, ::step]


def render(rgb: np.ndarray) -> str:
    """ANSI 24-bit half-block frame: one char cell = 2 vertical px."""
    h, w, _ = rgb.shape
    if h % 2:
        rgb = np.vstack([rgb, rgb[-1:]])
        h += 1
    top = rgb[0::2]
    bot = rgb[1::2]
    lines = []
    for yy in range(h // 2):
        prev_t = prev_b = None
        parts = []
        for xx in range(w):
            t = tuple(top[yy, xx])
            b = tuple(bot[yy, xx])
            if t != prev_t or b != prev_b:
                parts.append("\x1b[38;2;%d;%d;%dm\x1b[48;2;%d;%d;%dm"
                             % (t + b))
                prev_t, prev_b = t, b
            parts.append("▀")
        parts.append("\x1b[0m")
        lines.append("".join(parts))
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m dav1d_tpu_torch.play")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("--zoom", type=int, default=1,
                   help="extra integer downscale factor")
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--no-pace", action="store_true",
                   help="render as fast as decode allows")
    p.add_argument("--ppm", metavar="DIR",
                   help="dump frames as PPM files instead of rendering")
    p.add_argument("--stats", action="store_true", default=True)
    p.add_argument("--device", default="cuda",
                   help="torch device to decode on (default cuda)")
    args = p.parse_args(argv)

    data = Path(args.input).read_bytes()
    fps = (25, 1)
    if probe_ivf(data):
        _, _, num, den = ivf_meta(data)
        if num and den:
            fps = (num, den)

    try:
        cols, rows = os.get_terminal_size()
    except OSError:
        cols, rows = 80, 24
    rows_px = max(2, (rows - 1) * 2)

    try:
        dec = Decoder(Settings(max_frame_delay=2, two_pass=True),
                      device=args.device)
    except (RuntimeError, ValueError) as e:
        print(f"dav1d_tpu: {e}", file=sys.stderr)
        return 1
    n = 0
    t0 = time.perf_counter()
    out = sys.stdout
    if args.ppm:
        os.makedirs(args.ppm, exist_ok=True)
    else:
        out.write("\x1b[2J")  # clear once

    def show(pic):
        nonlocal n
        rgb = to_rgb(pic)
        if args.ppm:
            path = Path(args.ppm) / f"frame{n:05d}.ppm"
            with open(path, "wb") as fh:
                fh.write(b"P6\n%d %d\n255\n"
                         % (rgb.shape[1], rgb.shape[0]))
                fh.write(rgb.tobytes())
        else:
            small = fit(rgb, max(2, cols // args.zoom),
                        max(2, rows_px // args.zoom))
            frame = render(small)
            elapsed = time.perf_counter() - t0
            rate = (n + 1) / elapsed if elapsed > 0 else 0.0
            stats = (f"\x1b[0m frame {n + 1}  {pic.width}x{pic.height} "
                     f"{pic.bitdepth}-bit  {rate:5.1f} fps")
            out.write("\x1b[H" + frame + "\n" + stats)
            out.flush()
        n += 1
        if not args.no_pace and not args.ppm:
            due = t0 + n * fps[1] / fps[0]
            lag = due - time.perf_counter()
            if lag > 0:
                time.sleep(lag)

    done = False
    for tu, _pts in open_stream(data):
        dec.send_data(tu)
        while (pic := dec.get_picture()) is not None:
            show(pic)
            if args.limit and n >= args.limit:
                done = True
                break
        if done:
            break
    if not done:
        while (pic := dec.get_picture()) is not None:
            show(pic)
            if args.limit and n >= args.limit:
                break
    if not args.ppm:
        out.write("\x1b[0m\n")
    elapsed = time.perf_counter() - t0
    print(f"\nplayed {n} frames in {elapsed:.2f}s "
          f"({n / elapsed if elapsed else 0:.2f} fps)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
