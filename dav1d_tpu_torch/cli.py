"""dav1d_tpu_torch CLI: decode AV1 (IVF, Annex B, section 5) to y4m / yuv /
md5 / xxh3 with the port's decoder, on the card by default.

    python -m dav1d_tpu_torch.cli -i clip.ivf --muxer md5 [--device cpu]

The options, defaults, muxers, status line and exit codes are those of
the JAX package's CLI (tools/dav1d_tpu_cli.py, after the reference's
tools/dav1d.c and tools/dav1d_cli_parse.c), with one more option,
``--device`` (default ``cuda``).  Exit codes: 0 done, 1 ``--verify``
mismatch or a decoder that cannot run on the device asked for (no
CUDA), 2 bad options.
"""

from __future__ import annotations

import argparse
import hashlib
import math
import sys
import time
from pathlib import Path

from .containers import ivf_meta, open_stream, probe_ivf
from .decoder import Decoder, Settings
from .headers import PixelLayout


def y4m_header(pic, fps=(25, 1)) -> bytes:
    ss_names = {
        (PixelLayout.I400, 8): "mono",
        (PixelLayout.I420, 8): "420jpeg",
        (PixelLayout.I420, 10): "420p10",
        (PixelLayout.I420, 12): "420p12",
        (PixelLayout.I422, 8): "422",
        (PixelLayout.I422, 10): "422p10",
        (PixelLayout.I444, 8): "444",
        (PixelLayout.I444, 10): "444p10",
    }
    chr_names = {0: "420jpeg", 1: "420mpeg2", 2: "420"}
    if pic.layout == PixelLayout.I420 and pic.bitdepth == 8:
        ss = chr_names.get(int(pic.seq_hdr.chr), "420jpeg")
    else:
        ss = ss_names[(pic.layout, pic.bitdepth)]
    aw = pic.height * pic.frame_hdr.render_width
    ah = pic.width * pic.frame_hdr.render_height
    g = math.gcd(aw, ah) or 1
    return (f"YUV4MPEG2 W{pic.width} H{pic.height} F{fps[0]}:{fps[1]} "
            f"Ip A{aw // g}:{ah // g} C{ss}\n").encode()


def _xxh3():
    """An XXH3-128 hasher, canonical (big-endian) hex like the reference
    muxer (tools/output/xxhash.c xxh3_close)."""
    try:
        import xxhash
    except ImportError:
        raise SystemExit("dav1d_tpu: --muxer xxh3 needs the xxhash "
                         "package, which is not installed") from None
    return xxhash.xxh3_128()


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m dav1d_tpu_torch.cli")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", default="-")
    p.add_argument("--muxer", default="y4m",
                   choices=["y4m", "yuv", "md5", "xxh3", "null"])
    p.add_argument("-l", "--limit", type=int, default=0, help="max frames")
    p.add_argument("-s", "--skip", type=int, default=0,
                   help="skip decoding the first N frames")
    p.add_argument("--verify", metavar="DIGEST",
                   help="verify decoded output against a digest: md5, "
                        "or xxh3-128 with --muxer xxh3 (exit 1 on "
                        "mismatch; reference tools/output/md5.c, "
                        "xxhash.c)")
    p.add_argument("-q", "--quiet", action="store_true",
                   help="suppress the per-decode status line")
    p.add_argument("--realtime", action="store_true",
                   help="pace output to the stream frame rate and report "
                        "realtime decode margin")
    p.add_argument("--filmgrain", type=int, default=None, choices=[0, 1],
                   help="apply film grain (default 1, except 0 when the "
                        "muxer is md5 — reference dav1d_cli_parse.c:461)")
    p.add_argument("--oppoint", type=int, default=0,
                   help="operating point to decode (scalable streams)")
    p.add_argument("--alllayers", type=int, default=1, choices=[0, 1],
                   help="output all spatial layers (default 1)")
    p.add_argument("--sizelimit", type=int, default=0,
                   help="maximum frame size in pixels (0 = unlimited)")
    p.add_argument("--framedelay", type=int, default=0,
                   help="maximum frames in flight (frame pipelining)")
    p.add_argument("--inloopfilters", default="all",
                   choices=["none", "deblock", "cdef", "restoration",
                            "all"],
                   help="in-loop filters to apply")
    p.add_argument("--decodeframetype", default="all",
                   choices=["all", "reference", "intra", "key"],
                   help="frame types to decode")
    p.add_argument("--twopass", type=int, default=1, choices=[0, 1],
                   help="two-pass host/device pipeline (default 1)")
    p.add_argument("--threads", type=int, default=0,
                   help=">=2 runs reconstruction on a worker thread "
                        "overlapping the next frame's entropy decode")
    p.add_argument("--frametimes", metavar="FILE",
                   help="dump per-frame decode times in nanoseconds, one "
                        "per line (reference --frametimes)")
    p.add_argument("--device", default="cuda",
                   help="torch device to decode on (default cuda; cpu "
                        "runs the kernels' plain PyTorch versions)")
    args = p.parse_args(argv)
    if args.filmgrain is None:
        args.filmgrain = 0 if args.muxer in ("md5", "xxh3") else 1

    data = Path(args.input).read_bytes()
    fps = (25, 1)
    if probe_ivf(data):
        _, _, num, den = ivf_meta(data)
        if num and den:
            fps = (num, den)
    ilf = {"none": 0, "deblock": 1, "cdef": 2, "restoration": 4,
           "all": 7}[args.inloopfilters]
    dft = {"all": 0, "reference": 1, "intra": 2,
           "key": 3}[args.decodeframetype]
    md5 = _xxh3() if args.muxer == "xxh3" else hashlib.md5()
    try:
        dec = Decoder(Settings(
            apply_grain=bool(args.filmgrain), operating_point=args.oppoint,
            all_layers=bool(args.alllayers),
            frame_size_limit=args.sizelimit,
            max_frame_delay=args.framedelay, inloop_filters=ilf,
            decode_frame_type=dft, two_pass=bool(args.twopass),
            n_threads=args.threads,
            logger=None if args.quiet
            else lambda m: print(f"dav1d_tpu: {m}", file=sys.stderr)),
            device=args.device)
    except (RuntimeError, ValueError) as e:
        print(f"dav1d_tpu: {e}", file=sys.stderr)
        return 1
    out = sys.stdout.buffer if args.output == "-" else open(args.output, "wb")
    n = 0
    emitted = 0
    first = True
    t_start = time.perf_counter()

    def emit(pic):
        nonlocal first, emitted
        if args.muxer == "y4m":
            if first:
                out.write(y4m_header(pic, fps))
                first = False
            out.write(b"FRAME\n")
        for pl in range(len(pic.planes)):
            buf = pic.plane_buffer(pl)
            if args.muxer in ("md5", "xxh3") or args.verify:
                md5.update(buf)
            if args.muxer not in ("md5", "xxh3", "null"):
                out.write(buf)
        emitted += 1
        if frametimes is not None:
            now = time.perf_counter_ns()
            frametimes.append(now - t_prev[0])
            t_prev[0] = now
        if args.realtime:
            # pace to the container frame rate (reference --realtime,
            # tools/dav1d.c synchronize())
            due = t_start + emitted * fps[1] / fps[0]
            lag = due - time.perf_counter()
            if lag > 0:
                time.sleep(lag)

    frametimes = [] if args.frametimes else None
    t_prev = [time.perf_counter_ns()]
    done = False
    for tu, _pts in open_stream(data):
        dec.send_data(tu)
        while (pic := dec.get_picture()) is not None:
            n += 1
            if n <= args.skip:
                continue
            emit(pic)
            if args.limit and emitted >= args.limit:
                done = True
                break
        if done:
            break
    if not done:
        # drain in-flight frames (get_picture finishes pending pass-2
        # work; flush() would DROP them, reference dav1d_flush)
        while (pic := dec.get_picture()) is not None:
            n += 1
            if n <= args.skip:
                continue
            emit(pic)
            if args.limit and emitted >= args.limit:
                break
    elapsed = time.perf_counter() - t_start
    if frametimes is not None:
        Path(args.frametimes).write_text(
            "".join(f"{t}\n" for t in frametimes))
    if args.muxer in ("md5", "xxh3"):
        out.write(f"{md5.hexdigest()}\n".encode())
    if out is not sys.stdout.buffer:
        out.close()
    if not args.quiet:
        fps_out = emitted / elapsed if elapsed > 0 else 0.0
        line = (f"decoded {emitted}/{n} frames in {elapsed:.2f}s "
                f"({fps_out:.2f} fps)")
        if args.realtime:
            line += f", stream rate {fps[0] / fps[1]:.2f} fps"
        print(line, file=sys.stderr)
    if args.verify:
        if md5.hexdigest() != args.verify.strip().lower():
            print(f"verify FAILED: {md5.hexdigest()} != {args.verify}",
                  file=sys.stderr)
            return 1
        if not args.quiet:
            print("verify OK", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
