"""GOP-parallel and relay decode with the port's decoder: split a stream
at key frames, decode the segments in parallel worker processes, stitch
the output in order; or hand the decode position from one process to the
next at arbitrary temporal units.

The JAX package's tools/gop_decode.py over the port.  Key frames reset
the reference slots and CDF state, so every key-frame-led segment
decodes independently: frame parallelism at GOP granularity with no
communication between workers.  The relay is the mid-GOP handoff
(``Decoder.export_state`` / ``import_state``) exercised process to
process; it is sequential by nature.

Workers are spawned processes, each with a ``Decoder`` on the device it
is given (several workers share ``cuda:0`` on a one-card machine).  The
kernel library and the native C are built under file locks in
``_build/``, so workers that start together build each once and the
others load what it built.

    python -m dav1d_tpu_torch.gop -i clip.ivf --muxer md5 -j 4
    python -m dav1d_tpu_torch.gop -i clip.ivf --relay 3 --device cpu
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys
import tempfile
import time
from pathlib import Path


def _tu_starts_gop(tu: bytes) -> bool:
    """True iff the temporal unit's first frame OBU is a (shown) key
    frame — a clean random-access point (AV1 spec 5.9.2: frame_type
    KEY==0 right after show_existing_frame)."""
    from .getbits import GetBits
    from .headers import ObuType
    from .obu import split_obus

    for o in split_obus(tu):
        if o.type not in (ObuType.FRAME, ObuType.FRAME_HDR):
            continue
        gb = GetBits(tu[o.payload_start : o.payload_end])
        if gb.get_bit():  # show_existing_frame
            return False
        return gb.get_bits(2) == 0  # frame_type == KEY
    return False


def _seq_obu_bytes(tu: bytes) -> bytes | None:
    """The raw bytes of the sequence-header OBU in this TU (each worker
    needs one before its segment), with a fresh OBU header (type 1,
    has_size) in front of the payload."""
    from .headers import ObuType
    from .obu import split_obus

    for o in split_obus(tu):
        if o.type == ObuType.SEQ_HDR:
            payload = tu[o.payload_start : o.payload_end]
            leb = b""
            v = len(payload)
            while True:
                b = v & 0x7F
                v >>= 7
                leb += bytes([b | (0x80 if v else 0)])
                if not v:
                    break
            return bytes([0x0A]) + leb + payload
    return None


def split_gops(tus: list[bytes]):
    """(seq_obu_bytes | None, [[tus...], ...]): one segment per key-frame
    led run; the first segment absorbs any leading non-key TUs."""
    segments = []
    cur = []
    seq = None
    for tu in tus:
        s = _seq_obu_bytes(tu)
        if s is not None:
            seq = s
        if _tu_starts_gop(tu) and cur:
            segments.append(cur)
            cur = []
        cur.append(tu)
    if cur:
        segments.append(cur)
    return seq, segments


def _resolve(device) -> str:
    """``device`` resolved in the parent, so that asking for CUDA without
    it raises before any worker starts."""
    from . import devrt

    return str(devrt.resolve_device(device))


def _write_planes(out, pic) -> None:
    for pl in range(len(pic.planes)):
        out.write(pic.plane_bytes(pl))


def _decode_segment(args):
    seq, tus, out_path, two_pass, device = args
    from .decoder import Decoder, Settings

    dec = Decoder(Settings(two_pass=two_pass, max_frame_delay=4),
                  device=device)
    n = 0
    with open(out_path, "wb") as out:
        def drain():
            nonlocal n
            while (pic := dec.get_picture()) is not None:
                _write_planes(out, pic)
                n += 1

        if seq is not None:
            dec.send_data(seq)
        for tu in tus:
            dec.send_data(tu)
            drain()
        drain()
    dec.close()
    return n


def gop_decode(data: bytes, jobs: int, two_pass: bool = True,
               workdir: str | None = None, device="cuda"):
    """Decode IVF bytes GOP-parallel in ``jobs`` spawned workers; returns
    (n_frames, yuv_path) per segment in display order."""
    import multiprocessing as mp

    from .containers import read_ivf

    device = _resolve(device)
    tus = [tu for tu, _ in read_ivf(data)]
    seq, segments = split_gops(tus)
    td = workdir or tempfile.mkdtemp(prefix="dav1d_tpu_gop_")
    jobs_args = []
    for i, seg in enumerate(segments):
        # the first TU of segment 0 carries its own seq hdr already;
        # later segments may too — sending it twice is harmless
        jobs_args.append((seq if i else None, seg,
                          os.path.join(td, f"seg{i:04d}.yuv"), two_pass,
                          device))
    if jobs <= 1 or len(segments) == 1:
        counts = [_decode_segment(a) for a in jobs_args]
    else:
        ctx = mp.get_context("spawn")
        with ctx.Pool(min(jobs, len(segments))) as pool:
            counts = pool.map(_decode_segment, jobs_args)
    return [(c, a[2]) for c, a in zip(counts, jobs_args)]


def _relay_segment(args):
    """Worker body of relay_decode: import the predecessor's state,
    decode this segment, export the state for the successor."""
    seq, tus, out_path, state_in, state_out, two_pass, device = args
    from .decoder import Decoder, Settings

    dec = Decoder(Settings(two_pass=two_pass), device=device)
    if state_in is not None:
        dec.import_state(Path(state_in).read_bytes())
    elif seq is not None:
        dec.send_data(seq)
    n = 0
    with open(out_path, "wb") as out:
        for tu in tus:
            dec.send_data(tu)
            while (pic := dec.get_picture()) is not None:
                _write_planes(out, pic)
                n += 1
    if state_out is not None:
        Path(state_out).write_bytes(dec.export_state())
    dec.close()
    return n


def relay_decode(data: bytes, segments: int, two_pass: bool = True,
                 workdir: str | None = None, device="cuda"):
    """Mid-GOP handoff relay: split the stream at ARBITRARY TU positions
    (no key frames needed) and decode each segment in a fresh spawned
    process seeded with its predecessor's exported reference state.
    Returns (n_frames, yuv_path) per segment."""
    import multiprocessing as mp

    from .containers import read_ivf

    device = _resolve(device)
    tus = [tu for tu, _ in read_ivf(data)]
    seq, _ = split_gops(tus)
    td = workdir or tempfile.mkdtemp(prefix="dav1d_tpu_relay_")
    bounds = [round(i * len(tus) / segments) for i in range(segments + 1)]
    ctx = mp.get_context("spawn")
    results = []
    prev_state = None
    for i in range(segments):
        seg = tus[bounds[i] : bounds[i + 1]]
        out_path = os.path.join(td, f"relay{i:04d}.yuv")
        state_out = os.path.join(td, f"state{i:04d}.bin") \
            if i + 1 < segments else None
        with ctx.Pool(1) as pool:
            n = pool.apply(_relay_segment,
                           ((seq if i == 0 else None, seg, out_path,
                             prev_state, state_out, two_pass, device),))
        prev_state = state_out
        results.append((n, out_path))
    return results


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m dav1d_tpu_torch.gop")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", default="-")
    p.add_argument("--muxer", default="md5", choices=["md5", "yuv", "null"])
    p.add_argument("-j", "--jobs", type=int, default=os.cpu_count() or 1)
    p.add_argument("--relay", type=int, default=0, metavar="N",
                   help="mid-GOP handoff mode: N arbitrary segments "
                        "relayed through export_state/import_state")
    p.add_argument("--device", default="cuda",
                   help="torch device of every worker (default cuda)")
    args = p.parse_args(argv)

    data = Path(args.input).read_bytes()
    t0 = time.perf_counter()
    try:
        parts = relay_decode(data, args.relay, device=args.device) \
            if args.relay > 1 else gop_decode(data, args.jobs,
                                              device=args.device)
    except (RuntimeError, ValueError) as e:
        print(f"dav1d_tpu: {e}", file=sys.stderr)
        return 1
    elapsed = time.perf_counter() - t0
    total = sum(c for c, _ in parts)
    out = sys.stdout.buffer if args.output == "-" else open(args.output,
                                                            "wb")
    md5 = hashlib.md5()
    for _, path in parts:
        buf = Path(path).read_bytes()
        if args.muxer == "md5":
            md5.update(buf)
        elif args.muxer == "yuv":
            out.write(buf)
    if args.muxer == "md5":
        out.write(f"{md5.hexdigest()}\n".encode())
    if out is not sys.stdout.buffer:
        out.close()
    kind = "relay" if args.relay > 1 else "GOP"
    print(f"decoded {total} frames in {len(parts)} {kind} segments, "
          f"{elapsed:.2f}s ({total / elapsed:.2f} fps)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
