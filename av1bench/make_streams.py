"""Make the benchmark's clips and their reference digests (needs libaom;
run where libaom is installed, never as part of a benchmark run).

    python3 av1bench/make_streams.py [--check N] [config | path.json ...]

For each configuration (``configs/<name>.json``; all when none is named)
it encodes ``assumed.clips`` clips of ``assumed.frames_per_clip`` frames
from the seeded synthetic video of ``content.py`` (content seeds
``assumed.content_seeds``) with libaom's encoder at the configuration's
settings, writes them to ``streams/<name>/clip<i>.ivf``, decodes each
with libaom's decoder and writes ``streams/<name>/reference.json``: per
clip its temporal units' sizes and decoded-frame counts, and per picture
the MD5 and fingerprint of each plane (``check.py``).  It records in the
configuration file what the streams achieved (bytes per frame against
the target, frames, hidden frames) and the seconds encoding took.

``--check N`` also decodes the first N temporal units of every clip with
the program under test on the CPU (``Decoder(device="cpu")`` with the
configuration's settings), holds each picture against libaom's, and
records in the configuration file the coding features that the decoded
pictures' headers carry.

    python3 av1bench/make_streams.py --tx-stats [config ...]

encodes nothing: it decodes every committed clip of each configuration
with the program on the CPU and records under ``achieved`` the transform
blocks a decoded frame (``itx_blocks_per_frame``) and their sizes
(``tx_sizes``), the work that pass 1 and the itx kernel do per frame.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))

import aom  # noqa: E402
import check  # noqa: E402
import content  # noqa: E402
import ivf  # noqa: E402


def encode_clip(cfg: dict, seed: int) -> list:
    a = cfg["assumed"]
    num, den = cfg["fps"]
    enc = aom.Encoder(cfg["width"], cfg["height"], bitdepth=cfg["bitdepth"],
                      fps_num=num, fps_den=den, kbps=cfg["target_kbps"],
                      kf_max_dist=a["kf_max_dist"], lag=a["lag_in_frames"],
                      cpu_used=a["cpu_used"], usage=a["usage"],
                      options=a["encoder_options"])
    scene = content.Scene(seed, cfg["width"], cfg["height"], cfg["bitdepth"],
                          a["frames_per_clip"], noise=a["content_noise"],
                          detail=a.get("content_detail"))
    for _ in range(a["frames_per_clip"]):
        enc.encode(scene.next())
    return [data for _, data in enc.finish()]


def reference(units: list, bitdepth: int) -> dict:
    pics = aom.decode(units)
    if any(len(p) != 1 for p in pics):
        raise RuntimeError("a temporal unit did not output exactly one "
                           f"picture: {[len(p) for p in pics]}")
    return {
        "sizes": [len(u) for u in units],
        "frames": [ivf.frames_decoded(u) for u in units],
        "shows_existing": [ivf.shows_existing(u) for u in units],
        "pictures": [{"md5": check.md5s(p[0], bitdepth),
                      "fp": check.fingerprint(p[0])} for p in pics],
    }


def carries(pics) -> list:
    """The coding features the pictures' headers show (the form of the
    program's stream tool)."""
    tags = set()
    for p in pics:
        hdr, seq = p.frame_hdr, p.seq_hdr
        tags.add(hdr.frame_type.name.lower() + "_frame")
        tags.add("sb128" if seq.sb128 else "sb64")
        if hdr.width[0] != hdr.width[1]:
            tags.add("superres")
        if hdr.film_grain.present:
            tags.add("film_grain")
        if hdr.segmentation.enabled:
            tags.add("segmentation")
        if hdr.delta.q_present:
            tags.add("delta_q")
        if hdr.tiling.cols * hdr.tiling.rows > 1:
            tags.add(f"tiles_{hdr.tiling.cols}x{hdr.tiling.rows}")
        if any(int(t) for t in hdr.restoration.type):
            tags.add("restoration")
        if seq.cdef and (any(hdr.cdef.y_strength)
                         or any(hdr.cdef.uv_strength)):
            tags.add("cdef")
        if hdr.loopfilter.level_y[0] or hdr.loopfilter.level_y[1]:
            tags.add("deblock")
        if hdr.use_ref_frame_mvs:
            tags.add("ref_frame_mvs")
        if hdr.skip_mode_enabled:
            tags.add("skip_mode")
        if hdr.warp_motion:
            tags.add("warped_motion")
        if hdr.switchable_motion_mode:
            tags.add("switchable_motion_mode")
    return sorted(tags)


def check_prefix(cfg: dict, clips: list, ref: dict, n: int) -> list:
    """Decode the first ``n`` units of each clip with the program on the
    CPU, hold every picture against libaom's; the features carried."""
    import torch

    sys.path.insert(0, str(ROOT))
    from dav1d_tpu_torch.decoder import Decoder, Settings

    torch.set_num_threads(2)
    pics_all = []
    for i, units in enumerate(clips):
        dec = Decoder(Settings(**cfg["settings"]), device="cpu")
        got = []
        for tu in units[:n]:
            dec.send_data(tu)
            while (pic := dec.get_picture()) is not None:
                got.append(pic)
        dec.close()
        want = ref["clips"][i]["pictures"][:n]
        if len(got) != len(want):
            raise RuntimeError(f"clip {i}: {len(got)} pictures, want "
                               f"{len(want)}")
        for k, (p, w) in enumerate(zip(got, want)):
            if check.md5s(p.planes, cfg["bitdepth"]) != w["md5"]:
                raise RuntimeError(f"clip {i} picture {k}: the program's "
                                   "CPU decode differs from libaom's")
        print(f"  clip {i}: {len(got)} pictures equal to libaom's",
              flush=True)
        pics_all += got
    return carries(pics_all)


def tx_stats(path: Path) -> None:
    """Record the committed clips' transform blocks by size (the itx
    calls' job rows, ``roofline.TX_INFO`` order) in the configuration.
    The decoder runs without worker threads: with tile threads the
    program's job tables also carry rows of no coded block (PERF.md's
    open questions), which are the program's work, not the clips'."""
    import collections

    import torch

    import roofline

    sys.path.insert(0, str(ROOT))
    from dav1d_tpu_torch import devrt
    from dav1d_tpu_torch.decoder import Decoder, Settings

    torch.set_num_threads(2)
    cfg = json.loads(path.read_text())
    sizes = collections.Counter()

    class Sink(list):
        def append(self, record):
            if record[0] == "itx":
                tx, n = torch.unique(record[2][1][:, 1], return_counts=True)
                sizes.update(dict(zip(tx.tolist(), n.tolist())))

    frames = 0
    devrt.SINK = Sink()
    try:
        for f in cfg["clip_files"]:
            units = ivf.read((ROOT / cfg["streams"] / f).read_bytes())
            dec = Decoder(Settings(**{**cfg["settings"], "n_threads": 0}),
                          device="cpu")
            for tu in units:
                frames += ivf.frames_decoded(tu)
                dec.send_data(tu)
                while dec.get_picture() is not None:
                    pass
            dec.close()
            print(f"  {f}: {sum(sizes.values())} transform blocks so far",
                  flush=True)
    finally:
        devrt.SINK = None
    total = sum(sizes.values())
    cfg["achieved"]["itx_blocks_per_frame"] = round(total / frames, 1)
    cfg["achieved"]["tx_sizes"] = {
        "%dx%d" % roofline.TX_INFO[t][:2]: round(100.0 * n / total, 2)
        for t, n in sorted(sizes.items(), key=lambda kv: -kv[1])}
    cfg["achieved"]["tx_sizes_of"] = (
        f"share % of the {total} transform blocks of the {frames} frames "
        "decoded (hidden ones too), by size, largest share first; the "
        "program on the CPU without worker threads")
    path.write_text(json.dumps(cfg, indent=1) + "\n")
    print(f"{path.stem}: {cfg['achieved']['itx_blocks_per_frame']} "
          f"transform blocks a frame, {cfg['achieved']['tx_sizes']}",
          flush=True)


def make(path: Path, check_n: int) -> None:
    name = path.stem
    cfg = json.loads(path.read_text())
    a = cfg["assumed"]
    out = ROOT / cfg["streams"]
    out.mkdir(parents=True, exist_ok=True)
    num, den = cfg["fps"]
    t0 = time.perf_counter()
    clips, refs = [], []
    for i, seed in enumerate(a["content_seeds"]):
        t = time.perf_counter()
        units = encode_clip(cfg, seed)
        ivf.write(out / f"clip{i}.ivf", units, cfg["width"], cfg["height"],
                  num, den)
        refs.append(reference(units, cfg["bitdepth"]))
        clips.append(units)
        print(f"{name} clip {i}: {len(units)} units, "
              f"{sum(map(len, units))} bytes, "
              f"{time.perf_counter() - t:.1f} s", flush=True)
    encode_s = time.perf_counter() - t0
    ref = {"decoder": "libaom aom_codec_av1_dx (libaom.so.3), grain applied",
           "grid": check.GRID, "clips": refs}
    (out / "reference.json").write_text(json.dumps(ref) + "\n")
    frames = sum(len(r["sizes"]) for r in refs)
    decoded = sum(sum(r["frames"]) for r in refs)
    total = sum(sum(r["sizes"]) for r in refs)
    cfg["achieved"] = {
        "clips": len(refs), "pictures": frames, "frames_decoded": decoded,
        "shown_existing": sum(sum(r["shows_existing"]) for r in refs),
        "hidden_frames": decoded - frames + sum(sum(r["shows_existing"])
                                                for r in refs),
        "bytes": total, "bytes_per_frame": round(total / frames, 1),
        "target_bytes_per_frame": round(cfg["target_kbps"] * 1000 / 8
                                        * den / num, 1),
        "kbps": round(total * 8 / frames * num / den / 1000, 1),
        "encode_s": round(encode_s, 1),
    }
    if check_n:
        cfg["features"] = check_prefix(cfg, clips, ref, check_n)
        cfg["features_of"] = (f"the first {check_n} temporal units of each "
                              "clip, decoded by the program on the CPU and "
                              "equal to libaom's")
    path.write_text(json.dumps(cfg, indent=1) + "\n")
    print(f"{name}: {cfg['achieved']}", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", type=int, default=0, metavar="N")
    ap.add_argument("--tx-stats", action="store_true",
                    help="record the committed clips' transform blocks")
    ap.add_argument("configs", nargs="*",
                    help="names under configs/, or paths of config files")
    args = ap.parse_args(argv)
    paths = [Path(c) if c.endswith(".json") else HERE / "configs" / f"{c}.json"
             for c in args.configs] or sorted((HERE / "configs").glob("*.json"))
    for path in paths:
        if args.tx_stats:
            tx_stats(path)
        else:
            make(path, args.check)


if __name__ == "__main__":
    main()
