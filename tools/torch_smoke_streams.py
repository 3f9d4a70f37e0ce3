"""Generate the streams and md5s that dav1d_tpu_torch commits for its
GPU smoke run (dav1d_tpu_torch/data/).

The machine that runs chip_smoke.py has neither libaom nor jax, so the
streams and their expected md5s are made here and committed:

- ``inter_1080p_8bit.ivf``: bench.py's 1080p 8-bit 4:2:0 inter stream
  (libaom cpu_used=8, q=45, 4 frames, bench.py:_make_stream);
- ``hbd10_128x96.ivf``: tests/test_device_e2e.CASES["hbd10"]
  (128x96 10-bit, 3 frames);
- ``superres_lr_1080p_8bit.ivf``: 1080p 8-bit 4:2:0, 4 frames, libaom
  cpu_used=4, q=45 with super-res (every frame coded 960 wide and
  upscaled to 1920) and loop restoration (Wiener on every plane);
- ``lr_1080p_8bit.ivf``: the same settings without super-res: loop
  restoration at full width, with self-guided units in the key frame;
- ``grain_1080p_8bit.ivf``: 1080p 8-bit 4:2:0, 4 frames, libaom
  cpu_used=8, q=45 with film grain (denoise-noise-level=25, the
  tests/test_device_e2e.CASES["grain"] option at full width);
- ``grain_hbd10_352x288.ivf``: the same option at 352x288 10-bit, 3
  frames (the 10-bit grain LUTs and the scaling's sub-interpolation);
- ``screen_1080p_8bit.ivf``: two 1080p key frames of
  tests/test_device_intra.screen_frames with palette coding
  (enable-palette=1, enable-intrabc=0, tune-content=screen), the
  highest cpu_used that still codes palette blocks;
- the layouts beside 4:2:0 at 8 and 10 bits, at 256x192, 4 frames
  (1 key + 3 inter), libaom cpu_used=4, q=40, loop restoration on:
  ``i422_8bit_256x192.ivf`` (4:2:2 8-bit), ``i444_10bit_256x192.ivf``
  (4:4:4 10-bit), ``i420_12bit_256x192.ivf`` (4:2:0 12-bit) and
  ``mono_8bit_256x192.ivf`` (monochrome 8-bit);
- ``gop_1080p_8bit.ivf``: the main stream's settings at 8 frames with
  ``kf_max_dist=4``, so two key-frame-led GOPs (the GOP-parallel and
  relay decodes of dav1d_tpu_torch/gop.py on the card);
- ``tiles2x2_256x192.ivf``: __graft_entry__.dryrun_multichip's stream
  (256x192 8-bit, 4 frames, libaom cpu_used=6, q=40, kf_max_dist=4,
  2x2 tiles), for dav1d_tpu_torch/entry.dryrun_multichip.

With ``--features``, the tool makes the feature streams instead
(``dav1d_tpu_torch/data/features/``, :data:`FEATURES`): one stream per
libaom recipe of tests/test_e2e_aom.py, ``CASES`` and ``SCREEN_CASES``
(the recipes imported from that file, each encoded with its own
``gradient_frames`` / ``screen_frames`` arguments), and the two streams of
its ``test_containers_annexb_section5`` (128x96, 4 frames: one written
with ``save_as_annexb``, one section-5 ``.obu``).  Their md5s are the
JAX package's host tier in BOTH its modes, fused (``Settings()``, the
default) and two-pass (``Settings(two_pass=True)``); the tool refuses
to write a stream whose two md5s differ.  ``features/md5.json`` holds,
per stream, its frames, md5, size, bit depth, layout, bytes, the coded
sizes and super-res denominators of its pictures and the features its
frame headers carry (:func:`_carries`).

The md5 of each stream is the JAX package's host tier
(DAV1D_TPU_DEVICE=0) over every plane of every output picture, in the
tests/test_device_e2e._decode_md5 convention.  For the streams of
``CLI_STREAMS`` two more fields come from the JAX package's own tools,
each in a subprocess on its host tier: ``cli_md5``, the digest that
``tools/dav1d_tpu_cli.py --muxer md5`` prints (film grain off, as that
muxer's default), and ``ppm_md5``, the md5 over the files that
``tools/dav1d_tpu_play.py --ppm DIR --limit 2`` writes, in name order.

Run from the repository root (with names, only those streams are
made and only their md5 entries replaced; ``--no-encode`` keeps the
committed files and only recomputes their entries):

    python tools/torch_smoke_streams.py [--no-encode] [name.ivf ...]
    python tools/torch_smoke_streams.py --features [--no-encode] [name ...]
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT / "tests"))

OUT = ROOT / "dav1d_tpu_torch" / "data"

STREAMS = {
    "inter_1080p_8bit.ivf": dict(
        n=4, w=1920, h=1080, bitdepth=8,
        enc=dict(usage="good", cpu_used=8, q=45, kf_max_dist=9999, lag=0,
                 options={"enable-order-hint": 1})),
    "hbd10_128x96.ivf": dict(
        n=3, w=128, h=96, bitdepth=10,
        enc=dict(usage="good", kf_max_dist=9999)),
    "superres_lr_1080p_8bit.ivf": dict(
        n=4, w=1920, h=1080, bitdepth=8,
        enc=dict(usage="good", cpu_used=4, q=45, kf_max_dist=9999, lag=0,
                 superres=(1, 16, 16, 63, 63),
                 options={"enable-order-hint": 1,
                          "enable-restoration": 1})),
    "lr_1080p_8bit.ivf": dict(
        n=4, w=1920, h=1080, bitdepth=8,
        enc=dict(usage="good", cpu_used=4, q=45, kf_max_dist=9999, lag=0,
                 options={"enable-order-hint": 1,
                          "enable-restoration": 1})),
    "grain_1080p_8bit.ivf": dict(
        n=4, w=1920, h=1080, bitdepth=8,
        enc=dict(usage="good", cpu_used=8, q=45, kf_max_dist=9999, lag=0,
                 options={"enable-order-hint": 1,
                          "denoise-noise-level": 25})),
    "grain_hbd10_352x288.ivf": dict(
        n=3, w=352, h=288, bitdepth=10,
        enc=dict(usage="good", kf_max_dist=9999,
                 options={"denoise-noise-level": 25})),
    "screen_1080p_8bit.ivf": dict(
        n=2, w=1920, h=1080, bitdepth=8, frames="screen",
        enc=dict(usage="good", cpu_used=8, q=40, kf_max_dist=1, lag=0,
                 options={"enable-palette": 1, "enable-intrabc": 0,
                          "tune-content": "screen"})),
}
for _name, _fmt, _bd, _mono in (("i422_8bit_256x192.ivf", "422", 8, False),
                                ("i444_10bit_256x192.ivf", "444", 10, False),
                                ("i420_12bit_256x192.ivf", "420", 12, False),
                                ("mono_8bit_256x192.ivf", "420", 8, True)):
    STREAMS[_name] = dict(
        n=4, w=256, h=192, bitdepth=_bd, fmt=_fmt, monochrome=_mono,
        enc=dict(usage="good", cpu_used=4, q=40, kf_max_dist=9999, lag=0,
                 fmt=_fmt, monochrome=_mono,
                 options={"enable-order-hint": 1,
                          "enable-restoration": 1}))
STREAMS["gop_1080p_8bit.ivf"] = dict(
    STREAMS["inter_1080p_8bit.ivf"], n=8,
    enc=dict(STREAMS["inter_1080p_8bit.ivf"]["enc"], kf_max_dist=4))
STREAMS["tiles2x2_256x192.ivf"] = dict(
    n=4, w=256, h=192, bitdepth=8,
    enc=dict(usage="good", cpu_used=6, q=40, kf_max_dist=4, lag=0,
             options={"tile-columns": 1, "tile-rows": 1}))
# streams whose entries also hold the JAX CLI's and player's digests
CLI_STREAMS = ("inter_1080p_8bit.ivf",)


def _feature_streams():
    """name -> recipe of every feature stream: the recipes of
    tests/test_e2e_aom.py (imported, not copied) and the two streams of
    its container test."""
    from test_e2e_aom import CASES, SCREEN_CASES, _args

    out = {}
    for group, cases, frames in (("CASES", CASES, "gradient"),
                                 ("SCREEN_CASES", SCREEN_CASES, "screen")):
        for name, (gen, enc) in cases.items():
            out[name] = dict(group=group, frames=frames, gen=dict(gen),
                             enc=dict(enc), file=f"{name}.ivf",
                             container="ivf")
    # test_containers_annexb_section5: 128x96, 4 frames, cpu_used=6
    for name, container, raw in (("containers_annexb", "annexb",
                                  {"save_as_annexb": 1}),
                                 ("containers_section5", "section5", None)):
        enc = _args(cpu_used=6)
        if raw:
            enc["cfg_raw"] = raw
        out[name] = dict(group="test_containers_annexb_section5",
                         frames="gradient", gen=dict(n=4), enc=enc,
                         file=f"{name}.obu", container=container)
    return out


FEATURES = _feature_streams()
FEATURES_OUT = OUT / "features"


def _frames(spec):
    from aom_enc import gradient_frames

    n, w, h, bd = spec["n"], spec["w"], spec["h"], spec["bitdepth"]
    if spec.get("frames") == "screen":
        from test_device_intra import screen_frames

        return screen_frames(n, w, h, bitdepth=bd)
    return gradient_frames(n, w, h, bitdepth=bd,
                           fmt=spec.get("fmt", "420"),
                           monochrome=spec.get("monochrome", False))


def _host_md5(data: bytes):
    from dav1d_tpu.containers import read_ivf
    from dav1d_tpu.decoder import Decoder, Settings

    dec = Decoder(Settings(two_pass=True, max_frame_delay=4))
    h = hashlib.md5()
    n = 0
    for tu, _ in read_ivf(data):
        dec.send_data(tu)
        while (pic := dec.get_picture()) is not None:
            for pl in range(len(pic.planes)):
                h.update(pic.plane_bytes(pl))
            n += 1
    return n, h.hexdigest()


def _feature_frames(spec):
    from aom_enc import gradient_frames
    from test_e2e_aom import screen_frames

    gen = dict(spec["gen"])
    n = gen.pop("n")
    w, h = spec["enc"]["width"], spec["enc"]["height"]
    make = screen_frames if spec["frames"] == "screen" else gradient_frames
    return make(n, w, h, **gen)


def _carries(pics) -> list:
    """The coding features the pictures' headers show."""
    tags = set()
    for p in pics:
        hdr, seq = p.frame_hdr, p.seq_hdr
        tags.add(hdr.frame_type.name.lower() + "_frame")
        tags.add("sb128" if seq.sb128 else "sb64")
        if hdr.all_lossless:
            tags.add("lossless")
        if hdr.width[0] != hdr.width[1]:
            tags.add("superres")
        if hdr.allow_intrabc:
            tags.add("intrabc")
        if hdr.allow_screen_content_tools:
            tags.add("screen_content_tools")
        if hdr.film_grain.present:
            tags.add("film_grain")
        if hdr.segmentation.enabled:
            tags.add("segmentation")
        if hdr.delta.q_present:
            tags.add("delta_q")
        if hdr.delta.lf_present:
            tags.add("delta_lf")
        if hdr.tiling.cols * hdr.tiling.rows > 1:
            tags.add(f"tiles_{hdr.tiling.cols}x{hdr.tiling.rows}")
        if any(int(t) for t in hdr.restoration.type):
            tags.add("restoration")
        if seq.cdef and not hdr.all_lossless and (
                any(hdr.cdef.y_strength) or any(hdr.cdef.uv_strength)):
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
    if len({(p.width, p.height) for p in pics}) > 1:
        tags.add("frame_size_change")
    return sorted(tags)


def _jax_pictures(data: bytes, container: str, two_pass: bool):
    """Every output picture of the JAX host tier's decode of ``data``:
    fused (``Settings()``) or two-pass."""
    from dav1d_tpu.containers import open_stream, read_ivf
    from dav1d_tpu.decoder import Decoder, Settings

    dec = Decoder(Settings(two_pass=True) if two_pass else Settings())
    units = read_ivf(data) if container == "ivf" else open_stream(data)
    pics = []
    for tu, _ in units:
        dec.send_data(tu)
        while (pic := dec.get_picture()) is not None:
            pics.append(pic)
    return pics


def _pictures_md5(pics) -> str:
    h = hashlib.md5()
    for pic in pics:
        for pl in range(len(pic.planes)):
            h.update(pic.plane_bytes(pl))
    return h.hexdigest()


def _feature_entry(name, spec, data: bytes) -> dict:
    """A feature stream's md5.json entry, from the JAX host tier's
    decodes in both modes; raises where the two md5s differ."""
    two = _jax_pictures(data, spec["container"], two_pass=True)
    md5 = _pictures_md5(two)
    fused = _pictures_md5(_jax_pictures(data, spec["container"],
                                        two_pass=False))
    if fused != md5:
        raise SystemExit(f"{name}: the JAX host tier's fused md5 {fused} "
                         f"differs from its two-pass md5 {md5}; not "
                         "written")
    p0 = two[0]
    denoms = sorted({p.frame_hdr.super_res_width_scale_denominator
                     for p in two
                     if p.frame_hdr.width[0] != p.frame_hdr.width[1]})
    return {"frames": len(two), "md5": md5, "width": spec["enc"]["width"],
            "height": spec["enc"]["height"], "bitdepth": p0.bitdepth,
            "layout": p0.layout.name, "bytes": len(data),
            "container": spec["container"], "recipe": spec["group"],
            "sizes": sorted({(p.width, p.height) for p in two}),
            "superres_denominators": denoms, "carries": _carries(two)}


def features_main(names, encode: bool) -> None:
    from aom_enc import AomEncoder, write_ivf_packets

    FEATURES_OUT.mkdir(parents=True, exist_ok=True)
    md5_path = FEATURES_OUT / "md5.json"
    md5s = json.loads(md5_path.read_text()) if md5_path.exists() else {}
    for name in names or list(FEATURES):
        spec = FEATURES[name]
        path = FEATURES_OUT / spec["file"]
        if encode:
            enc = AomEncoder(**spec["enc"])
            pkts = enc.encode(_feature_frames(spec))
            enc.close()
            if spec["container"] == "ivf":
                write_ivf_packets(path, pkts, spec["enc"]["width"],
                                  spec["enc"]["height"])
            else:
                path.write_bytes(b"".join(d for _, d in pkts))
        t0 = time.perf_counter()
        entry = _feature_entry(name, spec, path.read_bytes())
        md5s[spec["file"]] = entry
        print(spec["file"], entry, f"({time.perf_counter() - t0:.1f} s)",
              flush=True)
        # written after each stream: the 4K recipe's fused decode is long
        files = {FEATURES[k]["file"]: k for k in FEATURES}
        md5_path.write_text(json.dumps(
            {f: md5s[f] for f in sorted(files) if f in md5s}, indent=1)
            + "\n")


def _tool_md5s(path: Path) -> dict:
    """``cli_md5`` and ``ppm_md5`` of a stream, from the JAX package's
    CLI and player run on its host tier."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", DAV1D_TPU_DEVICE="0")
    r = subprocess.run([sys.executable, str(ROOT / "tools" /
                                            "dav1d_tpu_cli.py"),
                        "-i", str(path), "--muxer", "md5", "-o", "-", "-q"],
                       capture_output=True, text=True, env=env, check=True)
    with tempfile.TemporaryDirectory() as d:
        subprocess.run([sys.executable, str(ROOT / "tools" /
                                            "dav1d_tpu_play.py"),
                        "-i", str(path), "--ppm", d, "--limit", "2"],
                       capture_output=True, env=env, check=True)
        h = hashlib.md5()
        for f in sorted(Path(d).iterdir()):
            h.update(f.read_bytes())
    return {"cli_md5": r.stdout.split()[0], "ppm_md5": h.hexdigest()}


def main() -> None:
    os.environ["DAV1D_TPU_DEVICE"] = "0"
    from aom_enc import AomEncoder, write_ivf_packets

    args = sys.argv[1:]
    encode = "--no-encode" not in args
    if "--features" in args:
        features_main([a for a in args if not a.startswith("--")], encode)
        return
    OUT.mkdir(parents=True, exist_ok=True)
    names = [a for a in args if a != "--no-encode"] or list(STREAMS)
    md5_path = OUT / "md5.json"
    md5s = json.loads(md5_path.read_text()) if md5_path.exists() else {}
    for name in names:
        spec = STREAMS[name]
        w, h, bd = spec["w"], spec["h"], spec["bitdepth"]
        path = OUT / name
        if encode:
            enc = AomEncoder(width=w, height=h, bitdepth=bd, **spec["enc"])
            pkts = enc.encode(_frames(spec))
            enc.close()
            write_ivf_packets(path, pkts, w, h)
        n, md5 = _host_md5(path.read_bytes())
        md5s[name] = {"frames": n, "md5": md5, "width": w, "height": h,
                      "bitdepth": bd, "bytes": path.stat().st_size}
        if name in CLI_STREAMS:
            md5s[name].update(_tool_md5s(path))
        print(name, md5s[name], flush=True)
    md5s = {k: md5s[k] for k in STREAMS if k in md5s}
    md5_path.write_text(json.dumps(md5s, indent=1) + "\n")


if __name__ == "__main__":
    main()
