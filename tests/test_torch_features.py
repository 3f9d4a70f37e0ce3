"""The JAX suite's AV1 feature streams through the port on the CPU,
bit-exact (tolerance 0), part A, and the shared helpers of
tests/test_torch_features_*.py.

The streams are committed (dav1d_tpu_torch/data/features/, made by
``tools/torch_smoke_streams.py --features``): one per libaom recipe of
tests/test_e2e_aom.py ``CASES`` and ``SCREEN_CASES`` and the annexb and
section-5 streams of its ``test_containers_annexb_section5``, each with
the JAX package's host-tier md5 (equal in its fused and two-pass modes)
in ``features/md5.json``.  Nothing is encoded here.

For every stream up to 384x256 (``SMALL``), split between this file
(``PART``) and tests/test_torch_features_b.py (``PART_B``):

* the JAX package's host tier (DAV1D_TPU_DEVICE=0), decoded live in its
  two-pass and its fused mode, equals md5.json;
* the port's ``Decoder(device="cpu")`` equals md5.json in fused mode
  (``Settings()``: no itx and no MC call, the chain from host planes),
  in two-pass mode (every transform block with coefficients through the
  itx stage) and in two-pass mode with ``device_intra=True``.

The 720p and 1080p streams run two-pass only in
tests/test_torch_features_hd.py, the 4K stream in
tests/test_torch_features_4k.py; their fused and device-intra decodes
run on the card (chip_smoke.py phase 7).

Also here: every md5.json entry has its file, size and frame count; the
stream tool's ``FEATURES`` names every recipe of tests/test_e2e_aom.py;
and one counter per feature (lossless frames: WHT_WHT jobs only and no
deblock, CDEF or restoration call; super-res: a resize call on exactly
the frames whose denominator is not 8; scaled references: inter blocks
left to the host; intrabc frames to the host walk with device intra;
film grain: one fg call per grained plane; 12-bit: int32 residuals;
compound average blocks: predicted by the MC call; fused mode: the
chain's calls of two-pass mode, frame by frame).

Cases: 2 + 4 x 17 decodes of part A + 13 counters + 11 fused-chain
pairs.  Time alone in one process: ~75 s (part A's streams ~55 s).
"""

import collections
import hashlib
import json
import sys
from pathlib import Path

import pytest
import torch

from chip_smoke import check_ref_slots
from test_torch_decode import _device_env, _refusing_dispatch

REPO = Path(__file__).resolve().parent.parent
FEAT = REPO / "dav1d_tpu_torch" / "data" / "features"
MD5 = json.loads((FEAT / "md5.json").read_text())
STREAMS = sorted(MD5)
# streams held in every mode on the CPU
SMALL_PIXELS = 384 * 256
SMALL = [s for s in STREAMS
         if MD5[s]["width"] * MD5[s]["height"] <= SMALL_PIXELS]
LARGE = [s for s in STREAMS if s not in SMALL]
# chain calls (devrt.call tags) of the in-loop filters
FILTER_TAGS = ("deblock", "cdef_dir", "cdef_filter", "lr_wiener", "lr_sgr")
CHAIN_TAGS = FILTER_TAGS + ("resize",)
WHT_WHT = 16


# part A: the small streams whose decodes the counters below read (each
# decoded once a process, in test_port_md5), and long_gop, so that the
# two parts take about the same time; part B
# (tests/test_torch_features_b.py) holds the other small streams
PART = sorted(["grain.ivf", "grain_10bit.ivf", "hbd12.ivf", "i422.ivf",
               "kitchen_sink.ivf", "long_gop.ivf", "lossless.ivf",
               "monochrome.ivf", "resize_refs.ivf", "restoration_444_odd.ivf",
               "sb64.ivf", "screen.ivf", "screen_10bit.ivf",
               "screen_cpu0.ivf", "screen_odd.ivf", "sframe.ivf",
               "superres_lr.ivf", "superres_random.ivf"])
PART_B = [s for s in SMALL if s not in PART]


def units(name, data, port=True):
    """The temporal units of a committed stream, through the port's
    containers (or the JAX package's)."""
    if port:
        from dav1d_tpu_torch.containers import open_stream, read_ivf
    else:
        from dav1d_tpu.containers import open_stream, read_ivf
    if MD5[name]["container"] == "ivf":
        return read_ivf(data)
    return open_stream(data)


def _md5(dec, tus):
    h = hashlib.md5()
    n = 0
    for tu, _ in tus:
        dec.send_data(tu)
        while (pic := dec.get_picture()) is not None:
            for pl in range(len(pic.planes)):
                h.update(pic.plane_bytes(pl))
            n += 1
    return n, h.hexdigest()


def want(name):
    return MD5[name]["frames"], MD5[name]["md5"]


def jax_md5(name, two_pass):
    """The JAX package's host tier, fused (``Settings()``) or two-pass."""
    from dav1d_tpu.decoder import Decoder, Settings

    data = (FEAT / name).read_bytes()
    with _device_env(DAV1D_TPU_DEVICE="0"):
        return _md5(Decoder(Settings(two_pass=two_pass)),
                    units(name, data, port=False))


def _itx_rec():
    return {"jobs": 0, "txtp": set(), "dtype": set()}


class Log:
    """What the port's decode did, frame by frame: wraps the decoder's
    ``decode_frame_finish`` (pass 2 and the chain of one frame; frames
    finish in decode order), ``devrt.call`` (each device call's tag; for
    itx, the job table's tx types and the residuals' dtype, per frame:
    the itx call runs in pass 1, before earlier frames finish) and
    ``recon/filmgrain.apply_grain`` (grained planes and fg calls a
    picture)."""

    def __init__(self):
        self.frames, self.grain = [], []
        self.calls = collections.Counter()
        self._itx = {}

    def __enter__(self):
        from dav1d_tpu_torch import decoder, devrt, pipeline
        from dav1d_tpu_torch.recon import filmgrain

        self._saved = (decoder.decode_frame_finish, devrt.call,
                       pipeline._launch_residuals_native,
                       filmgrain.apply_grain)
        finish, call, residuals, grain = self._saved
        cur = {}

        def logged_call(tag, fn, *args, **kw):
            self.calls[tag] += 1
            out = call(tag, fn, *args, **kw)
            if tag == "itx" and "f" in cur:
                rec = self._itx.setdefault(id(cur["f"]), _itx_rec())
                rec["jobs"] += int(args[1].shape[0])
                rec["txtp"].update(args[1][:, 2].tolist())
                rec["dtype"].add(str(out.dtype))
            return out

        def logged_residuals(f):
            cur["f"] = f
            try:
                return residuals(f)
            finally:
                cur.pop("f", None)

        def logged_finish(f):
            c0 = collections.Counter(devrt.COUNTS)
            k0 = collections.Counter(self.calls)
            finish(f)
            hdr = f.frame_hdr
            refs = [s for s in (f.refp or []) if s is not None
                    and s.frame_hdr is not None]
            itx = self._itx.pop(id(f), _itx_rec())
            self.frames.append({
                "lossless": bool(hdr.all_lossless),
                "superres": hdr.width[0] != hdr.width[1],
                "denominator": hdr.super_res_width_scale_denominator,
                "intrabc": bool(hdr.allow_intrabc),
                "scaled_refs": sum(
                    (s.frame_hdr.width[1], s.frame_hdr.height)
                    != (hdr.width[0], hdr.height) for s in refs),
                "refs": len(refs),
                "counts": collections.Counter(devrt.COUNTS) - c0,
                "calls": self.calls - k0,
                "itx_jobs": itx["jobs"], "itx_txtp": itx["txtp"],
                "itx_dtype": itx["dtype"]})

        def logged_grain(pic, device, dev_planes=None):
            planes = len(filmgrain.grain_tables(pic)[1])
            k0 = self.calls["fg"]
            grain(pic, device, dev_planes)
            self.grain.append((planes, self.calls["fg"] - k0))

        decoder.decode_frame_finish = logged_finish
        devrt.call = logged_call
        pipeline._launch_residuals_native = logged_residuals
        filmgrain.apply_grain = logged_grain
        return self

    def __exit__(self, *exc):
        from dav1d_tpu_torch import decoder, devrt, pipeline
        from dav1d_tpu_torch.recon import filmgrain

        (decoder.decode_frame_finish, devrt.call,
         pipeline._launch_residuals_native,
         filmgrain.apply_grain) = self._saved
        return False


def port_decode(name, two_pass, device_intra=False, mesh=None):
    """The port's (frames, md5) on the CPU and its :class:`Log`; devrt
    .COUNTS hold the decode's counts afterwards, and every reference
    slot's host planes equal its device planes (chip_smoke.py
    ``check_ref_slots``).  One intra-op thread
    (tests/test_torch_decode._port_md5: the suite's workers share the
    cores)."""
    from dav1d_tpu_torch import devrt
    from dav1d_tpu_torch.decoder import Decoder, Settings

    data = (FEAT / name).read_bytes()
    devrt.COUNTS.clear()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with _device_env(), _refusing_dispatch() as asked, Log() as log:
            dec = Decoder(Settings(two_pass=two_pass, mesh=mesh),
                          device="cpu", device_intra=device_intra)
            got = _md5(dec, units(name, data))
            # every reference slot's host planes equal its resident ones
            check_ref_slots(dec)
            dec.close()
    finally:
        torch.set_num_threads(threads)
    assert asked == [], f"the port consulted dav1d_tpu.dispatch: {asked}"
    return got, log


# (name, mode) -> (frames and md5, Log, devrt.COUNTS) of this process's
# port decodes: a counter test reads the decode of test_port_md5 where
# its file decoded that stream (xdist's --dist loadfile keeps a file in
# one worker)
_DECODES = {}


def check_port(name, mode):
    """Decode ``name`` with the port in ``mode`` (fused, two_pass,
    device_intra) against md5.json, once a process; returns the
    :class:`Log` and the decode's devrt.COUNTS."""
    from dav1d_tpu_torch import devrt

    if (name, mode) not in _DECODES:
        got, log = port_decode(name, two_pass=mode != "fused",
                               device_intra=mode == "device_intra")
        _DECODES[name, mode] = got, log, collections.Counter(devrt.COUNTS)
    got, log, counts = _DECODES[name, mode]
    assert got == want(name), f"{name} [{mode}]: port {got}, want " \
        f"{want(name)}"
    for i, fr in enumerate(log.frames):
        # one resize call on every super-res frame, none elsewhere
        assert fr["calls"]["resize"] == int(fr["superres"]), (name, i, fr)
        if fr["lossless"]:
            # a coded-lossless frame: every in-loop filter is off
            assert not any(fr["calls"][t] for t in CHAIN_TAGS), (name, i, fr)
    if "film_grain" in MD5[name]["carries"]:
        # one fg call per grained plane, on every picture
        assert len(log.grain) == MD5[name]["frames"], log.grain
        assert all(p > 0 and c == p for p, c in log.grain), log.grain
    if mode == "fused":
        # pass 1 reconstructs on the host: no itx and no MC work
        assert not log.calls["itx"] and not log.calls["mc"], log.calls
        assert counts["itx_blocks"] == counts["mc_blocks"] == 0, counts
    else:
        assert counts["itx_blocks"] > 0 and log.calls["itx"] > 0, counts
    return log, counts


def check_jax(name, mode):
    got = jax_md5(name, two_pass=mode == "two_pass")
    assert got == want(name), f"{name} [{mode}]: JAX host tier {got}, " \
        f"want {want(name)}"


# ---- the committed streams ------------------------------------------------

def test_md5_json_entries_have_their_files():
    for name, e in MD5.items():
        path = FEAT / name
        assert path.is_file(), name
        data = path.read_bytes()
        assert len(data) == e["bytes"] > 0, name
        assert e["container"] in ("ivf", "annexb", "section5"), name
        # one temporal unit a shown picture (libaom's packets)
        assert len(list(units(name, data))) == e["frames"] > 0, name
        assert len(e["md5"]) == 32, name
        assert e["bitdepth"] in (8, 10, 12), name
        assert e["layout"] in ("I400", "I420", "I422", "I444"), name
    total = sum(p.stat().st_size for p in FEAT.iterdir())
    assert total < 600 * 1024, f"features/ holds {total} bytes"


def test_parts_cover_the_small_streams():
    assert set(PART) <= set(SMALL) and set(PART) | set(PART_B) == set(SMALL)
    assert all(s in PART for s in CHAIN_PAIRS)


def test_features_name_every_recipe():
    sys.path.insert(0, str(REPO / "tools"))
    import torch_smoke_streams as tss
    from test_e2e_aom import CASES, SCREEN_CASES

    want_names = set(CASES) | set(SCREEN_CASES) | {
        "containers_annexb", "containers_section5"}
    assert set(tss.FEATURES) == want_names
    files = {spec["file"] for spec in tss.FEATURES.values()}
    assert files == set(MD5), files ^ set(MD5)
    for name, spec in tss.FEATURES.items():
        recipe = {**CASES, **SCREEN_CASES}.get(name)
        if recipe is not None:
            # the recipe itself, not a copy of it
            assert spec["enc"] == recipe[1] and spec["gen"] == recipe[0]


@pytest.mark.parametrize("mode", ["two_pass", "fused"])
@pytest.mark.parametrize("name", PART)
def test_jax_host_tier_md5(name, mode):
    check_jax(name, mode)


@pytest.mark.parametrize("mode", ["fused", "two_pass", "device_intra"])
@pytest.mark.parametrize("name", PART)
def test_port_md5(name, mode):
    check_port(name, mode)


# ---- one counter per feature ---------------------------------------------

def test_lossless_frames_wht_only_no_filters():
    log, _ = check_port("lossless.ivf", "two_pass")
    lossless = [fr for fr in log.frames if fr["lossless"]]
    assert lossless, "no coded-lossless frame"
    for fr in lossless:
        assert fr["itx_jobs"] > 0 and fr["itx_txtp"] == {WHT_WHT}, fr
        assert not any(fr["calls"][t] for t in FILTER_TAGS), fr["calls"]
        assert not fr["calls"]["resize"], fr["calls"]


@pytest.mark.parametrize("name", ["superres_random.ivf", "superres_lr.ivf"])
def test_superres_resize_on_scaled_frames(name):
    """A resize call on exactly the frames whose denominator is not 8.
    With this libaom, the superres_random recipe (mode 3, q-threshold 30)
    codes every frame at denominator 8: no super-res frame, no call."""
    log, _ = check_port(name, "two_pass")
    denoms = [fr["denominator"] for fr in log.frames]
    for fr, d in zip(log.frames, denoms):
        assert fr["calls"]["resize"] == int(d != 8) == int(fr["superres"])
    want_denoms = {"superres_random.ivf": {8}, "superres_lr.ivf": {16}}
    assert set(denoms) == want_denoms[name], denoms


def test_resize_refs_scaled_blocks_to_the_host():
    log, _ = check_port("resize_refs.ivf", "two_pass")
    scaled = [fr for fr in log.frames if fr["scaled_refs"]]
    assert scaled, "no frame with a scaled reference"
    for fr in scaled:
        if fr["scaled_refs"] == fr["refs"]:
            # every reference scaled: no block for the device MC
            assert fr["counts"]["mc_blocks"] == 0, fr["counts"]
    left = sum(fr["counts"]["inter_blocks"] - fr["counts"]["mc_blocks"]
               for fr in scaled)
    assert left > 0


@pytest.mark.parametrize("name", ["screen.ivf", "screen_cpu0.ivf",
                                  "screen_odd.ivf", "screen_10bit.ivf"])
def test_screen_intrabc_frames_to_the_host_walk(name):
    log, counts = check_port(name, "device_intra")
    host = [fr["counts"]["intra_host_frames"] for fr in log.frames]
    for fr, h in zip(log.frames, host):
        if fr["intrabc"]:
            assert h == 1, fr
    assert counts["intra_host_frames"] == sum(host)
    # of these recipes only screen codes intrabc frames (md5.json
    # "carries"); the others' frames walk on the device
    assert any(fr["intrabc"] for fr in log.frames) == (name == "screen.ivf")
    assert counts["intra_walk_launches"] > 0


@pytest.mark.parametrize("name", ["grain.ivf", "grain_10bit.ivf"])
def test_grain_one_call_per_grained_plane(name):
    log, _ = check_port(name, "two_pass")
    assert len(log.grain) == MD5[name]["frames"]
    assert all(planes > 0 and calls == planes for planes, calls in log.grain)


def test_hbd12_int32_residuals():
    log, _ = check_port("hbd12.ivf", "two_pass")
    dtypes = set().union(*(fr["itx_dtype"] for fr in log.frames))
    assert dtypes == {"torch.int32"}, dtypes


@pytest.mark.parametrize("name,compound", [("kitchen_sink.ivf", 30),
                                           ("long_gop.ivf", 11)])
def test_compound_average_blocks_on_the_device_mc(name, compound):
    """The streams' CT_AVG and CT_WEIGHTED_AVG blocks (kitchen_sink: 22
    and 8, beside CT_SEG, CT_WEDGE, OBMC, warp and interintra blocks;
    long_gop: 11 CT_AVG beside CT_SEG) go to the MC call, counted in
    mc_blocks too, and the two-pass decode holds its md5."""
    _, counts = check_port(name, "two_pass")
    assert counts["mc_compound_blocks"] == compound, counts
    assert counts["mc_blocks"] > compound, counts


# the streams whose fused decode is held against the two-pass one call by
# call: every frame kind of the suite
CHAIN_PAIRS = ["kitchen_sink.ivf", "lossless.ivf", "superres_random.ivf",
               "resize_refs.ivf", "restoration_444_odd.ivf", "sframe.ivf",
               "grain_10bit.ivf", "sb64.ivf", "hbd12.ivf", "i422.ivf",
               "monochrome.ivf"]


@pytest.mark.parametrize("name", CHAIN_PAIRS)
def test_fused_chain_as_two_pass(name):
    """Fused mode runs the chain's calls of two-pass mode, frame by
    frame, and no itx or MC call."""
    fused, _ = check_port(name, "fused")
    two, _ = check_port(name, "two_pass")
    assert len(fused.frames) == len(two.frames)
    for i, (a, b) in enumerate(zip(fused.frames, two.frames)):
        ca = {t: a["calls"][t] for t in CHAIN_TAGS}
        cb = {t: b["calls"][t] for t in CHAIN_TAGS}
        assert ca == cb, f"{name} frame {i}: fused {ca}, two-pass {cb}"
        assert not a["calls"]["itx"] and not a["calls"]["mc"]
