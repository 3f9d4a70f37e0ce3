"""The port's film grain against a plain PyTorch reference written from
the AV1 specification (``reference/film_grain.py``, section 7.18.3: the
whole noise image of 34-row stripes, not dav1d's 32x32 blocks), exactly.

Two paths of the port are held against it on seeded random grain
parameters and seeded random planes: ``recon/filmgrain.apply_grain`` on
the CPU (the decoder's device path run by its plain versions: the
uploads, one plain pass a plane, the narrow downloads) and the native
host tier ``_apply_grain_native``.  The cases cover bit depths 8, 10 and
12; 4:2:0, 4:2:2, 4:4:4 and 4:0:0; ``ar_coeff_lag`` 0-3; overlap on and
off; chroma scaled from luma and through its own points; chroma alone
(4:2:2 and 4:4:4) and luma alone; restricted and full range; the
identity matrix; odd sizes whose last stripe and last block are short.

The benchmark's copy of the reference (``av1bench/reference/``) is byte
for byte this one, and the reference imports neither JAX nor either
decoder package."""

from __future__ import annotations

import ast
import importlib.util
import itertools
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from dav1d_tpu_torch.headers import FilmGrainData, PixelLayout
from dav1d_tpu_torch.recon import filmgrain

REPO = Path(__file__).resolve().parent.parent
REF = REPO / "reference" / "film_grain.py"
BENCH_REF = REPO / "av1bench" / "reference" / "film_grain.py"


def _load(path):
    spec = importlib.util.spec_from_file_location("film_grain_spec", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # a dataclass looks up its module
    spec.loader.exec_module(mod)
    return mod


ref = _load(REF)

LAYOUTS = {"420": PixelLayout.I420, "422": PixelLayout.I422,
           "444": PixelLayout.I444, "400": PixelLayout.I400}
SIZES = [(64, 48), (99, 67), (67, 99), (97, 35)]  # (w, h)
# which planes carry scaling points: all; chroma from luma; luma alone;
# chroma alone (not in 4:2:0, where chroma points need luma points)
POINTS = ("all", "csfl", "luma", "chroma")


def _cases():
    out = []
    for n, (bd, lay) in enumerate(itertools.product((8, 10, 12), LAYOUTS)):
        for v, points in enumerate(POINTS):
            if lay == "400" and points in ("csfl", "chroma"):
                continue
            if lay == "420" and points == "chroma":
                continue
            restricted = (n + v) % 2
            out.append(dict(
                bitdepth=bd, layout=lay, points=points, lag=(n + v) % 4,
                overlap=(n // 2 + v) % 2, restricted=restricted,
                identity=int(restricted and v % 2 == 0 and n % 3 == 0),
                size=SIZES[(n + v) % len(SIZES)], seed=1000 + 10 * n + v))
    return out


CASES = _cases()


def _case_id(c):
    return (f"bd{c['bitdepth']}-{c['layout']}-{c['points']}-lag{c['lag']}"
            f"-ov{c['overlap']}-rr{c['restricted']}-id{c['identity']}"
            f"-{c['size'][0]}x{c['size'][1]}")


def _scaling_points(rng, n):
    xs = np.sort(rng.choice(256, n, replace=False))
    return [(int(x), int(rng.integers(0, 256))) for x in xs]


def _params(rng, c):
    """Random grain parameters of the case, as the header parser fills
    them (dav1d's form: signed coefficients, multipliers and offsets)."""
    d = FilmGrainData()
    d.seed = int(rng.integers(0, 1 << 16))
    luma = c["points"] != "chroma"
    d.num_y_points = int(rng.integers(1, 15)) if luma else 0
    d.y_points = _scaling_points(rng, d.num_y_points)
    d.chroma_scaling_from_luma = int(c["points"] == "csfl")
    for uv in range(2):
        own = c["points"] in ("all", "chroma") and c["layout"] != "400"
        n = int(rng.integers(1, 11)) if own else 0
        d.num_uv_points[uv] = n
        d.uv_points[uv] = _scaling_points(rng, n)
        if n:
            d.uv_mult[uv] = int(rng.integers(-128, 128))
            d.uv_luma_mult[uv] = int(rng.integers(-128, 128))
            d.uv_offset[uv] = int(rng.integers(-256, 256))
    d.scaling_shift = int(rng.integers(8, 12))
    lag = c["lag"]
    n_luma = 2 * lag * (lag + 1)
    # the whole coded range: large coefficients drive the filter into
    # its clip
    d.ar_coeffs_y = [int(v) for v in rng.integers(-128, 128, n_luma)]
    d.ar_coeffs_uv = [[int(v) for v in rng.integers(-128, 128, n_luma + 1)]
                      for _ in range(2)]
    d.ar_coeff_lag = lag
    d.ar_coeff_shift = int(rng.integers(6, 10))
    d.grain_scale_shift = int(rng.integers(0, 4))
    d.overlap_flag = c["overlap"]
    d.clip_to_restricted_range = c["restricted"]
    return d


def _picture(c):
    """A grain-free picture of the case (int32 planes) and its header."""
    rng = np.random.default_rng(c["seed"])
    d = _params(rng, c)
    layout = LAYOUTS[c["layout"]]
    w, h = c["size"]
    ss_x = int(layout != PixelLayout.I444)
    ss_y = int(layout == PixelLayout.I420)
    dims = [(h, w)]
    if layout != PixelLayout.I400:
        dims += [((h + ss_y) >> ss_y, (w + ss_x) >> ss_x)] * 2
    top = 1 << c["bitdepth"]
    planes = [rng.integers(0, top, s).astype(np.int32) for s in dims]
    hdr = types.SimpleNamespace(film_grain=types.SimpleNamespace(data=d))
    return types.SimpleNamespace(
        frame_hdr=hdr, seq_hdr=types.SimpleNamespace(
            mtrx=0 if c["identity"] else 1),
        layout=layout, bitdepth=c["bitdepth"], width=w, height=h,
        planes=planes), (ss_x, ss_y)


def _copy(pic):
    return types.SimpleNamespace(**{**vars(pic), "planes": [
        p.copy() for p in pic.planes]})


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_port_equals_the_spec(case):
    pic, (ss_x, ss_y) = _picture(case)
    want = ref.film_grain_synthesis(
        [torch.from_numpy(p) for p in pic.planes],
        ref.from_parsed(pic.frame_hdr.film_grain.data), pic.bitdepth,
        ss_x, ss_y, mc_identity=bool(case["identity"]))
    want = [t.numpy() for t in want]
    # the grain changes every plane with scaling points
    d = pic.frame_hdr.film_grain.data
    grained = [d.num_y_points > 0] + [
        bool(d.num_uv_points[uv] or d.chroma_scaling_from_luma)
        for uv in range(len(pic.planes) - 1)]
    for pl, g in enumerate(grained):
        assert g == (not np.array_equal(want[pl], pic.planes[pl])), pl
    device_path = _copy(pic)
    filmgrain.apply_grain(device_path, torch.device("cpu"))
    native = _copy(pic)
    filmgrain._apply_grain_native(native)
    for pl in range(len(pic.planes)):
        np.testing.assert_array_equal(device_path.planes[pl], want[pl],
                                      err_msg=f"apply_grain, plane {pl}")
        np.testing.assert_array_equal(native.planes[pl], want[pl],
                                      err_msg=f"native, plane {pl}")


def test_cases_cover_the_parameter_space():
    seen = {k: {c[k] for c in CASES} for k in CASES[0]}
    assert seen["bitdepth"] == {8, 10, 12}
    assert seen["layout"] == set(LAYOUTS)
    assert seen["points"] == set(POINTS)
    assert seen["lag"] == {0, 1, 2, 3}
    for flag in ("overlap", "restricted", "identity"):
        assert seen[flag] == {0, 1}, flag
    # a short last stripe (height not a multiple of 32) and a short last
    # block (width not a multiple of 32), odd both ways
    assert any(w % 32 and h % 32 and w % 2 and h % 2
               for w, h in seen["size"])


def test_spec_random_number_process():
    """The first numbers of the 16-bit register (spec 7.18.3.2), worked
    by hand from its feedback taps 0, 1, 3 and 12."""
    rng = ref.Random(1)
    # 1: bit = 1 ^ 0 ^ 0 ^ 0 = 1, register 0x8000 -> 11 bits: 0x400
    assert rng.get_random_number(11) == 0x400
    assert rng.register == 0x8000
    # 0x8000: every tap 0 -> 0x4000
    assert rng.get_random_number(8) == 0x40
    assert rng.register == 0x4000


def test_reference_copies_identical_and_standalone():
    assert BENCH_REF.read_bytes() == REF.read_bytes()
    tree = ast.parse(REF.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "functools", "dataclasses", "pathlib",
                     "numpy", "torch"}, names
