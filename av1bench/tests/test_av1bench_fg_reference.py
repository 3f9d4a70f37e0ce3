"""On a card: the film grain of the ``uhd10_grain`` configuration against
the plain reference of AV1 film grain synthesis
(``reference/film_grain.py``, the specification's section 7.18.3 in
plain PyTorch) and against libaom's digests.

The first pictures of clip 0 (3840x2160 10-bit 4:2:0, grain on every
picture) are decoded twice with the configuration's settings, once
without grain and once with it; the reference, run on the card, grains
each grain-free picture with that picture's own film grain parameters,
and its result has to equal the program's grained picture and libaom's
MD5 of every plane.  Skips where there is no card."""

from __future__ import annotations

import importlib.util
import json
import sys

import numpy as np
import pytest

import check
import ivf
from conftest import BENCH, ROOT

PICTURES = 8


def _reference():
    path = BENCH / "reference" / "film_grain.py"
    spec = importlib.util.spec_from_file_location("av1bench_film_grain", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # a dataclass looks up its module
    spec.loader.exec_module(mod)
    return mod


def _decode(config, units, device, apply_grain):
    """The first ``PICTURES`` pictures (planes copied, header) of
    ``units`` through a decoder of the config's settings."""
    from dav1d_tpu_torch.decoder import Decoder, Settings

    dec = Decoder(Settings(**{**config["settings"],
                              "apply_grain": apply_grain}), device=device)
    out = []

    def take(pic):
        if pic is not None:
            out.append(([np.array(p, dtype=np.int32) for p in pic.planes],
                        pic))

    for tu in units[:PICTURES]:
        dec.send_data(tu)
        take(dec.get_picture())
    while (pic := dec.get_picture()) is not None:
        take(pic)
    dec.close()
    return out[:PICTURES]


def compare(config_file, device, size):
    """Hold the reference against the program and libaom on the first
    ``PICTURES`` pictures of the config's first clip on ``device``."""
    import torch

    fg = _reference()
    config = json.loads(config_file.read_text())
    units = ivf.read((ROOT / config["streams"] / config["clip_files"][0])
                     .read_bytes())
    want = check.load_reference(ROOT, config)["clips"][0]["pictures"]
    bd = config["bitdepth"]
    plain = _decode(config, units, device, apply_grain=False)
    grained = _decode(config, units, device, apply_grain=True)
    assert len(plain) == len(grained) == PICTURES
    for k, ((free, pic), (port, _)) in enumerate(zip(plain, grained)):
        assert (pic.width, pic.height, pic.bitdepth) == (*size, bd)
        data = pic.frame_hdr.film_grain.data
        assert data.num_y_points > 0, k  # grain on every picture
        # without grain the picture is not libaom's output
        assert check.md5s(free, bd) != want[k]["md5"], k
        out = fg.film_grain_synthesis(
            [torch.from_numpy(p).to(device) for p in free],
            fg.from_parsed(data), bd, 1, 1,
            mc_identity=pic.seq_hdr.mtrx == 0)
        out = [o.cpu().numpy() for o in out]
        for pl in range(3):
            np.testing.assert_array_equal(out[pl], port[pl],
                                          err_msg=f"picture {k} plane {pl}")
        assert check.md5s(out, bd) == want[k]["md5"], k


@pytest.mark.card
def test_reference_grain_equals_the_program_and_libaom(card):
    compare(BENCH / "configs" / "uhd10_grain.json", card, (3840, 2160))
