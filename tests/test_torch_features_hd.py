"""The JAX suite's 720p and 1080p feature streams through the port on
the CPU, two-pass only (the helpers and rules of
tests/test_torch_features.py): hd720 (5 frames), hd720_superres_tiles
(4 frames, super-res 1280 from 1280*8/14, 2 tile columns) and
fhd_grain_superres_tiles (4 frames, 1080p, super-res, 2x2 tiles, film
grain on the super-res output), each against md5.json in the JAX host
tier's two-pass mode and the port's (a resize call on every super-res
frame, one fg call per grained plane).  Their fused and device-intra
decodes run on the card (chip_smoke.py phase 7).

Cases: 3 x 2.  Time alone in one process: ~30 s (the port's plain
chain ~20 s of it).
"""

import pytest

from test_torch_features import LARGE, MD5, check_jax, check_port

HD = [s for s in LARGE if MD5[s]["width"] * MD5[s]["height"]
      <= 1920 * 1080]


def test_hd_streams():
    # with the 4K stream of tests/test_torch_features_4k.py, every stream
    # above 384x256
    assert HD == ["fhd_grain_superres_tiles.ivf", "hd720.ivf",
                  "hd720_superres_tiles.ivf"]
    assert set(LARGE) == set(HD) | {"uhd4k_smoke.ivf"}


@pytest.mark.parametrize("name", HD)
def test_jax_host_tier_md5_hd(name):
    check_jax(name, "two_pass")


@pytest.mark.parametrize("name", HD)
def test_port_md5_hd(name):
    check_port(name, "two_pass")
