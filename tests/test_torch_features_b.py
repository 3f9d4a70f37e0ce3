"""The JAX suite's AV1 feature streams through the port on the CPU,
part B (the helpers, the streams and the rules are those of
tests/test_torch_features.py, part A): the small streams of
``PART_B`` held in the JAX host tier's two modes and the port's three,
and the odd geometries with a mesh of 3 bands on the CPU
(``Settings(mesh=Mesh(["cpu"] * 3))``, two-pass: at these heights the
last band holds no rows), against md5.json; the card runs them with 2
and 3 bands (chip_smoke.py phase 7).

Cases: 5 x 19 decodes of part B + 6 mesh decodes.  Time alone in one
process: ~75 s.
"""

import pytest

from test_torch_features import MD5, PART_B, check_jax, check_port, \
    port_decode, want

PART = PART_B
# the odd geometries of chip_smoke.py's FEATURE_MESH that run on the
# CPU (the 4K stream's mesh runs on the card)
MESH = ["odd_size.ivf", "restoration_444_odd.ivf", "screen_odd.ivf",
        "sb64.ivf", "superres_random.ivf", "tiles_full.ivf"]


@pytest.mark.parametrize("mode", ["two_pass", "fused"])
@pytest.mark.parametrize("name", PART)
def test_jax_host_tier_md5_b(name, mode):
    check_jax(name, mode)


@pytest.mark.parametrize("mode", ["fused", "two_pass", "device_intra"])
@pytest.mark.parametrize("name", PART)
def test_port_md5_b(name, mode):
    check_port(name, mode)


@pytest.mark.parametrize("name", MESH)
def test_port_mesh_md5(name):
    from dav1d_tpu_torch import devrt
    from dav1d_tpu_torch.mesh import Mesh

    assert name in MD5
    bands = 3
    got, log = port_decode(name, two_pass=True, mesh=Mesh(["cpu"] * bands))
    assert got == want(name), f"{name} mesh of {bands}: {got}"
    # the itx work dealt in shares, one itx call a share
    assert devrt.COUNTS["mesh_itx_shares"] == log.calls["itx"] > 0
