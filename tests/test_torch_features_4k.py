"""The JAX suite's 4K feature stream (uhd4k_smoke: 3840x2160, 2 frames,
super-res 3840 from 3840*8/12, 2 tile columns) through the port on the
CPU, two-pass only (the helpers and rules of
tests/test_torch_features.py), against md5.json in the JAX host tier's
two-pass mode and the port's.  Its fused decode (~60 s of the JAX
package's Python on the CPU) and its meshes run on the card
(chip_smoke.py phase 7).

Cases: 2.  Time alone in one process: ~20 s.
"""

from test_torch_features import check_jax, check_port

NAME = "uhd4k_smoke.ivf"


def test_jax_host_tier_md5_4k():
    check_jax(NAME, "two_pass")


def test_port_md5_4k():
    log, _ = check_port(NAME, "two_pass")
    assert all(fr["superres"] for fr in log.frames)
