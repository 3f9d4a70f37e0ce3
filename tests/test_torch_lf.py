"""dav1d_tpu_torch deblock (ops/lf.py) vs the JAX package, bit-exact.

The port's plain PyTorch pass (the version its wrapper runs on CPU
tensors; the CUDA kernel is compared with it on the card by
chip_smoke.py) must reproduce the Pallas band kernel
(pallas_lf.deblock_plane_pallas, interpret mode on the CPU backend) and
the XLA gather tier (ops/lf.loop_filter_batch) on randomized tx-tiling
edge geometry (tests/test_pallas_lf._gen_edges), at bit depths 8/10/12,
luma and chroma, on noise (mostly the narrow filter) and on blocky
content with flat regions (the flat wd6/wd8/wd16 filters fire).
Tolerance: exact (integer codec)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dav1d_tpu.ops import pallas_lf
from dav1d_tpu.ops.lf import loop_filter_batch
from dav1d_tpu.recon.lf import calc_eih
from dav1d_tpu_torch.ops import lf as tlf
from test_pallas_lf import _edge_lists, _gen_edges


def _smooth(rng, ph, pw, bitdepth):
    """8x8 blocks of nearby levels with flat (+-1 step) or noisy
    interiors: edges pass the filter mask and often the flatness tests."""
    F = 1 << (bitdepth - 8)
    base = rng.integers(100, 140, (-(-ph // 8), -(-pw // 8))) * F
    base = np.repeat(np.repeat(base, 8, 0), 8, 1)[:ph, :pw]
    flat = np.repeat(np.repeat(rng.random((-(-ph // 32), -(-pw // 32)))
                               < 0.5, 32, 0), 32, 1)[:ph, :pw]
    noise = np.where(flat, rng.integers(0, 2, (ph, pw)),
                     rng.integers(-8, 9, (ph, pw))) * F
    return np.clip(base + noise, 0, (1 << bitdepth) - 1).astype(np.int32)


def _case(seed, ph, pw, sharp, bitdepth, luma, content="noise"):
    rng = np.random.default_rng(seed)
    if content == "noise":
        plane = rng.integers(0, 1 << bitdepth, (ph, pw)).astype(np.int32)
    else:
        plane = _smooth(rng, ph, pw, bitdepth)
    e_lut, i_lut = calc_eih(sharp)
    ed_v, ed_h = _gen_edges(rng, ph, pw, 2 if luma else 1)
    return (plane, _edge_lists(rng, ed_v, e_lut, i_lut),
            _edge_lists(rng, ed_h, e_lut, i_lut))


def _xla(plane, lv, lh, bitdepth, luma):
    wd_map = {1: 4, 2: 8, 3: 16} if luma else {1: 4, 2: 6}
    dev = jnp.asarray(plane)
    for dir_, lst in ((0, lv), (1, lh)):
        if lst is None:
            continue
        ys, xs, E, I, H, cls = lst
        for c, wd_px in wd_map.items():
            sel = cls == c
            if sel.any():
                dev = loop_filter_batch(dev, ys[sel] * 4, xs[sel] * 4,
                                        E[sel], I[sel], H[sel], dir_ == 0,
                                        wd_px, bitdepth)
    return np.asarray(dev)


@pytest.mark.parametrize("content", ["noise", "smooth"])
@pytest.mark.parametrize("luma", [True, False])
@pytest.mark.parametrize("bitdepth", [8, 10, 12])
@pytest.mark.parametrize("ph,pw,sharp", [(96, 160, 0), (92, 156, 4)])
def test_plain_deblock_matches_pallas_and_xla(luma, bitdepth, ph, pw,
                                               sharp, content):
    plane, lv, lh = _case(7 * bitdepth + ph + luma, ph, pw, sharp,
                          bitdepth, luma, content)
    pal = np.asarray(pallas_lf.deblock_plane_pallas(
        jnp.asarray(plane), lv, lh, bitdepth, luma, interpret=True))
    xla = _xla(plane, lv, lh, bitdepth, luma)
    got = tlf.deblock_plane(torch.from_numpy(plane), lv, lh, bitdepth,
                            luma).numpy()
    assert np.array_equal(pal, xla)
    assert np.array_equal(got, pal), \
        f"mismatch at {np.argwhere(got != pal)[:6]}"


@pytest.mark.parametrize("luma", [True, False])
def test_smooth_content_fires_every_filter(luma):
    """On the smooth cases the decision lattice takes the flat branches,
    not only the narrow filter: wd16 writes 6 px from its edge (offset
    -6), wd8 3 px (offset -3), chroma wd6 2 px (offset -2)."""
    plane, lv, _ = _case(1, 96, 160, 0, 8, luma, "smooth")
    ys, xs, E, I, H, cls = lv
    P = torch.from_numpy((E | I << 8 | H << 16 | cls << 24)
                         .astype(np.int32)).repeat_interleave(4)
    y = torch.from_numpy(ys * 4).repeat_interleave(4) + \
        torch.arange(4).repeat(len(ys))
    x = torch.from_numpy(xs * 4).repeat_interleave(4)
    canvas = torch.nn.functional.pad(torch.from_numpy(plane), (8, 8, 8, 8))
    out = tlf._core(lambda o: canvas[y + 8, x + o + 8], P,
                    tlf.LUMA_CLASSES if luma else tlf.CHROMA_CLASSES, 8)
    fired = {o: int(c.sum()) for o, (c, _) in out.items()}
    for o in ((-6, -3, -1) if luma else (-2, -1)):
        assert fired[o] > 0, fired


@pytest.mark.parametrize("vertical", [True, False])
def test_single_pass_matches_xla(vertical):
    """One direction alone through the wrapper (the other map empty)."""
    plane, lv, lh = _case(11 + vertical, 64, 128, 0, 8, True)
    lst = lv if vertical else lh
    want = _xla(plane, lst if vertical else None,
                None if vertical else lst, 8, True)
    cells = torch.from_numpy(tlf.cellmap(lst, 64, 128))
    got = tlf.deblock(torch.from_numpy(plane), cells, vertical, 8, True)
    assert np.array_equal(got.numpy(), want)


def test_cellmap_packing():
    """E | I<<8 | H<<16 | cls<<24 at the edge cells, 0 elsewhere."""
    plane, lv, _ = _case(3, 32, 48, 0, 8, True)
    m = tlf.cellmap(lv, 32, 48)
    assert m.shape == (8, 12) and m.dtype == np.int32
    ys, xs, E, I, H, cls = lv
    assert np.array_equal(m[ys, xs], E | I << 8 | H << 16 | cls << 24)
    assert np.count_nonzero(m) == len(ys)
    assert not tlf.cellmap(None, 32, 48).any()


def test_wrapper_rejects_bad_inputs():
    """The wrapper checks dtype and map shape, and never runs a device
    other than the CPU or CUDA."""
    p = torch.zeros((16, 16), dtype=torch.int32)
    cells = torch.zeros((4, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        tlf.deblock(p.to(torch.int64), cells, True, 8, True)
    with pytest.raises(ValueError):
        tlf.deblock(p, cells[:3], True, 8, True)
    with pytest.raises(ValueError):
        tlf.deblock(p.to("meta"), cells.to("meta"), True, 8, True)
