"""The port's fused-step entry points (dav1d_tpu_torch/entry.py) against
the JAX package's (__graft_entry__.py), on the CPU:

* ``_example_batch`` makes the same arrays from the same seed;
* ``entry()``'s fused step (K3's and K4's wrappers, running their plain
  versions on CPU tensors, then the add and clip) equals
  ``__graft_entry__._recon_step`` on ``_example_batch(256)`` exactly;
* ``dryrun_multichip(n, device="cpu")`` passes at 2 and 3 bands: the
  step cut into n shares equals the single call, and the committed 2x2
  tile stream decodes with the mesh to the one-device decode;
* that stream, ``tiles2x2_256x192.ivf``, decodes in the port and in the
  JAX package's host tier (__graft_entry__._decode_md5) to its committed
  md5;
* ``entry()`` raises on its default device without CUDA, and
  ``python -m dav1d_tpu_torch.entry`` exits non-zero and says why."""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

DATA = Path(__file__).resolve().parent.parent / "dav1d_tpu_torch" / "data"
STREAM = "tiles2x2_256x192.ivf"


def test_example_batch_matches_jax():
    import __graft_entry__ as ref

    from dav1d_tpu_torch import entry

    for n in (4, 256):
        for a, b in zip(entry._example_batch(n), ref._example_batch(n)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_entry_step_matches_jax():
    import jax.numpy as jnp

    import __graft_entry__ as ref

    from dav1d_tpu_torch import entry

    fn, args = entry.entry(device="cpu")
    assert all(a.device.type == "cpu" and a.dtype == torch.int32
               for a in args)
    got = fn(*args)
    want = np.asarray(ref._recon_step(
        *(jnp.asarray(a) for a in ref._example_batch(256)), 16, 16))
    assert got.shape == (256, 16, 16) == want.shape
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    # the add and clip bite: pixels at both ends of the range
    assert (want == 0).any() and (want == 255).any()


@pytest.mark.parametrize("bands", [2, 3])
def test_dryrun_multichip(bands):
    from dav1d_tpu_torch import entry

    want = json.loads((DATA / "md5.json").read_text())[STREAM]
    got = entry.dryrun_multichip(bands, device="cpu")
    assert got == {"bands": bands, "frames": want["frames"],
                   "md5": want["md5"]}


def test_tiles_stream_md5_in_both_packages():
    import __graft_entry__ as ref
    from dav1d_tpu.containers import read_ivf
    from dav1d_tpu.decoder import Settings
    from dav1d_tpu.dispatch import use_device

    from dav1d_tpu_torch import entry

    want = json.loads((DATA / "md5.json").read_text())[STREAM]
    data = (DATA / STREAM).read_bytes()
    tus = [tu for tu, _ in read_ivf(data)]
    saved = os.environ.get("DAV1D_TPU_DEVICE")
    os.environ["DAV1D_TPU_DEVICE"] = "0"
    use_device.cache_clear()
    try:
        jax_md5 = ref._decode_md5(tus, Settings(two_pass=True))
    finally:
        if saved is None:
            os.environ.pop("DAV1D_TPU_DEVICE")
        else:
            os.environ["DAV1D_TPU_DEVICE"] = saved
        use_device.cache_clear()
    from dav1d_tpu_torch.decoder import Settings as PortSettings

    port = entry._decode_md5(tus, PortSettings(two_pass=True), "cpu")
    assert port == (want["frames"], want["md5"])
    assert jax_md5 == want["md5"]


def test_cuda_without_cuda():
    from test_torch_cli import cuda_without_cuda

    from dav1d_tpu_torch import entry

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry.entry()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry.dryrun_multichip(2)
    cuda_without_cuda("entry")
