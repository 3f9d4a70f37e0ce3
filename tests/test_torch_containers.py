"""dav1d_tpu_torch/containers.py, the port's copy of the JAX package's
demuxers, parses every committed stream (dav1d_tpu_torch/data/) to the
same temporal units and timestamps as dav1d_tpu.containers.read_ivf,
and its probe-based open_stream picks IVF for them.  Exact."""

import json
from pathlib import Path

import pytest

from dav1d_tpu import containers as ref
from dav1d_tpu_torch import containers

DATA = Path(__file__).resolve().parent.parent / "dav1d_tpu_torch" / "data"
NAMES = sorted(json.loads((DATA / "md5.json").read_text()))


@pytest.mark.parametrize("name", NAMES)
def test_read_ivf_matches_reference(name):
    data = (DATA / name).read_bytes()
    got = list(containers.read_ivf(data))
    assert got and got == list(ref.read_ivf(data))
    assert list(containers.open_stream(data)) == got
    assert containers.ivf_meta(data) == ref.ivf_meta(data)
