"""dav1d_tpu_torch/tables.py: the constant tables read from one zip
handle (``np.load`` of ``data/tables.npz``) by threads at once.

Pass 1's tile threads read tables on a process's first frame.  Reads of
two members from one handle at once overlap on the handle's file
position; some Python versions then fail (``zipfile.BadZipFile:
Overlapped entries``) and others do not, so the test pins the cause: it
wraps the handle, records every member read on a fresh cache from many
threads, and requires that no two reads overlap.  Every table also
equals its member of the file."""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from dav1d_tpu_torch import tables


class _Recording:
    """The npz handle with each member read timed and widened, so that
    reads from threads at once, where nothing serializes them, overlap."""

    def __init__(self, z):
        self.z = z
        self.files = z.files
        self.reads = []  # (start, end, member, thread)
        self.lock = threading.Lock()

    def __getitem__(self, name):
        t0 = time.perf_counter()
        time.sleep(0.002)
        arr = self.z[name]
        t1 = time.perf_counter()
        with self.lock:
            self.reads.append((t0, t1, name, threading.get_ident()))
        return arr


@pytest.fixture
def fresh(monkeypatch):
    """An empty table cache over a recording handle."""
    rec = _Recording(np.load(tables._DATA))
    monkeypatch.setattr(tables, "_cache", {})
    monkeypatch.setattr(tables, "_z", lambda: rec)
    return rec


def test_first_reads_from_threads_do_not_overlap(fresh):
    names = fresh.files[:48]
    start = threading.Barrier(8)

    def reader(k):
        start.wait()
        # each thread reads every member, from its own place in the list
        for name in names[k * 6:] + names[:k * 6]:
            getattr(tables, name)

    threads = [threading.Thread(target=reader, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    reads = sorted(fresh.reads)
    for a, b in zip(reads, reads[1:]):
        assert a[1] <= b[0], (a[2], b[2])
    # each member read once, however many threads asked for it first
    assert sorted(r[2] for r in reads) == sorted(names)


def test_warm_reads_take_no_lock(fresh):
    name = fresh.files[0]
    first = getattr(tables, name)
    with tables._LOCK:  # held: a read that needed it would block
        assert getattr(tables, name) is first
    assert len(fresh.reads) == 1


def test_every_table_equals_its_member():
    z = np.load(tables._DATA)
    assert len(z.files) > 700
    for name in z.files:
        got = getattr(tables, name)
        want = z[name]
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
