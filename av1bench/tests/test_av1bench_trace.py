"""The device's idle share from the union of its intervals, against the
summed share that counts overlaps twice; the trace's names."""

from __future__ import annotations

import importlib.util

import pytest

import devtrace
from conftest import BENCH


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        name, BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_union_against_sum():
    # a kernel overlapped by a copy of another process, and one alone
    ev = [(1.0, 3.0, "a"), (2.0, 4.0, "b"), (6.0, 7.0, "c")]
    assert devtrace.union_s(ev) == pytest.approx(4.0)
    assert devtrace.summed_s(ev) == pytest.approx(5.0)
    read = _reader("device.idle")
    rec = {"window_s": 10.0,
           "device": {"busy_s": devtrace.union_s(ev), "clock_ok": True}}
    assert read(rec) == pytest.approx(60.0)
    # the summed share would read 50%: overlaps counted twice
    assert 100 * (1 - devtrace.summed_s(ev) / 10.0) == pytest.approx(50.0)


def test_idle_needs_one_clock():
    read = _reader("device.idle")
    rec = {"window_s": 10.0, "device": {"busy_s": 1.0, "clock_ok": False}}
    assert read(rec) is None


def test_clip_to_window():
    ev = [(0.5, 1.5, "a"), (1.8, 2.2, "b"), (3.0, 4.0, "c")]
    got = devtrace.clip(ev, 1.0, 2.0)
    assert got == [(1.0, 1.5, "a"), (1.8, 2.0, "b")]


def test_idle_gaps_longest_first():
    ev = [(1.0, 2.0, "void (anonymous namespace)::itx_frame_kernel(int*)"),
          (5.0, 6.0, "Memcpy HtoD (Pageable -> Device)")]
    gaps = devtrace.idle_gaps(ev, 0.0, 10.0)
    assert [g for _, g in gaps] == [4.0, 3.0, 1.0]
    assert gaps[1][0] == ("after itx_frame_kernel before "
                          "Memcpy HtoD (Pageable -> Device)")


@pytest.mark.parametrize("name,base", [
    ("void (anonymous namespace)::cdef_filter_kernel(cdef::Plane)",
     "cdef_filter_kernel"),
    ("void fg_kernel<8>(fg::Planes, int const*)", "fg_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "FillFunctor<int>, std::array<char*, 1ul> >(int, at::native::"
     "FillFunctor<int>, std::array<char*, 1ul>)",
     "at::native::vectorized_elementwise_kernel"),
    ("Memcpy DtoH (Device -> Pinned)", "Memcpy DtoH (Device -> Pinned)"),
])
def test_base_name(name, base):
    assert devtrace.base_name(name) == base
