"""Every traffic generator is a function of the seed alone, and a mix
file is checked before any run."""

from __future__ import annotations

import itertools
import json

import numpy as np
import pytest

import generator
from conftest import BENCH, SESSIONS4

BIG = 2**31 + 12345


def _take(gen, n):
    return list(itertools.islice(gen, n))


def _mix(**kw):
    d = {**SESSIONS4, "processes": 1, **kw}
    return generator.parse_mix(d)


@pytest.mark.parametrize("kind", ["loop", "shuffle"])
@pytest.mark.parametrize("index", [0, 3])
def test_same_seed_same_sequence(kind, index):
    a = _take(generator.order(BIG, 3, index, kind), 40)
    b = _take(generator.order(BIG, 3, index, kind), 40)
    assert a == b
    assert set(a) <= {0, 1, 2}


def test_clip_requests_are_seeded_epochs():
    seqs = {tuple(_take(generator.order(BIG + s, 3, 0, "shuffle"), 21))
            for s in range(8)}
    assert len(seqs) > 1
    for seq in seqs:
        for e in range(7):
            assert sorted(seq[3 * e:3 * e + 3]) == [0, 1, 2]


def test_stream_work_is_the_seeds_alike():
    """A looped window holds the same pictures whatever the seed: the
    seed draws which pictures are compared, not what is decoded."""
    seqs = {tuple(_take(generator.order(BIG + s, 3, 0, "loop"), 10))
            for s in range(16)}
    assert seqs == {(0, 1, 2, 0, 1, 2, 0, 1, 2, 0)}


def test_stream_sessions_rotate_one_order():
    for i in range(4):
        got = _take(generator.order(BIG, 3, i, "loop"), 6)
        assert got == [(i + k) % 3 for k in range(6)]


def test_sample_draw_is_seeded():
    a = np.random.default_rng([BIG, 2, 1]).random(50)
    b = np.random.default_rng([BIG, 2, 1]).random(50)
    assert (a == b).all()


@pytest.mark.parametrize("kw,want", [
    ({}, [(0, 12, 0), (1, 12, 0), (2, 12, 0)]),
    ({"frames": 5}, [(0, 5, 0), (1, 5, 0), (2, 5, 0)]),
    ({"frames": 20}, [(0, 12, 0), (1, 12, 0), (2, 12, 0)]),
])
def test_requests_from_the_key_frame(kw, want):
    got = _take(generator.requests(_mix(**kw), BIG, 0, [12, 12, 12]), 3)
    assert [(r.clip, r.units, r.deliver_from) for r in got] == want


@pytest.mark.parametrize("frames", [None, 4])
def test_seek_requests_are_seeded_and_fit(frames):
    mix = _mix(decoder="request", order="shuffle", start="seek",
               frames=frames)
    a = _take(generator.requests(mix, BIG, 1, [12, 10, 12]), 30)
    assert a == _take(generator.requests(mix, BIG, 1, [12, 10, 12]), 30)
    assert a != _take(generator.requests(mix, BIG + 1, 1, [12, 10, 12]), 30)
    n = [12, 10, 12]
    for r in a:
        # decoded from the clip's key frame, delivered from inside it
        assert 1 <= r.deliver_from < r.units <= n[r.clip]
        if frames:
            assert r.units - r.deliver_from == frames
        else:
            assert r.units == n[r.clip]
    assert len({r.deliver_from for r in a}) > 1


@pytest.mark.parametrize("mix", sorted(p.stem for p in
                                       (BENCH / "traffic").glob("*.json")))
def test_mix_files(mix):
    d = json.loads((BENCH / "traffic" / f"{mix}.json").read_text())
    m = generator.parse_mix(d)
    assert m.processes >= 1 and m.in_flight >= 1


@pytest.mark.parametrize("change", [
    {"unit": "live"},               # a key of no mix
    {"decoder": "live"},            # a shape the generator has not
    {"order": "random"},
    {"start": "middle"},
    {"processes": 0},
    {"in_flight": 1.5},
    {"frames": 0},
    {"pace_fps": 0},
    {"pace_fps": "24"},
])
def test_mix_outside_the_generator_is_refused(change):
    with pytest.raises(ValueError):
        generator.parse_mix({**SESSIONS4, **change})


def test_mix_with_a_key_left_out_is_refused():
    d = dict(SESSIONS4)
    del d["start"]
    with pytest.raises(ValueError):
        generator.parse_mix(d)
