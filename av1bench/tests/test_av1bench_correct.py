"""``correct`` against the planted faults and the controls: the harness
runs with its look for a card skipped (the program's plain versions on
the CPU, the small configuration ``tiny10g``), the timed path broken
underneath, and has to come out not correct; the sound program has to
come out correct.  The controls at the cells' own size run on the card
(marker ``card``)."""

from __future__ import annotations

import json

import pytest

import run


def _run(root, cell, capsys, decoder=None, control=False, device="cpu",
         seconds="3", seed="2147483701"):
    argv = ["--workload", cell, "--seed", seed, "--seconds", seconds,
            "--trace", "0"] + (["--control"] if control else [])
    assert run.main(argv, device=device, decoder=decoder, root=root) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_sound_program_is_correct(tiny_root, capsys):
    out = _run(tiny_root, "tiny10g.stream", capsys)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["checks"]["pictures_compared"]["value"] > 0


@pytest.mark.parametrize("cell,fault,caught_by", [
    ("tiny10g.stream", "faults:StaleDecoder", "order"),
    ("tiny10g.stream", "faults:GridPixelDecoder", "order"),
    ("tiny10g.stream", "faults:OffGridPixelDecoder", "pixels"),
    ("tiny10g.sessions4", "faults:HalfDecoder", "count"),
    ("tiny10g.clips4", "faults:OffGridPixelDecoder", "pixels"),
])
def test_planted_fault_is_not_correct(tiny_root, capsys, cell, fault,
                                      caught_by):
    out = _run(tiny_root, cell, capsys, decoder=fault)
    assert not out["correct"]
    assert out["checks"][caught_by]["value"] > 0


def test_control_is_not_correct(tiny_root, capsys):
    """tiny10g's control: film grain skipped at output."""
    out = _run(tiny_root, "tiny10g.stream", capsys, control=True)
    assert not out["correct"]
    assert out["checks"]["order"]["value"] > 0


@pytest.mark.card
@pytest.mark.parametrize("cell", ["fhd8_vod.stream", "fhd8_vod.clips4"])
@pytest.mark.parametrize("seed", ["2147483801", "2147483802", "2147483803"])
def test_control_on_the_card(card, capsys, cell, seed):
    """Each cell's control at the cell's own size, on three seeds."""
    out = _run(None, cell, capsys, control=True, device=card, seconds="5",
               seed=seed)
    assert not out["correct"]
