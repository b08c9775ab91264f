"""A whole run, past the look for a card, with the timed path broken
underneath: `correct` must come out false for each fault a cell can have,
under the cell's own limits. (One chip: no exchange between chips to drop.)
The port runs in float32 here, so the sound run reads rounding alone.
The faults are `benchmark/faults.py`'s."""

from __future__ import annotations

import pytest

from benchmark.faults import FAULTS
from benchmark.run import execute
from benchmark.tests.tiny import tiny_cell

ENTRIES = {"vc2-fifo-davis": "moca_davis", "vc1-i2v-clip": "t2v_clip"}
CASES = [(cell, fault) for cell, entry in ENTRIES.items()
         for fault, (_, entries) in FAULTS.items() if entry in entries]


@pytest.mark.parametrize("name", ["vc2-fifo-davis", "vc1-i2v-clip"])
def test_the_sound_run_is_correct(name):
    line, _ = execute(tiny_cell(name, precision="float32"), 0.0)
    assert line["correct"], line["check"]


@pytest.mark.parametrize("name,fault", CASES)
def test_a_fault_is_not_correct(name, fault, monkeypatch):
    FAULTS[fault][0](monkeypatch.setattr)
    line, _ = execute(tiny_cell(name, precision="float32"), 0.0)
    assert not line["correct"], line["check"]
