"""The control at a size the CPU holds: the reference computed in the type
below the served one (float8 e4m3 below bf16, bf16 below fp32), put in the
program's place, must read each compared number at three times the bf16
program's reading or more, and must come out as not correct under the
cell's limits. (On the card the same comparison ran at the cells' own sizes;
PERF.md has those readings and the limits set from them.)"""

from __future__ import annotations

import importlib

import pytest

from benchmark.tests.tiny import tiny_cell

SEEDS = (3000000019, 2147483801)


@pytest.mark.parametrize("name", ["vc2-fifo-davis", "vc1-i2v-clip"])
def test_control_is_not_correct(name):
    program, control = {}, {}
    for seed in SEEDS:
        cell = tiny_cell(name, seed=seed)
        cell.control = True
        out = importlib.import_module(f"benchmark.drivers.{cell.entry}").run(cell)
        for r in out.readings:
            program[r.name] = max(program.get(r.name, 0.0), r.value)
        for k, v in out.control.items():
            control[k] = min(control.get(k, float("inf")), max(v))
        limits = {r.name: r.limit for r in out.readings}
        assert any(max(v) > limits[k] for k, v in out.control.items()), out.control
    for k in program:
        assert control[k] >= 3 * program[k], (k, program[k], control[k])
