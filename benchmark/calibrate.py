"""Readings that the limits of `correct` are set from; not run by the
benchmark's own runs.

    python3 -m benchmark.calibrate --workload <name> --seeds 1,2,3 --seconds <s> \
        [--control] [--fault <name>]

runs the cell once a seed in one process (the kernels built and warmed by
the first), with the window at `--seconds`, and prints one JSON line a seed:
the worst value of each compared number for the program and, with
--control, for the control: the reference computed in the type below the
one each tower is served in (float8 e4m3 below bfloat16, bfloat16 below
float32), put in the program's place and fed the same program states.
With --fault, the program runs with that fault of `benchmark/faults.py`
planted (the name with `_` for each space). Beside them, every value of
each compared number (`values`) and the reference's own readings:
`cond_move`, how far the conditioning moves the reference U-Net's output,
||e_c - e_u|| / ||e_u||, a value per checked call, in the order of the
values.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

from benchmark.run import ROOT, forbidden_modules, set_cache_dirs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)
    set_cache_dirs(ROOT)
    import torch

    from benchmark import common

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    spec = common.load_json(ROOT / "BENCHMARK.json")
    if args.fault:
        import pytest

        from benchmark.faults import FAULTS

        FAULTS[args.fault.replace("_", " ")][0](pytest.MonkeyPatch().setattr)
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = common.find_cell(spec, args.workload, seed, args.seconds, False, "cuda")
        cell.control = args.control
        driver = importlib.import_module(f"benchmark.drivers.{cell.entry}")
        torch.cuda.reset_peak_memory_stats()
        out = driver.run(cell)
        line = {"seed": seed, "fault": args.fault, "units": out.window.units,
                "per_unit_s": out.window.per_unit, "peak_gib": out.peak_bytes / common.GIB,
                "program": {r.name: r.value for r in out.readings}}
        line.update(out.diagnostics)
        if out.control is not None:
            line["control"] = {k: max(v) for k, v in out.control.items()}
        print(json.dumps(line), flush=True)
        del out
        common.release(cell.device)
    if forbidden_modules():
        print(f"calibrate: loaded {forbidden_modules()}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
