"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
The workload names a configuration file (benchmark/configs), a traffic file
(benchmark/traffic, whose `entry` names the driver in benchmark/drivers) and
a limits file (benchmark/limits/<workload>.json); each per-layer metric is
read by the file of its quantity, benchmark/metrics/<quantity>.py (the name
up to its first dot). The last
line of standard output is one JSON object: correct, attempted, failed,
metrics (the end-to-end metrics, or with --trace 1 the per-layer ones),
device, with --trace 1 breakdown, and last `check`: each compared number
beside its limit, which also close standard error.
"""

from __future__ import annotations

import time

T0_HOST = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "moca_tpu")


def process_start() -> float:
    """The process's start on the perf_counter clock."""
    from benchmark.common import process_age_s

    age = process_age_s()
    return time.perf_counter() - age if age is not None else T0_HOST


def set_cache_dirs(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton-cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch-extensions")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (moca_tpu_torch is not moca_tpu)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def execute(cell, started: float):
    """Drive the cell's entry once: (the result line, lines for standard
    error). The line's keys in order: correct, attempted, failed, metrics,
    device, with --trace 1 breakdown, and last check."""
    import torch

    from benchmark import common, trace

    driver = importlib.import_module(f"benchmark.drivers.{cell.entry}")
    out = driver.run(cell)
    w = out.window
    device = {"platform": "gpu" if cell.device.type == "cuda" else cell.device.type,
              "kind": (torch.cuda.get_device_name(cell.device) if cell.device.type == "cuda"
                       else cell.device.type),
              "count": torch.cuda.device_count() if cell.device.type == "cuda" else 1,
              "memory_peak_bytes": out.peak_bytes}
    notes = [f"benchmark: set-up {w.opened - started:.2f} s, window {w.length:.2f} s, then "
             f"{time.perf_counter() - w.closed:.2f} s to read the trace and check"]
    if cell.trace:
        view = out.view
        metrics = {}
        for m in cell.per_layer:
            value = trace.load_reader(m["name"], common.HERE / "metrics")(view, m)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device.update(busy_s=view.busy_s, window_s=view.window_s)
        notes.append(f"benchmark: device seconds by category {json.dumps(trace.categories(view))}")
    else:
        metrics = {name: {"value": v, "unit": unit} for name, (v, unit) in out.end_to_end.items()}
        if out.peak_bytes is not None:
            metrics["peak_mem_gib"] = {"value": out.peak_bytes / common.GIB, "unit": "GiB"}
        metrics["setup_s"] = {"value": w.opened - started, "unit": "s"}
    line = {"correct": out.correct, "attempted": w.units, "failed": out.failed,
            "metrics": metrics, "device": device}
    if cell.trace:
        line["breakdown"] = trace.breakdown(out.view)
    line["check"] = {r.name: {"value": r.value, "limit": r.limit, "answers": r.answers}
                     for r in out.readings}
    return line, notes


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    set_cache_dirs(ROOT)
    started = process_start()

    import torch

    from benchmark import common, program  # noqa: F401  (the system under test, or no run)

    spec = common.load_json(ROOT / "BENCHMARK.json")
    cell = common.find_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                            "cuda")
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    line, notes = execute(cell, started)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad} (JAX or the JAX package)", file=sys.stderr)
        return 3
    print("\n".join(notes), file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    for name, r in line["check"].items():
        print(f"check {name} {r['value']!r} limit {r['limit']!r} over {r['answers']} answers",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
