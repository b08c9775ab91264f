"""A later change adds a traffic mix, a cell and a per-layer metric by adding
files and BENCHMARK.json entries; the harness finds them by name, and no
file that was there is edited."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys

from benchmark import common

DUMMY_METRIC = '''"""Device milliseconds a unit of every operation (a test reader)."""


def read(view, metric):
    units = view.counts.get("units", 0)
    return view.seconds() / units * 1e3 if units else None
'''


def digests(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_traffic_and_metric_files_are_found_by_name(tmp_path):
    shutil.copy(common.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(common.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digests(tmp_path / "benchmark")

    here = tmp_path / "benchmark"
    traffic = common.load_json(here / "traffic" / "fifo-davis.json")
    traffic.update(why="a test mix: lookahead kept, 2 partitions", num_partitions=2)
    (here / "traffic" / "fifo-test-mix.json").write_text(json.dumps(traffic))
    (here / "limits" / "vc2-fifo-test.json").write_text(
        (here / "limits" / "vc2-fifo-davis.json").read_text())
    (here / "metrics" / "all_ms.py").write_text(DUMMY_METRIC)
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "vc2-fifo-test", "config": "vc2-t2v-512",
                              "traffic": "fifo-test-mix", "chips": 1, "why": "a test cell"})
    spec["per_layer"].append({"name": "all_ms.fifo", "unit": "ms", "better": "lower",
                              "source": "device_trace", "layer": "device",
                              "moves": "s_per_frame", "workloads": ["vc2-fifo-test"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    code = """
import json
from benchmark.catalog import catalog
from benchmark.run import execute
from benchmark.tests.tiny import tiny_cell
from benchmark import common
cell = tiny_cell("vc2-fifo-test", precision="float32", trace=True, root=common.ROOT)
line, _ = execute(cell, 0.0)
print(json.dumps({"catalog": catalog(), "metrics": sorted(m["name"] for m in cell.per_layer),
                  "partitions": cell.traffic["num_partitions"], "correct": line["correct"],
                  "benchmark": common.HERE.as_posix()}))
"""
    # the copy's benchmark first (the working directory), the program from the repository
    env = dict(os.environ, PYTHONPATH=str(common.ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["benchmark"] == here.as_posix()
    assert "fifo-test-mix" in got["catalog"]["traffic"]
    assert "all_ms" in got["catalog"]["metrics"]
    assert got["metrics"] == ["all_ms.fifo"]
    assert got["partitions"] == 2 and got["correct"]
    after = digests(here)
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == {"traffic/fifo-test-mix.json", "limits/vc2-fifo-test.json",
                                        "metrics/all_ms.py"}
