"""What the benchmark loads: nothing of JAX or the JAX package (top-level
module names compared whole: moca_tpu_torch is not moca_tpu), and a
reference that loads nothing of the measured program. Without a card, or
without the program beside it, a run fails and prints no result."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

from benchmark import common
from benchmark.run import FORBIDDEN, forbidden_modules

HARNESS = ("benchmark.run", "benchmark.calibrate", "benchmark.catalog", "benchmark.common",
           "benchmark.flops", "benchmark.trace", "benchmark.program",
           "benchmark.drivers.moca_davis", "benchmark.drivers.t2v_clip")
REFERENCE = ("benchmark.reference", "benchmark.reference.nets", "benchmark.reference.diffusion")


def loaded_top_level(modules, cwd=common.ROOT, extra=""):
    code = (f"import sys, json\nfor m in {list(modules)!r}:\n    __import__(m)\n{extra}\n"
            "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax_and_no_jax_package():
    loaded = loaded_top_level(HARNESS, extra=(
        "from benchmark import trace, common\n"
        "for p in (common.HERE / 'metrics').glob('*.py'):\n"
        "    trace.load_reader(p.stem, common.HERE / 'metrics')"))
    assert "moca_tpu_torch" in loaded
    assert not loaded & set(FORBIDDEN)


def test_a_whole_tiny_run_loads_no_jax():
    loaded = loaded_top_level(["benchmark.run", "benchmark.tests.tiny"], extra=(
        "from benchmark.run import execute\n"
        "from benchmark.tests.tiny import tiny_cell\n"
        "assert execute(tiny_cell('vc1-i2v-clip', precision='float32'), 0.0)[0]['correct']"))
    assert not loaded & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    loaded = loaded_top_level(REFERENCE)
    assert not loaded & ({"moca_tpu_torch"} | set(FORBIDDEN))


def test_names_are_compared_whole(monkeypatch):
    for name in ("moca_tpu_torch.ops", "jaxtyping", "flaxen", "moca_tpu_torchx"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "moca_tpu.ops.attention", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert forbidden_modules() == ["jaxlib", "moca_tpu"]


def run_cell(cwd, env=None):
    return subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "vc2-fifo-davis",
                           "--seed", "3000000019", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_without_a_card_a_run_fails_and_prints_nothing():
    out = run_cell(common.ROOT, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout == ""


def test_with_only_the_benchmark_a_run_fails_and_prints_nothing(tmp_path):
    shutil.copy(common.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(common.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_cell(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
    assert "moca_tpu_torch" in out.stderr
