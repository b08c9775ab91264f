"""What every cell shares: the specs read by name, the seed's noise and
weights, the comparison numbers, and the window's clock.

Nothing here imports the measured program; `program.py` is its adapter.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import re
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
GIB = 2**30


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One workload of BENCHMARK.json with its configuration, traffic mix and
    limits, each read from the file its name gives."""

    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    per_layer: List[dict] = dataclasses.field(default_factory=list)
    control: bool = False  # also read the control's numbers (benchmark/calibrate.py)

    @property
    def entry(self) -> str:
        return self.traffic["entry"]


def find_cell(spec: dict, workload: str, seed: int, seconds: float, trace: bool,
              device, root: Path = ROOT) -> Cell:
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[workload]
    config = next(c for c in spec["configs"] if c["name"] == w["config"])
    per_layer = [m for m in spec["per_layer"] if workload in m.get("workloads", [workload])]
    here = root / "benchmark"
    return Cell(
        name=workload, config=load_json(root / config["file"]),
        traffic=load_json(here / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(here / "limits" / f"{workload}.json"), chips=w["chips"], seed=seed,
        seconds=seconds, trace=trace, device=torch.device(device), per_layer=per_layer)


# --- the seed's noise and weights -------------------------------------------

def derived_seed(seed: int, *tag) -> int:
    """A 63-bit seed for the draw named `tag` under the run's seed."""
    text = json.dumps([str(seed)] + [str(t) for t in tag])
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little") >> 1


class SeededNormal:
    """normal(tag, shape): float32 N(0, 1) on the device, each draw from its
    own generator seeded by (run seed, tag), so any side that names a draw
    gets the same numbers in any order."""

    def __init__(self, seed: int, device):
        self.seed, self.device = seed, torch.device(device)
        self.generator = torch.Generator(device=self.device)

    def __call__(self, tag: tuple, shape: tuple) -> torch.Tensor:
        self.generator.manual_seed(derived_seed(self.seed, *tag))
        return torch.randn(tuple(shape), generator=self.generator, device=self.device,
                           dtype=torch.float32)


def uniform(seed: int, tag: str, shape, device, low=-1.0, high=1.0) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(derived_seed(seed, tag))
    return torch.rand(tuple(shape), generator=g, device=device) * (high - low) + low


DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
ALIGN = 64  # elements: every parameter starts 128-byte aligned in its buffer


def weight_plan(shapes: Dict[str, Tuple[int, ...]], norms: frozenset,
                config: dict) -> List[tuple]:
    """[(name, shape, dtype, mean, std)] in state-dict order: each tower in
    the type the configuration serves it in, every value N(mean, std^2):
    `std` from the configuration (`std_by_key` where a key's name matches),
    mean 0, but `norm_weight_mean` for the scales of the
    normalization layers named in `norms`. A `std_by_key` pattern is a
    regular expression searched for in the name; the first that matches wins."""
    w = config["weights"]
    plan = []
    for name, shape in shapes.items():
        dtype = DTYPES[config["precision"][name.split(".")[0]]]
        std = next((s for pat, s in w.get("std_by_key", {}).items() if re.search(pat, name)),
                   w["std"])
        mean = w.get("norm_weight_mean", 0.0) if name in norms else 0.0
        plan.append((name, tuple(shape), dtype, float(mean), float(std)))
    return plan


def make_weights(plan: List[tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict of `plan`, one draw per (dtype, mean, std) group into a
    flat buffer on the device, each parameter a view of it."""
    groups: Dict[tuple, List[tuple]] = {}
    for item in plan:
        groups.setdefault(item[2:], []).append(item)
    out = {}
    for gi, ((dtype, mean, std), items) in enumerate(groups.items()):
        sizes = [math.prod(item[1]) for item in items]
        total = sum(-(-n // ALIGN) * ALIGN for n in sizes)
        g = torch.Generator(device=device).manual_seed(derived_seed(seed, "weights", gi))
        buf = torch.randn(total, generator=g, device=device, dtype=dtype).mul_(std).add_(mean)
        offset = 0
        for item, n in zip(items, sizes):
            out[item[0]] = buf[offset:offset + n].view(item[1])
            offset += -(-n // ALIGN) * ALIGN
    return {item[0]: out[item[0]] for item in plan}


# --- comparison ------------------------------------------------------------

def rel_l2(out: torch.Tensor, ref: torch.Tensor, base: Optional[torch.Tensor] = None) -> float:
    """||out - ref|| / ||ref - base||, in float64 (base 0 by default): with a
    base, the error of a change relative to the change."""
    out, ref = out.double(), ref.double()
    den = ref if base is None else ref - base.double()
    return float(torch.linalg.vector_norm(out - ref) / torch.linalg.vector_norm(den))


def text_context(rows, texts: dict) -> List[float]:
    """For each text a cell conditions on ({text: the reference's encoding}),
    the error of the closest of the encoded rows against it: a text encoded
    wrong, or never (a wrong or a dropped prompt), reads large. The rows'
    order and batching are the program's own."""
    return [min((rel_l2(r, e) for r in rows), default=math.inf) for e in texts.values()]


@dataclasses.dataclass
class Reading:
    """One compared number, its limit and how many answers it covers."""

    name: str
    value: float
    limit: float
    answers: int = 1

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def readings_of(values: Dict[str, List[float]], limits: dict) -> List[Reading]:
    """The worst of each number's values, beside its limit."""
    return [Reading(name, max(vals), float(limits[name]["limit"]), len(vals))
            for name, vals in values.items()]


# --- clocks ------------------------------------------------------------------

def process_age_s() -> Optional[float]:
    """Seconds since this process started, from the kernel's record of its
    start (10 ms ticks); None where /proc does not say."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError, AttributeError):
        return None


class WindowClosed(Exception):
    """Raised from inside the program's call to end it once the window closes."""


@dataclasses.dataclass
class Window:
    """The measured window on the host's clock, opened and closed by the
    driver at the end of a unit of work (a flush of frames, a clip)."""

    seconds: float
    opened: Optional[float] = None
    closed: Optional[float] = None
    units: int = 0  # frames or clips finished after the opening

    def open(self) -> float:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.opened = time.perf_counter()
        return self.opened

    def after(self, units: int, now: float) -> bool:
        """Called at the end of each whole unit of work, with the units
        finished since the opening: closes the window, and returns True, at
        the first such end `seconds` or more after the opening."""
        if now - self.opened < self.seconds:
            return False
        self.closed, self.units = now, units
        return True

    @property
    def length(self) -> float:
        return self.closed - self.opened

    @property
    def per_unit(self) -> float:
        return self.length / self.units


def sample(seed: int, tag: str, population: Sequence, k: int) -> list:
    """k members of `population` (all if fewer), drawn by the seed."""
    rng = np.random.default_rng(derived_seed(seed, "sample", tag))
    pop = list(population)
    if len(pop) <= k:
        return pop
    return [pop[i] for i in sorted(rng.choice(len(pop), size=k, replace=False))]


# --- what a driver hands back --------------------------------------------------

@dataclasses.dataclass
class Outcome:
    """A run's window, its end-to-end values, the trace (when traced), the
    compared numbers and the device's peak memory."""

    window: Window
    end_to_end: Dict[str, Tuple[float, str]]
    readings: List[Reading]
    peak_bytes: Optional[int]
    view: object = None
    failed: int = 0
    control: Optional[Dict[str, List[float]]] = None  # the control's values, when asked
    # numbers read beside the check and compared with nothing (benchmark/calibrate.py prints
    # them): the program's values of each number, and the reference's own readings
    diagnostics: Dict[str, List[float]] = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return bool(self.readings) and all(r.ok for r in self.readings)


def seed_weights(cell: Cell) -> Dict[str, torch.Tensor]:
    """The configuration's weights drawn from the run's seed, in the types
    it serves them in (the same tensors' values for the program and, drawn
    again, for the reference)."""
    from benchmark import reference

    plan = weight_plan(*reference.layout(cell.config), cell.config)
    return make_weights(plan, cell.seed, cell.device)


def peak_bytes(device: torch.device) -> Optional[int]:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None


def release(device: torch.device) -> None:
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


class exact_float32:
    """float32 products in full float32 (TF32 off) while the reference runs."""

    def __enter__(self):
        self.old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.old
