"""Spans around the program's layers, the profiler over the window, and the
trace reduced to what the per-layer readers read.

Spans are `torch.profiler.record_function` ranges that the benchmark wraps
around the layer entry points of the program's objects (their instances,
not their classes), so they exist only in a traced run. A device operation
belongs to every span that was open on the host when it was launched (the
kernel and its launch share a correlation id in the trace).
"""

from __future__ import annotations

import dataclasses
import functools
from collections import Counter
from typing import Callable, Dict, List, Optional, Tuple

import torch

# kernel-name substrings -> category, first match wins: chip_smoke.py's
# `_CATEGORIES`, with K2's span design (span_narrow, span_wide) and the fp32
# bodies (tf32x3_fwd) added
CATEGORIES = (
    ("flash_fwd", "K1 flash_attention"), ("packed_fwd", "K2 packed_attention"),
    ("span_narrow", "K2 packed_attention"), ("span_wide", "K2 packed_attention"),
    ("fused_qkv_fwd", "K3 fused_qkv_attention"), ("onepass_fwd", "K4 flash_attention_onepass"),
    ("tf32x3_fwd", "K1/K3/K4 fp32"),
    ("fprop", "convolution"), ("conv", "convolution"), ("dgrad", "convolution"),
    ("gemm", "matmul"), ("nvjet", "matmul"), ("cutlass", "matmul"),
    ("softmax", "softmax"), ("reduce", "reduction"), ("norm", "reduction"),
    ("welford", "reduction"), ("cat", "copy"), ("copy", "copy"), ("memcpy", "copy"),
    ("memset", "copy"), ("elementwise", "elementwise"), ("vectorized", "elementwise"))
ATTENTION_KERNELS = ("K1 ", "K2 ", "K3 ", "K4 ", "K1/K3/K4")


def category(name: str) -> str:
    low = name.lower()
    return next((c for key, c in CATEGORIES if key in low), "other")


class Spans:
    """record_function ranges around methods of the program's objects, put
    in place only when the run is traced."""

    def __init__(self, enabled: bool):
        self.enabled = enabled

    def wrap(self, obj, method: str, span: str) -> None:
        if not self.enabled:
            return
        inner = getattr(obj, method)

        @functools.wraps(inner)
        def traced(*args, **kwargs):
            with torch.profiler.record_function(span):
                return inner(*args, **kwargs)
        setattr(obj, method, traced)


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: int
    end: int
    spans: frozenset

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9


@dataclasses.dataclass
class TraceView:
    """What the readers read: the device operations of the traced window,
    each with the spans open at its launch, the spans' counts, the window's
    length, the launches and the model FLOPs the driver counted, and the
    units (frames or clips) finished in the window."""

    ops: List[DeviceOp]
    span_counts: Counter
    window_s: float
    busy_s: float
    gaps: List[Tuple[float, str]]
    launches: dict
    flops: Dict[str, float]
    counts: Dict[str, int]

    def seconds(self, span: Optional[str] = None, exclude=()) -> float:
        return sum(op.seconds for op in self.ops
                   if (span is None or span in op.spans) and not (op.spans & set(exclude)))


class Profiler:
    """torch.profiler over CUDA activity (the kernels and their launches)
    and the `record_function` spans alone between `start` and `stop`, with
    a `window` span between them: the profiler's observer records no
    operator of the program, so the traced host runs close to the untraced
    one."""

    WINDOW = "benchmark.window"

    def __init__(self):
        from torch.autograd import profiler as autograd_profiler

        self.cuda = torch.cuda.is_available()
        self.prof = autograd_profiler.profile(use_device="cuda" if self.cuda else None,
                                              use_kineto=True)
        self.span = torch.profiler.record_function(self.WINDOW)

    def start(self) -> None:
        from torch._C._profiler import RecordScope

        self.prof._prepare_trace()
        torch.autograd._enable_profiler(self.prof.config(create_trace_id=False),
                                        self.prof.kineto_activities, {RecordScope.USER_SCOPE})
        self.span.__enter__()

    def stop(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
        self.span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    def view(self, launches: dict, flops: Dict[str, float], counts: Dict[str, int]) -> TraceView:
        events = self.prof.kineto_results.events()
        cpu = torch.autograd.DeviceType.CPU
        spans, launch_at, device = [], {}, []
        for e in events:
            if e.device_type() == cpu:
                if e.is_user_annotation():
                    spans.append((e.start_ns(), e.end_ns(), e.name()))
                elif e.name().startswith(("cuda", "cu")):
                    launch_at[e.correlation_id()] = e.start_ns()
            elif not e.is_user_annotation() and "ynchronize" not in e.name():
                device.append((e.start_ns(), e.end_ns(), e.name(), e.correlation_id()))
        window = next(s for s in spans if s[2] == self.WINDOW)
        spans = [s for s in spans if s[2] != self.WINDOW and window[0] <= s[0] <= window[1]]
        device = sorted((max(s, window[0]), min(e, window[1]), name, launch_at.get(corr, s))
                        for s, e, name, corr in device if min(e, window[1]) > max(s, window[0]))
        launched = open_spans(spans, [d[3] for d in device])
        ops = [DeviceOp(name, s, e, launched[i][0]) for i, (s, e, name, _) in enumerate(device)]
        busy, gaps, reach = 0, [], window[0]
        for op in ops:  # union of the device intervals, and the idle gaps between
            if op.start > reach:
                gaps.append((reach, op.start))
            busy += max(0, op.end - max(op.start, reach))
            reach = max(reach, op.end)
        if window[1] > reach:
            gaps.append((reach, window[1]))
        idle_at = open_spans(spans, [g[0] for g in gaps])
        return TraceView(ops=ops, span_counts=Counter(s[2] for s in spans),
                         window_s=(window[1] - window[0]) * 1e-9, busy_s=busy * 1e-9,
                         gaps=[((e - s) * 1e-9, idle_at[i][1]) for i, (s, e) in enumerate(gaps)],
                         launches=launches, flops=flops, counts=counts)


def open_spans(spans, times) -> List[Tuple[frozenset, str]]:
    """For each host time (in any order): the names of the spans open then,
    and the innermost one ("no span" outside all). Spans of one thread nest;
    a span is open from its start to its end, both included."""
    marks = sorted([(s, 0, i) for i, (s, _, _) in enumerate(spans)]
                   + [(t, 1, j) for j, t in enumerate(times)]
                   + [(e, 2, i) for i, (_, e, _) in enumerate(spans)])
    out: List[Tuple[frozenset, str]] = [None] * len(times)
    stack: List[int] = []
    current = (frozenset(), "no span")
    for _, kind, k in marks:
        if kind == 1:
            out[k] = current
            continue
        if kind == 0:
            stack.append(k)
        else:
            stack.remove(k)
        current = (frozenset(spans[i][2] for i in stack),
                   spans[stack[-1]][2] if stack else "no span")
    return out


def breakdown(view: TraceView, top: int = 10) -> dict:
    """The device operations that took most time (by kernel name, with its
    category) and the idle time by the host span open when the device went
    idle."""
    by_name: Dict[str, float] = {}
    for op in view.ops:
        by_name[op.name] = by_name.get(op.name, 0.0) + op.seconds
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle: Dict[str, float] = {}
    for seconds, span in view.gaps:
        idle[span] = idle.get(span, 0.0) + seconds
    return {"device_ops": [[f"{category(n)}: {n[:160]}", s] for n, s in ops],
            "idle_gaps": sorted(([k, v] for k, v in idle.items()), key=lambda kv: -kv[1])[:top]}


def categories(view: TraceView) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for op in view.ops:
        c = category(op.name)
        out[c] = out.get(c, 0.0) + op.seconds
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def load_reader(name: str, metrics_dir) -> Callable:
    """The reader of per-layer metric `name`: metrics/<quantity>.py, the
    quantity being the part of the name before its first dot."""
    import importlib.util

    stem = name.split(".")[0]
    path = metrics_dir / f"{stem}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader for per-layer metric {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
