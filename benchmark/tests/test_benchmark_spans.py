"""The readers of the program's own spans (`norm_ms`, `unet_idle_ms`,
`sampler_idle_ms`) on a hand-built trace, and the program's spans in the
harness's profiler on a tiny traced run."""

from __future__ import annotations

from collections import Counter

import pytest

from benchmark import common, trace


def read(view, name):
    return trace.load_reader(name, common.HERE / "metrics")(view, {"name": name})


def op(t0, t1, *spans):
    return trace.DeviceOp("elementwise", t0, t1, frozenset(spans))


def spanned_view():
    """Two U-Net calls and four frames in a 10 us window: 3 us of device work
    in `unet` alone, 2 us under `unet.norm`, 1 us outside the U-Net; 4 us
    idle, in gaps named by the innermost span open when the device went idle."""
    ops = [op(0, 2000, "fifo.iteration", "sampler.cfg", "unet", "unet.res", "unet.norm"),
           op(2000, 4000, "fifo.iteration", "sampler.cfg", "unet", "unet.res"),
           op(4000, 5000, "fifo.iteration", "sampler.cfg", "unet"),
           op(5000, 6000, "fifo.iteration", "sampler.moca")]
    gaps = [(1.5e-6, "unet"), (0.5e-6, "unet.temporal"), (1.0e-6, "sampler.moca"),
            (0.6e-6, "fifo.iteration"), (0.4e-6, "no span")]
    counts = Counter({"unet": 2, "unet.res": 2, "unet.norm": 2, "unet.temporal": 2,
                      "sampler.cfg": 2, "sampler.moca": 2, "fifo.iteration": 2})
    return trace.TraceView(ops=ops, span_counts=counts, window_s=10e-6, busy_s=6e-6, gaps=gaps,
                           launches={}, flops={}, counts={"units": 4, "decoded_frames": 4})


def test_norm_ms_reads_the_ops_under_unet_norm_a_call():
    v = spanned_view()
    assert read(v, "norm_ms.fifo") == pytest.approx(2e-6 / 2 * 1e3)
    assert read(v, "norm_ms.clip") == read(v, "norm_ms.fifo")
    assert read(v, "norm_ms.fifo") <= read(v, "unet_ms.fifo") == pytest.approx(5e-6 / 2 * 1e3)


def test_unet_idle_ms_reads_gaps_inside_the_unet_a_call():
    assert read(spanned_view(), "unet_idle_ms.fifo") == pytest.approx((1.5e-6 + 0.5e-6) / 2 * 1e3)


def test_sampler_idle_ms_reads_gaps_in_sampler_spans_a_unit():
    assert read(spanned_view(), "sampler_idle_ms.fifo") == pytest.approx(1.0e-6 / 4 * 1e3)


def test_the_idle_read_is_within_the_idle_the_trace_holds():
    v = spanned_view()
    unet = read(v, "unet_idle_ms.fifo") * v.span_counts["unet"]
    sampler = read(v, "sampler_idle_ms.fifo") * v.counts["units"]
    assert (unet + sampler) * 1e-3 <= v.window_s - v.busy_s
    assert sum(s for s, _ in v.gaps) == pytest.approx(v.window_s - v.busy_s)


def test_without_the_programs_spans_two_readers_read_nothing():
    """The harness's spans alone, as a program with no spans of its own
    leaves them: `unet_idle_ms` still reads the gaps under `unet`."""
    ops = [op(0, 3000, "fifo.iteration", "unet"), op(3000, 4000, "fifo.iteration")]
    gaps = [(2e-6, "unet"), (3e-6, "fifo.iteration"), (1e-6, "no span")]
    v = trace.TraceView(ops=ops, span_counts=Counter({"unet": 2, "fifo.iteration": 2}),
                        window_s=10e-6, busy_s=4e-6, gaps=gaps, launches={}, flops={},
                        counts={"units": 4, "decoded_frames": 4})
    assert read(v, "norm_ms.fifo") is None
    assert read(v, "sampler_idle_ms.fifo") is None
    assert read(v, "unet_idle_ms.fifo") == pytest.approx(2e-6 / 2 * 1e3)


def test_a_trace_with_no_device_operation_reads_nothing():
    v = spanned_view()
    v.ops, v.busy_s = [], 0.0
    for name in ("norm_ms.fifo", "unet_idle_ms.fifo", "sampler_idle_ms.fifo"):
        assert read(v, name) is None, name


@pytest.mark.parametrize("name", ["vc2-fifo-davis", "vc1-i2v-clip"])
def test_the_programs_spans_reach_the_harness_trace(name):
    """A tiny traced run: the program's spans land in the harness's profiler
    (user spans only), one `sampler.cfg` a `unet` call; on the CPU no device
    operation is traced, so the readers read nothing and raise nothing."""
    import importlib

    from benchmark.tests.tiny import tiny_cell

    cell = tiny_cell(name, precision="float32", trace=True)
    out = importlib.import_module(f"benchmark.drivers.{cell.traffic['entry']}").run(cell)
    counts = out.view.span_counts
    assert counts["unet"] and counts["sampler.cfg"] == counts["unet"]
    assert counts["unet.norm"] > counts["unet.res"] >= counts["unet"]
    assert counts["unet.spatial"] and counts["unet.temporal"]
    fifo = ("sampler.windows", "sampler.moca", "sampler.shift")
    if cell.traffic["entry"] == "moca_davis":
        assert all(counts[s] == counts["unet"] for s in fifo)
    else:
        assert counts["sampler.ddim"] == counts["unet"] and not any(counts[s] for s in fifo)
    for metric in ("norm_ms", "unet_idle_ms", "sampler_idle_ms"):
        assert read(out.view, f"{metric}.fifo") is None
