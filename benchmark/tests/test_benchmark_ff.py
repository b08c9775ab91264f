"""The reader of the program's feed-forward span (`ff_ms`) on a hand-built
trace, and the span in the harness's profiler on a tiny traced run."""

from __future__ import annotations

import importlib
from collections import Counter

import pytest

from benchmark import common, trace


def read(view, name):
    return trace.load_reader(name, common.HERE / "metrics")(view, {"name": name})


def op(t0, t1, *spans):
    return trace.DeviceOp("gemm", t0, t1, frozenset(spans))


def ff_view(with_span=True):
    """Two U-Net calls: 3 us of device work under `unet.ff` (inside the
    transformers), 2 us elsewhere in the U-Net, 1 us outside it."""
    ff = ("unet.ff",) if with_span else ()
    ops = [op(0, 2000, "unet", "unet.spatial", *ff), op(2000, 3000, "unet", "unet.temporal", *ff),
           op(3000, 4000, "unet", "unet.spatial", "unet.norm"), op(4000, 5000, "unet", "unet.res"),
           op(5000, 6000, "sampler.ddim")]
    counts = Counter({"unet": 2, "unet.spatial": 2, "unet.temporal": 2, "unet.norm": 2})
    if with_span:
        counts["unet.ff"] = 4
    return trace.TraceView(ops=ops, span_counts=counts, window_s=10e-6, busy_s=6e-6, gaps=[],
                           launches={}, flops={}, counts={"units": 1, "decoded_frames": 4})


@pytest.mark.parametrize("name", ["ff_ms.fifo", "ff_ms.clip", "ff_ms.dc1024"])
def test_ff_ms_reads_the_ops_under_unet_ff_a_call(name):
    v = ff_view()
    assert read(v, name) == pytest.approx(3e-6 / 2 * 1e3)
    assert read(v, name) < read(v, "unet_ms.fifo") == pytest.approx(5e-6 / 2 * 1e3)
    assert read(ff_view(with_span=False), name) is None  # a program with no `unet.ff`


def test_ff_ms_reads_nothing_without_device_operations():
    v = ff_view()
    v.ops, v.busy_s = [], 0.0
    assert read(v, "ff_ms.fifo") is None


@pytest.mark.parametrize("name", ["vc2-fifo-davis", "vc1-i2v-clip"])
def test_the_feed_forward_span_reaches_the_harness_trace(name):
    """A tiny traced run: one `unet.ff` a transformer block a U-Net call; on
    the CPU no device operation is traced, so the reader reads nothing and
    raises nothing."""
    import torch

    from benchmark import program
    from benchmark.tests.tiny import tiny_cell
    from moca_tpu_torch.models.unet3d import BasicTransformerBlock, UNet3D, UNetConfig

    cell = tiny_cell(name, precision="float32", trace=True)
    with torch.device("meta"):
        unet = UNet3D(program._dataclass(UNetConfig, cell.config["unet"]))
    blocks = sum(isinstance(m, BasicTransformerBlock) for m in unet.modules())
    out = importlib.import_module(f"benchmark.drivers.{cell.traffic['entry']}").run(cell)
    counts = out.view.span_counts
    assert blocks and counts["unet"] and counts["unet.ff"] == blocks * counts["unet"]
    assert read(out.view, "ff_ms.fifo") is None
