"""The DynamiCrafter cell (`dc1024-i2v-clip`, driver `i2v_hybrid`) at a size
the CPU runs in seconds: the reference's weights carry the program's names,
a whole run in float32 is correct, each planted fault of
`benchmark/faults_hybrid.py` moves it far, the control is not correct and reads three
times the bf16 program or more, the program's spans reach the harness's
trace, and `xattn_ms` reads a hand-built trace."""

from __future__ import annotations

import importlib
from collections import Counter

import pytest
import torch

from benchmark import common, trace
from benchmark.drivers import i2v_hybrid
from benchmark.faults_hybrid import FAULTS
from benchmark.reference import hybrid_i2v
from benchmark.run import execute
from benchmark.tests.tiny import tiny_cell

CELL = "dc1024-i2v-clip"


def tiny(seed: int = 5, precision: str = "float32", trace: bool = False) -> common.Cell:
    """The cell at the harness's tiny widths: the Resampler's queries for
    the tiny clip's frames, a late step among its last two."""
    cell = tiny_cell(CELL, seed=seed, precision=precision, trace=trace)
    c, t = cell.config, cell.traffic
    c["resampler"].update(video_length=t["frames"], embedding_dim=c["vision"]["width"],
                          output_dim=c["unet"]["context_dim"])
    t["check"]["late_from"] = t["ddim_steps"] - 2
    return cell


def test_weights_have_the_programs_names_and_shapes():
    cell = tiny()
    model = i2v_hybrid.build_model(cell.config)
    assert hybrid_i2v.layout(cell.config)[0] == {k: tuple(v.shape)
                                                 for k, v in model.state_dict().items()}


def test_a_whole_run_is_correct():
    line, _ = execute(tiny(), 0.0)
    assert line["correct"], line["check"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["check"]) == {"image_tokens", "concat_latent", "text_context", "step",
                                  "frames"}
    assert line["check"]["step"]["answers"] == 2 * line["attempted"]
    assert all(r["value"] < 1e-3 for r in line["check"].values()), line["check"]


@pytest.fixture(scope="module")
def sound():
    line, _ = execute(tiny(), 0.0)
    return {k: r["value"] for k, r in line["check"].items()}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_reads_far_above_the_sound_run(fault, sound, monkeypatch):
    """Each fault moves a compared number to a hundred times the sound
    float32 run's reading or more (or to no finite value). Whether it fails
    the cell's limits is read at full size, on the card (PERF.md): the tiny
    widths move the U-Net's output less than the cell's own, and the limits
    were set from the cell's."""
    FAULTS[fault](monkeypatch.setattr)
    line, _ = execute(tiny(), 0.0)
    got = {k: r["value"] for k, r in line["check"].items()}
    assert any(not v < float("inf") or v > 100 * sound[k] for k, v in got.items()), got


def test_control_is_not_correct():
    program, control = {}, {}
    for seed in (3000000019, 2147483801):
        cell = tiny(seed=seed, precision=None)
        cell.control = True
        out = i2v_hybrid.run(cell)
        for r in out.readings:
            program[r.name] = max(program.get(r.name, 0.0), r.value)
        for k, v in out.control.items():
            control[k] = min(control.get(k, float("inf")), max(v))
        limits = {r.name: r.limit for r in out.readings}
        assert any(max(v) > limits[k] for k, v in out.control.items()), out.control
    for k in program:
        assert control[k] >= 3 * program[k], (k, program[k], control[k])


def test_the_programs_spans_reach_the_harness_trace():
    """One `unet.xattn` a spatial transformer a U-Net call, `vae.encode` once
    a clip; on the CPU no device operation is traced, so the reader reads
    nothing and raises nothing."""
    from moca_tpu_torch.models.unet3d import SpatialTransformer

    cell = tiny(trace=True)
    out = importlib.import_module(f"benchmark.drivers.{cell.entry}").run(cell)
    counts = out.view.span_counts
    spatial = sum(isinstance(m, SpatialTransformer)
                  for m in i2v_hybrid.build_model(cell.config).modules())
    assert counts["unet"] and counts["unet.xattn"] == spatial * counts["unet"]
    assert counts["vae.encode"] == out.window.units
    assert counts["image_embed"] == 2 * out.window.units
    read = trace.load_reader("xattn_ms.dc1024", common.HERE / "metrics")
    assert read(out.view, {"name": "xattn_ms.dc1024"}) is None


def op(t0, t1, *spans):
    return trace.DeviceOp("elementwise", t0, t1, frozenset(spans))


def test_xattn_ms_reads_the_ops_under_unet_xattn_a_call():
    """Two U-Net calls: 3 us of device work under `unet.xattn` (inside
    `unet.spatial`), 4 us elsewhere in the U-Net, 1 us outside it."""
    ops = [op(0, 2000, "unet", "unet.spatial", "unet.xattn"),
           op(2000, 3000, "unet", "unet.spatial", "unet.xattn"),
           op(3000, 5000, "unet", "unet.spatial"), op(5000, 7000, "unet", "unet.res"),
           op(7000, 8000, "sampler.ddim")]
    view = trace.TraceView(ops=ops, span_counts=Counter({"unet": 2, "unet.spatial": 4,
                                                         "unet.xattn": 4}),
                           window_s=10e-6, busy_s=8e-6, gaps=[], launches={}, flops={},
                           counts={"units": 1, "decoded_frames": 4})
    read = lambda name: trace.load_reader(name, common.HERE / "metrics")(view, {"name": name})
    assert read("xattn_ms.dc1024") == pytest.approx(3e-6 / 2 * 1e3)
    assert read("xattn_ms.clip") == read("xattn_ms.dc1024") < read("unet_ms.clip")
    view.ops = ops[2:]  # a program that opens no `unet.xattn`
    assert read("xattn_ms.dc1024") is None


@torch.inference_mode()
def test_the_reference_v_step_at_t999_is_defined():
    """At the zero-SNR schedule's last timestep alpha_bar = 0: eps = x and x0
    = -v r_prev / r, finite, where the eps parameterization divides by 0."""
    cell = tiny()
    sch = hybrid_i2v.Schedule(50, 1.0, cell.config["diffusion"], "cpu")
    assert sch.timesteps[-1] == 999 and float(sch.sqrt_a[-1]) == 0.0
    x, v, noise = torch.randn(3, 1, 4, 4, 8, 4)
    out = hybrid_i2v.v_step(sch, x, v, 49, noise)
    x0 = -v * sch.r_prev[49] / sch.r[49]
    a_prev, sigma = sch.a_prev[49], sch.sigma[49]
    want = (torch.sqrt(a_prev) * x0 + torch.sqrt(1 - a_prev - sigma**2) * x + sigma * noise)
    assert torch.isfinite(out).all() and common.rel_l2(out, want) < 1e-6
