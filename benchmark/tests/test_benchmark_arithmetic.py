"""The benchmark's yardstick on the CPU: rooflines, FLOP counts, the window's
clock and the reduction of a trace, against hand-worked numbers."""

from __future__ import annotations

import math
from collections import Counter

import pytest
import torch

from benchmark import common, flops, trace
from benchmark.reference import nets


def test_attention_bound_spatial_row_is_bound_by_operations():
    # K1 at the FIFO U-Net's first level: 256 frames, S = 2560, 5 heads of 64
    ops = 4 * 256 * 5 * 2560 * 2560 * 64
    nbytes = (2 * 256 * 2560 + 2 * 256 * 2560) * 5 * 64 * 2
    assert ops / 989e12 > nbytes / 3.35e12
    assert flops.attention_bound_ms(256, 2560, 2560, 5, 64) == pytest.approx(ops / 989e12 * 1e3)


def test_packed_bound_matches_the_kernel_table():
    # PERF.md's K2 rows: N=40960, S=16, C=320 is bound by its bytes, 0.5008 ms
    assert flops.packed_bound_ms(40960, 16, 320, 5) == pytest.approx(0.50078, rel=1e-4)


def test_fused_qkv_fp32_bound_matches_the_kernel_table():
    # K3 fp32 at N=20480, C=320: 4.3524 ms read 38.3 % of its bound
    bound = flops.fused_qkv_bound_ms(20480, 16, 320, fp32=True)
    ops = 8 * 20480 * 16 * 320 * 320 + 4 * 20480 * 16 * 16 * 320
    assert bound == pytest.approx(ops / (494.7e12 / 3) * 1e3)
    assert bound / 4.3524 == pytest.approx(0.383, abs=1e-3)


def test_launches_bound_sums_every_launch_at_its_path():
    tallies = {"flash_attention": {(2, 128, 128, 1, 64): 3, (2, 128, 128, 1, 64, "fp32"): 1},
               "packed_attention": {(10, 16, 320, 5): 2}}
    want = (3 * flops.attention_bound_ms(2, 128, 128, 1, 64)
            + flops.attention_bound_ms(2, 128, 128, 1, 64, fp32=True)
            + 2 * flops.packed_bound_ms(10, 16, 320, 5))
    assert flops.launches_bound_ms(tallies) == pytest.approx(want)


def test_flop_count_of_a_cross_attention_by_hand():
    with torch.device("meta"):
        attn = nets.CrossAttention(64, heads=4, dim_head=16, ctx_dim=32)
        x, ctx = torch.empty(3, 10, 64), torch.empty(3, 7, 32)
    counted = flops.count_flops(attn, x, ctx)
    linears = 2 * 3 * (10 * 64 * 64 + 2 * 7 * 32 * 64 + 10 * 64 * 64)
    assert counted == linears + 4 * 3 * 4 * 10 * 7 * 16


def test_flop_count_of_a_convolution_by_hand():
    with torch.device("meta"):
        conv = nets.Conv2d(8, 16, 3, padding=1)
        counted = flops.count_flops(conv, torch.empty(2, 5, 6, 8))
    assert counted == 2 * 2 * 5 * 6 * 16 * 8 * 9


def flushes(window, times, size=8):
    for k, now in enumerate(times, start=1):
        if window.after(k * size, now):
            return
    raise AssertionError("the window never closed")


def test_window_counts_whole_flushes():
    w = common.Window(32.0)
    w.opened = 100.0
    flushes(w, [100.0 + 9.3 * k for k in range(1, 10)])
    assert w.units == 32 and w.length == pytest.approx(37.2)
    assert w.per_unit == pytest.approx(37.2 / 32)


def test_window_shows_a_stall():
    steady, stalled = common.Window(32.0), common.Window(32.0)
    steady.opened = stalled.opened = 0.0
    flushes(steady, [9.3, 18.6, 27.9, 37.2])
    flushes(stalled, [9.3, 18.6 + 12.0, 27.9 + 12.0])  # one flush 12 s late
    assert stalled.units == 24
    assert stalled.per_unit == pytest.approx(39.9 / 24)
    assert stalled.per_unit > 1.4 * steady.per_unit


def test_window_of_clips_closes_at_the_first_clip_past_its_length():
    w = common.Window(32.0)
    w.opened = 0.0
    assert not any(w.after(c, 8.6 * c) for c in (1, 2, 3))
    assert w.after(4, 34.4) and w.units == 4 and w.per_unit == pytest.approx(8.6)


def test_open_spans_nest_and_name_the_innermost():
    spans = [(0, 100, "fifo.iteration"), (10, 50, "unet"), (60, 90, "vae.decode")]
    got = trace.open_spans(spans, [5, 10, 20, 55, 70, 95, 200])
    assert [sorted(g[0]) for g in got] == [
        ["fifo.iteration"], ["fifo.iteration", "unet"], ["fifo.iteration", "unet"],
        ["fifo.iteration"], ["fifo.iteration", "vae.decode"], ["fifo.iteration"], []]
    assert [g[1] for g in got] == ["fifo.iteration", "unet", "unet", "fifo.iteration",
                                   "vae.decode", "fifo.iteration", "no span"]


def view(ops, window_s=1e-6, busy_s=0.0, **kw):
    fields = dict(ops=ops, span_counts=Counter(), window_s=window_s, busy_s=busy_s, gaps=[],
                  launches={}, flops={}, counts={})
    fields.update(kw)
    return trace.TraceView(**fields)


def test_readers_on_a_synthetic_trace():
    op = lambda name, t0, t1, *spans: trace.DeviceOp(name, t0, t1, frozenset(spans))
    v = view([op("void flash_fwd<...>", 0, 400, "unet"), op("sm90_xmma_fprop", 400, 1000, "unet"),
              op("elementwise", 1000, 1100), op("conv decode", 1100, 1500, "vae.decode")],
             window_s=2e-6, busy_s=1.5e-6, span_counts=Counter(unet=2),
             counts={"units": 4, "decoded_frames": 4},
             launches={"flash_attention": {(1, 128, 128, 1, 64): 2}},
             flops={"unet": 1e6, "vae": 1e6})
    read = lambda name: trace.load_reader(name, common.HERE / "metrics")(v, {"name": name})
    assert read("unet_ms.fifo") == pytest.approx(1000e-9 / 2 * 1e3)
    assert read("vae_ms.fifo") == pytest.approx(400e-9 / 4 * 1e3)
    assert read("sampler_ms.fifo") == pytest.approx(100e-9 / 4 * 1e3)
    assert read("idle_share.fifo") == pytest.approx(25.0)
    assert read("mfu.fifo") == pytest.approx(100 * 2e6 / (2e-6 * 989e12))
    bound = 2 * flops.attention_bound_ms(1, 128, 128, 1, 64)
    assert read("attn_roofline.fifo") == pytest.approx(100 * bound / (400e-9 * 1e3))
    assert read("image_embed_ms.clip") is None  # nothing to read: left out, never 0


def test_readers_leave_out_a_trace_with_no_device_operation():
    v = view([], window_s=2.0, busy_s=0.0, span_counts=Counter(unet=3),
             counts={"units": 4, "decoded_frames": 4})
    read = lambda name: trace.load_reader(name, common.HERE / "metrics")(v, {"name": name})
    for name in ("unet_ms.fifo", "vae_ms.fifo", "sampler_ms.fifo", "idle_share.fifo",
                 "attn_roofline.fifo", "image_embed_ms.clip", "mfu.fifo"):
        assert read(name) is None, name


def test_breakdown_names_kernels_and_idle_spans():
    op = lambda name, t0, t1: trace.DeviceOp(name, t0, t1, frozenset())
    v = view([op("sm90_xmma_fprop_a", 0, 300), op("void packed_fwd<16>", 300, 400)],
             gaps=[(2e-7, "vae.decode"), (1e-7, "no span"), (5e-8, "vae.decode")])
    b = trace.breakdown(v)
    assert b["device_ops"][0] == ["convolution: sm90_xmma_fprop_a", pytest.approx(3e-7)]
    assert b["device_ops"][1][0] == "K2 packed_attention: void packed_fwd<16>"
    assert b["idle_gaps"] == [["vae.decode", pytest.approx(2.5e-7)],
                              ["no span", pytest.approx(1e-7)]]


def test_rel_l2_of_a_change():
    base = torch.zeros(4)
    ref, out = torch.tensor([3.0, 4.0, 0, 0]), torch.tensor([3.0, 4.0, 0.5, 0])
    assert common.rel_l2(out, ref) == pytest.approx(0.1)
    assert common.rel_l2(out + 10, ref + 10, base=base + 10) == pytest.approx(0.1)


def test_seeded_normal_is_the_same_draw_in_any_order():
    a, b = common.SeededNormal(2**33 + 7, "cpu"), common.SeededNormal(2**33 + 7, "cpu")
    x1, y1 = a(("fifo", 3, "anchor"), (2, 3)), a(("encode",), (4,))
    y2, x2 = b(("encode",), (4,)), b(("fifo", 3, "anchor"), (2, 3))
    assert torch.equal(x1, x2) and torch.equal(y1, y2)
    assert not torch.equal(a(("fifo", 4, "anchor"), (2, 3)), x1)


def test_weights_are_the_seeds_and_aligned():
    plan = [("unet.a", (3, 5), torch.bfloat16, 0.0, 0.02), ("unet.b", (7,), torch.bfloat16, 0.0, 0.02),
            ("vision.c", (2, 2), torch.float32, 0.0, 0.02),
            ("unet.k_ip", (4,), torch.bfloat16, 0.0, 0.2),
            ("unet.norm.weight", (64,), torch.bfloat16, 1.0, 0.02)]
    w1, w2 = common.make_weights(plan, 11, "cpu"), common.make_weights(plan, 11, "cpu")
    assert list(w1) == [p[0] for p in plan]
    for name, shape, dtype, mean, std in plan:
        assert w1[name].shape == shape and w1[name].dtype == dtype
        assert torch.equal(w1[name], w2[name])
        assert w1[name].storage_offset() % common.ALIGN == 0
    assert not torch.equal(common.make_weights(plan, 12, "cpu")["unet.a"], w1["unet.a"])
    assert w1["unet.k_ip"].float().abs().max() > 3 * w1["unet.a"].float().abs().max()
    assert abs(w1["unet.norm.weight"].float().mean() - 1.0) < 0.01


def test_weight_plan_takes_the_configuration():
    from benchmark import reference

    config = common.load_json(common.HERE / "configs" / "vc1-i2v-512.json")
    shapes, norms = reference.layout(config)
    assert "unet.input_blocks.1.0.in_layers.0.weight" in norms  # a GroupNorm's scale
    assert "clip.ln_final.weight" in norms and "image_proj.norm_out.weight" in norms
    assert "unet.input_blocks.1.0.in_layers.2.weight" not in norms  # the conv after it
    plan = {p[0]: p[2:] for p in common.weight_plan(shapes, norms, config)}
    assert plan["clip.ln_final.weight"] == (torch.bfloat16, 1.0, 0.02)
    assert plan["vision.ln_pre.bias"] == (torch.float32, 0.0, 0.02)
    assert plan["unet.input_blocks.1.1.transformer_blocks.0.attn2.to_k_ip.weight"] == (
        torch.bfloat16, 0.0, 0.2)
    # the text cross-attention's keys and values read the context at 0.2; the
    # temporal transformer's second self-attention (block .2) does not
    assert plan["unet.middle_block.1.transformer_blocks.0.attn2.to_v.weight"] == (
        torch.bfloat16, 0.0, 0.2)
    assert plan["unet.input_blocks.1.2.transformer_blocks.0.attn2.to_k.weight"] == (
        torch.bfloat16, 0.0, 0.02)
    raised = {name for name, (_, _, std) in plan.items() if std == 0.2}
    assert len(raised) == 64 and all(shapes[n][1] == config["unet"]["context_dim"] for n in raised)


def test_control_rounding_is_coarser_than_bfloat16():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    err = lambda kind: float((nets.Rounding(kind)(x) - x).norm() / x.norm())
    assert err(None) == 0.0
    assert 0.001 < err("bfloat16") < 0.004
    assert err("float8") > 8 * err("bfloat16")
    assert math.isfinite(err("float8"))
