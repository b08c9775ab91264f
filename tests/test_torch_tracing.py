"""The port's trace ranges (utils/profiling.py `annotate`).

A MoCA stream in DAVIS mode and a few DDIM steps of the text-to-video
pipeline, on the tiny configuration of the other port tests, under a CPU
`torch.profiler`: every range appears, nested where it belongs, as often a
call as the U-Net has blocks and norms, and only the U-Net's norms open
`unet.norm`. With no profiler recording, no range is made at all and the
frames are the same.
"""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from moca_tpu_torch.models.clip_text import CLIPTextConfig
from moca_tpu_torch.models.latent_diffusion import init_random_model
from moca_tpu_torch.models.tokenizer import HashTokenizer
from moca_tpu_torch.models.unet3d import (BasicTransformerBlock, ResBlock, SpatialTransformer,
                                          TemporalTransformer, UNetConfig)
from moca_tpu_torch.models.vae import VAEConfig
from moca_tpu_torch.ops.norms import GroupNorm32, LayerNorm32
from moca_tpu_torch.pipelines.moca_video import MoCAVideoPipeline
from moca_tpu_torch.pipelines.t2v import T2VPipeline
from moca_tpu_torch.sampling.ddim import GeneratorNormal
from moca_tpu_torch.utils import profiling

H = W = 32  # latent 4x4
F, N, NEW, T0, STEPS = 4, 2, 2, 6, 3
UNET = dict(model_channels=32, num_head_channels=8, context_dim=16, channel_mult=(1, 2),
            attention_resolutions=(1, 2), num_res_blocks=1, temporal_length=F)
SPANS = ("unet.res", "unet.spatial", "unet.temporal", "unet.norm", "unet.ff",
         "sampler.windows", "sampler.cfg", "sampler.moca", "sampler.shift", "sampler.ddim",
         "timer.sync")
BLOCKS = ("unet.res", "unet.spatial", "unet.temporal")


@pytest.fixture(scope="module")
def model():
    return init_random_model(UNetConfig(**UNET),
                             VAEConfig(ch=16, ch_mult=(1, 1, 2, 2), num_res_blocks=1,
                                       resolution=H),
                             CLIPTextConfig(width=16, heads=2, layers=2),
                             generator=torch.Generator().manual_seed(0), device="cpu")


def _modules(net, *types):
    return sum(isinstance(m, types) for m in net.modules())


def _davis_inputs(model):
    rng = np.random.default_rng(7)
    frames = rng.uniform(-1, 1, (T0, H, W, 3)).astype(np.float32)
    masks = np.zeros((T0, H // 8, W // 8), np.float32)
    masks[:, 1:3, 1:3] = 1.0
    cond = rng.standard_normal((H // 8, W // 8, 4)).astype(np.float32)
    clean = model.encode_frames(torch.as_tensor(frames)[None], GeneratorNormal(3, "cpu"))
    return frames, masks, cond, clean


def _stream(model):
    frames, masks, cond, clean = _davis_inputs(model)
    pipe = MoCAVideoPipeline(model, HashTokenizer(), video_length=F, num_partitions=N,
                             new_video_length=NEW, guidance_scale=7.5)
    return pipe("a bear", normal=GeneratorNormal(5, "cpu"), cond_image=cond, gamma=0.7,
                height=H, width=W, clean_latents=clean, masks=masks, davis_frames=frames)


def _clip(model):
    pipe = T2VPipeline.build(model, HashTokenizer(), num_steps=STEPS, guidance_scale=7.5)
    return pipe("a bear", seed=9, height=H, width=W, frames=F)


def _traced(run, model):
    """run(model) under a CPU profiler, the U-Net call inside a `unet` range
    as the benchmark wraps it. Returns (output, [(name, ancestors' names,
    the U-Net call it is or lies in, or None)])."""
    def unet(*args, **kwargs):
        with torch.profiler.record_function("unet"):
            return type(model).apply_unet(model, *args, **kwargs)
    model.apply_unet = unet
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = run(model)
    finally:
        del model.apply_unet
    spans = []
    for e in prof.events():
        if e.name in SPANS + ("unet",):
            up, parent = [], e.cpu_parent
            while parent is not None:
                up.append(parent)
                parent = parent.cpu_parent
            call = next((id(a) for a in [e] + up if a.name == "unet"), None)
            spans.append((e.name, [a.name for a in up], call))
    return out, spans


@pytest.fixture(scope="module")
def traced(model):
    return {"stream": _traced(_stream, model), "clip": _traced(_clip, model)}


def _per_call(spans, name):
    """The number of `name` ranges in each U-Net call."""
    calls = Counter(call for span, _, call in spans if span == "unet")
    got = Counter(call for span, _, call in spans if span == name)
    return [got[call] for call in calls]


def test_stream_spans_nest_and_count(model, traced):
    _, spans = traced["stream"]
    names = Counter(s for s, _, _ in spans)
    iterations = NEW + F * N - F
    assert names["unet"] == names["sampler.cfg"] == iterations
    for name in ("sampler.windows", "sampler.moca", "sampler.shift"):
        assert names[name] == iterations, name  # one a FIFO iteration, not one a frame
    assert names["sampler.ddim"] == 0  # DAVIS mode skips the base sample
    net = model.unet
    for name, types in (("unet.norm", (GroupNorm32, LayerNorm32)), ("unet.res", (ResBlock,)),
                        ("unet.spatial", (SpatialTransformer,)),
                        ("unet.temporal", (TemporalTransformer,))):
        assert _per_call(spans, name) == [_modules(net, *types)] * iterations, name
    assert sum(_per_call(spans, "unet.norm")) == names["unet.norm"]  # none outside a call
    for span, up, _ in spans:
        if span == "unet":
            assert up[0] == "sampler.cfg"
        if span.startswith("unet."):
            assert "unet" in up
        if span in ("sampler.windows", "sampler.moca", "sampler.shift", "sampler.cfg"):
            assert not any(a.startswith(("unet", "sampler.")) for a in up), (span, up)
    # every norm inside a block but the output head's, one a call
    loose = [up for span, up, _ in spans if span == "unet.norm" and not set(up) & set(BLOCKS)]
    assert len(loose) == iterations and all(up[0] == "unet" for up in loose)


def test_clip_spans_nest_and_count(model, traced):
    _, spans = traced["clip"]
    names = Counter(s for s, _, _ in spans)
    assert names["sampler.ddim"] == names["sampler.cfg"] == names["unet"] == STEPS
    assert _per_call(spans, "unet.norm") == [_modules(model.unet, GroupNorm32,
                                                      LayerNorm32)] * STEPS
    assert _per_call(spans, "unet.res") == [_modules(model.unet, ResBlock)] * STEPS
    for span, up, _ in spans:
        if span == "sampler.cfg":
            assert up[0] == "sampler.ddim"
        if span == "unet":
            assert up[:2] == ["sampler.cfg", "sampler.ddim"]
        if span == "unet.norm":
            assert "unet" in up


@pytest.mark.parametrize("run", ["stream", "clip"])
def test_feed_forward_spans_one_a_block(model, traced, run):
    """`unet.ff` once a transformer block a U-Net call, inside its spatial or
    temporal transformer; the block's norm runs before it opens, so no
    `unet.norm` lies inside one."""
    _, spans = traced[run]
    blocks = _modules(model.unet, BasicTransformerBlock)
    assert blocks and _per_call(spans, "unet.ff") == [blocks] * Counter(
        s for s, _, _ in spans)["unet"]
    for span, up, _ in spans:
        if span == "unet.ff":
            assert up[0] in ("unet.spatial", "unet.temporal") and "unet" in up, up
        if span == "unet.norm":
            assert "unet.ff" not in up


def test_only_the_unet_names_its_norms(model):
    norm = (GroupNorm32, LayerNorm32)
    unet_norms = {id(m) for m in model.unet.modules() if isinstance(m, norm)}
    others = [m for m in model.modules() if isinstance(m, norm) and id(m) not in unet_norms]
    assert others and all(m.span is None for m in others)  # the VAE's and the text tower's
    assert {m.span for m in model.unet.modules() if id(m) in unet_norms} == {"unet.norm"}

    def towers(model):
        tokens = HashTokenizer()(["a bear"])
        model.encode_tokens(tokens)
        clean = _davis_inputs(model)[3]  # the VAE encoder
        return model.decode_single(clean[0, :1])
    _, spans = _traced(towers, model)
    assert not spans


def test_timer_sync_span(monkeypatch):
    waits = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: waits.append(device))
    timer = profiling.StepTimer(enabled=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        timer.record("sample", 0.0, torch.device("cuda"))
        timer.record("decode", 0.0, torch.device("cpu"))  # no device to wait for
    names = [e.name for e in prof.events() if e.name == "timer.sync"]
    assert names == ["timer.sync"] and len(waits) == 1


def test_annotate_makes_no_range_when_nothing_records(model, traced, monkeypatch):
    (stream_on, _), (clip_on, _) = traced["stream"], traced["clip"]

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler recording")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch._C._autograd._profiler_enabled()
    assert profiling.annotate("unet.res") is profiling.annotate("sampler.moca")
    stream_off, clip_off = _stream(model), _clip(model)
    assert len(stream_off) == len(stream_on)
    for a, b in zip(stream_off, stream_on):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(clip_off.numpy(), clip_on.numpy())


def test_annotate_records_under_an_autograd_profiler():
    """A profiler started the way a harness may start it,
    `torch.autograd._enable_profiler`, leaves the Python flag False; the
    range is recorded all the same."""
    from torch.autograd import profiler as autograd_profiler
    from torch._C._profiler import RecordScope

    prof = autograd_profiler.profile(use_kineto=True)
    prof._prepare_trace()
    torch.autograd._enable_profiler(prof.config(create_trace_id=False),
                                    prof.kineto_activities, {RecordScope.USER_SCOPE})
    try:
        assert not autograd_profiler._is_profiler_enabled
        with profiling.annotate("unet.norm"):
            torch.ones(4) + 1
    finally:
        prof.__exit__(None, None, None)
    names = [e.name() for e in prof.kineto_results.events() if e.is_user_annotation()]
    assert names == ["unet.norm"]
