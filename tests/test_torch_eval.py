"""The port's evaluation modules and sweep against the JAX package's.

SSIM, PSNR, the temporal proxy, the CLIP cosine, CASS, relCASS and
`concept_alignment_scores`; the CLIP text tower's pooled `embed` output and
its loader; the AlexNet taps and LPIPS through `convert_lpips_weights`; I3D
(preprocess, features, logits at the smallest legal size, both refusals)
through `convert_i3d_weights`; the Fréchet distance, `StreamingFVD` against
the batch `fvd`; the VBench glue; and the evaluation sweep against
scripts/eval_sweep.py with the same tiny pipeline injected on both sides
(its noise replayed from the JAX keys), same files, same keys, same values.
The same inputs, made with numpy from a seed, go through both packages; fp32
on the CPU; tolerances are stated per test.
"""

import functools
import importlib.util
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_oracle_i3d import _tiny_synthetic_state_dict
from test_torch_i2v import VISION, _rand
from test_torch_sampling import JaxReplayNormal, one_torch_thread, pipeline_keys  # noqa: F401
from test_torch_slice import CLIP, F, H, N, W
from test_torch_davis import models  # noqa: F401  (fixture)

import moca_tpu.cli.main as jcli
from moca_tpu.eval import fvd as jfvd
from moca_tpu.eval import i3d as ji3d
from moca_tpu.eval import metrics as jmetrics
from moca_tpu.eval import vbench as jvbench
from moca_tpu.models import clip_vision as jvision
from moca_tpu.models import convert as jconvert
from moca_tpu.models.clip_text import CLIPTextConfig as JCLIPConfig
from moca_tpu.models.clip_text import CLIPTextEncoder as JCLIPTextEncoder
from moca_tpu.models.tokenizer import HashTokenizer as JHashTokenizer
from moca_tpu.pipelines.moca_video import MoCAVideoPipeline as JPipeline
from moca_tpu_torch.cli import eval_sweep
from moca_tpu_torch.eval import fvd as tfvd
from moca_tpu_torch.eval import i3d as ti3d
from moca_tpu_torch.eval import metrics as tmetrics
from moca_tpu_torch.eval import vbench as tvbench
from moca_tpu_torch.io.checkpoint import load_text_tower
from moca_tpu_torch.models import clip_vision as tvision
from moca_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
from moca_tpu_torch.models.convert import clip_from_jax
from moca_tpu_torch.models.tokenizer import HashTokenizer
from moca_tpu_torch.pipelines.moca_video import MoCAVideoPipeline

ROOT = Path(__file__).resolve().parent.parent


def _pair(shape, seed):
    """Two [0, 1] image batches: a uniform one and a noised copy."""
    a = _rand(shape, seed, 0.0, 1.0)
    return a, np.clip(a + 0.2 * _rand(shape, seed + 1), 0, 1).astype(np.float32)


# ---------------------------------------------------------------------------
# SSIM, PSNR, the temporal proxy, CASS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 32, 40, 3), (2, 2, 24, 24, 3)])
def test_ssim_psnr_and_temporal_proxy_match_jax(shape):
    """Per-image SSIM and PSNR (also over two leading axes) and the
    temporal proxy of a clip: fp32 Gaussian-window sums in another order
    (observed <= 5.7e-7 for SSIM and the proxy, <= 1.9e-6 dB for PSNR;
    bounds 5e-6, 2e-5)."""
    a, b = _pair(shape, 1)
    np.testing.assert_allclose(tmetrics.ssim(a, b).numpy(), np.asarray(jmetrics.ssim(a, b)),
                               rtol=0, atol=5e-6)
    np.testing.assert_allclose(tmetrics.psnr(a, b).numpy(), np.asarray(jmetrics.psnr(a, b)),
                               rtol=0, atol=2e-5)
    clip = a.reshape((-1,) + shape[-3:])
    np.testing.assert_allclose(float(tmetrics.temporal_lpips_proxy(clip)),
                               float(jmetrics.temporal_lpips_proxy(clip)), rtol=0, atol=5e-6)
    assert float(tmetrics.ssim(a, a).min()) > 0.9999


def test_cass_scores_match_jax():
    """clip_cosine, CASS, relCASS and concept_alignment_scores on random
    [6, 16] frame embeddings and [16] prompt embeddings (observed <= 4.1e-8
    absolute on the cosines, <= 3.3e-7 relative on the scores; bounds 4e-7,
    3e-6); an identity edit scores 0."""
    src, out = _rand((6, 16), 3), _rand((6, 16), 4)
    t_src, t_tgt = _rand((16,), 5), _rand((16,), 6)
    np.testing.assert_allclose(tmetrics.clip_cosine(src, t_src).numpy(),
                               np.asarray(jmetrics.clip_cosine(src, t_src)), rtol=0, atol=4e-7)
    port = tmetrics.concept_alignment_scores(src, out, t_src, t_tgt)
    ref = jmetrics.concept_alignment_scores(*(jnp.asarray(x) for x in (src, out, t_src, t_tgt)))
    assert set(port) == set(ref) == {"sim_src_src", "sim_src_tgt", "sim_out_src",
                                     "sim_out_tgt", "cass", "rel_cass"}
    for k in ref:
        np.testing.assert_allclose(float(port[k]), float(ref[k]), rtol=3e-6, atol=0, err_msg=k)
    sims = [port[k] for k in ("sim_src_src", "sim_src_tgt", "sim_out_src", "sim_out_tgt")]
    np.testing.assert_allclose(float(tmetrics.cass(*sims)),
                               float(jmetrics.cass(*(float(s) for s in sims))), rtol=3e-6)
    np.testing.assert_allclose(float(tmetrics.rel_cass(*sims)),
                               float(jmetrics.rel_cass(*(float(s) for s in sims))), rtol=3e-6)
    same = tmetrics.concept_alignment_scores(src, src, t_src, t_tgt)
    assert abs(float(same["cass"])) < 1e-5


# ---------------------------------------------------------------------------
# The CLIP text tower's pooled embedding
# ---------------------------------------------------------------------------

TEXT = dict(width=16, heads=2, layers=3, vocab_size=100, context_length=8)


def test_clip_text_embed_matches_jax():
    """output='embed' (whole tower, ln_final, the EOT pool, text_projection)
    and, on the same full tower, the penultimate features, from the JAX
    init carried across (clip_from_jax(full=True)); EOT is the largest id,
    wherever it sits (observed <= 1e-6; bound 1e-5)."""
    tokens = np.array([[1, 5, 7, 99, 0, 0, 0, 0], [3, 99, 2, 2, 2, 2, 2, 2]])
    jenc = JCLIPTextEncoder(JCLIPConfig(**TEXT))
    params = jax.tree.map(np.asarray, jenc.init(jax.random.PRNGKey(0), jnp.asarray(tokens),
                                                output="embed"))
    cfg = CLIPTextConfig(**TEXT)
    tower = CLIPTextEncoder(cfg, full=True).eval()
    tower.load_state_dict(clip_from_jax(params, cfg, full=True))
    with torch.no_grad():
        for output in ("embed", "penultimate"):
            ref = np.asarray(jenc.apply(params, jnp.asarray(tokens), output=output))
            out = tower(torch.from_numpy(tokens), output=output).numpy()
            assert out.shape == ((2, 16) if output == "embed" else (2, 8, 16))
            np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5, err_msg=output)
    with pytest.raises(ValueError, match="full=True"):
        CLIPTextEncoder(cfg)(torch.from_numpy(tokens), output="embed")


def test_load_text_tower_matches_jax_convert(tmp_path):
    """load_text_tower reads the whole text tower and text_projection under
    cond_stage_model.model. (skipping the rest of the checkpoint, the visual
    tower too) into the tree that convert_clip(full=True) reads from the
    same file; a missing text_projection fails."""
    cfg = CLIPTextConfig(**CLIP)
    tower = CLIPTextEncoder(cfg, full=True)
    with torch.no_grad():
        for i, p in enumerate(tower.parameters()):
            p.copy_(torch.from_numpy(_rand(tuple(p.shape), 100 + i)))
    sd = {"cond_stage_model.model." + k: v.detach().clone() for k, v in tower.state_dict().items()}
    sd.update({"model.diffusion_model.x.weight": torch.ones(2),
               "cond_stage_model.model.logit_scale": torch.tensor(4.6),
               "cond_stage_model.model.visual.proj": torch.ones(4, 4)})
    torch.save({"state_dict": sd}, tmp_path / "m.ckpt")
    loaded = load_text_tower(str(tmp_path / "m.ckpt"), cfg, device="cpu")
    ref = jconvert.convert_clip({k: v.numpy() for k, v in sd.items()}, JCLIPConfig(**CLIP),
                                full=True)
    back = jconvert.convert_clip({"cond_stage_model.model." + k: v.numpy()
                                  for k, v in loaded.state_dict().items()},
                                 JCLIPConfig(**CLIP), full=True)
    jax.tree.map(np.testing.assert_array_equal, back, ref)
    del sd["cond_stage_model.model.text_projection"]
    torch.save(sd, tmp_path / "bad.ckpt")
    with pytest.raises(RuntimeError, match="text_projection"):
        load_text_tower(str(tmp_path / "bad.ckpt"), cfg, device="cpu")


# ---------------------------------------------------------------------------
# LPIPS
# ---------------------------------------------------------------------------

def _lpips_state_dicts(seed=7):
    """torchvision-layout AlexNet features and LPIPS lin weights (torch
    tensors), weights N(0, 1/fan_in) so the activations stay O(1)."""
    rng = np.random.default_rng(seed)
    specs = {0: (64, 3, 11), 3: (192, 64, 5), 6: (384, 192, 3), 8: (256, 384, 3),
             10: (256, 256, 3)}
    alex = {}
    for i, (o, c, k) in specs.items():
        alex[f"features.{i}.weight"] = torch.from_numpy(
            (rng.standard_normal((o, c, k, k)) / np.sqrt(c * k * k)).astype(np.float32))
        alex[f"features.{i}.bias"] = torch.from_numpy(
            (0.1 * rng.standard_normal(o)).astype(np.float32))
    lins = {f"lin{i}.model.1.weight": torch.from_numpy(
        np.abs(rng.standard_normal((1, ch, 1, 1))).astype(np.float32))
        for i, ch in enumerate([64, 192, 384, 256, 256])}
    return alex, lins


def test_lpips_matches_jax():
    """The five AlexNet taps and LPIPS / LPIPS-I / LPIPS-T of [3, 64, 80, 3]
    clips through convert_lpips_weights on the same state dicts (observed
    1.9e-6 of each tap's largest value and 1.2e-7 absolute on the O(0.1-1)
    distances; bounds 1e-5 of the largest value, 1e-6); identical clips
    score 0."""
    alex, lins = _lpips_state_dicts()
    net, t_lins = tmetrics.convert_lpips_weights(alex, lins)
    j_params, j_lins = jmetrics.convert_lpips_weights({k: v.numpy() for k, v in alex.items()},
                                                      {k: v.numpy() for k, v in lins.items()})
    a, b = (2 * x - 1 for x in _pair((3, 64, 80, 3), 8))
    with torch.no_grad():
        taps = net(torch.from_numpy(a))
    ref_taps = jmetrics.AlexNetFeatures().apply(j_params, jnp.asarray(a))
    for t, r in zip(taps, ref_taps):
        r = np.asarray(r)
        assert t.shape == r.shape
        np.testing.assert_allclose(t.numpy(), r, rtol=0, atol=1e-5 * np.abs(r).max())
    with torch.no_grad():
        pairs = [(tmetrics.lpips(a, b, net, t_lins), jmetrics.lpips(a, b, j_params, j_lins)),
                 (tmetrics.lpips_i(a, b, net, t_lins), jmetrics.lpips_i(a, b, j_params, j_lins)),
                 (tmetrics.lpips_t(a, net, t_lins), jmetrics.lpips_t(a, j_params, j_lins))]
        for p, r in pairs:
            np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=0, atol=1e-6)
        assert float(tmetrics.lpips_i(a, a, net, t_lins)) < 1e-6


# ---------------------------------------------------------------------------
# I3D and FVD
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def i3d_params():
    """(port params, JAX params) of the channel-shrunk pytorch-i3d state
    dict of tests/test_oracle_i3d.py (the real graph and kernel sizes,
    every unit 8 channels wide, BatchNorm with random statistics)."""
    sd = _tiny_synthetic_state_dict(seed=11, width=8, classes=16)
    return (ti3d.convert_i3d_weights({k: torch.from_numpy(v) for k, v in sd.items()}),
            ji3d.convert_i3d_weights(sd))


@pytest.mark.parametrize("hw", [(320, 512), (100, 120)])
def test_i3d_preprocess_matches_jax(hw):
    """Bilinear to 224 x 224 with half-pixel centres and no antialias, down
    and up (observed <= 3.6e-7; bound 3e-6)."""
    v = _rand((1, 2) + hw + (3,), 12, 0.0, 1.0)
    np.testing.assert_allclose(ti3d.i3d_preprocess(v).numpy(),
                               np.asarray(ji3d.i3d_preprocess(jnp.asarray(v))), rtol=0,
                               atol=3e-6)


def test_i3d_features_and_logits_match_jax(i3d_params):
    """The backbone's Mixed_5c maps and the 16 logits at the smallest legal
    input, 9 frames of 193 x 193 (SAME padding, asymmetric at stride 2;
    -inf padded pools; the (2, 7, 7) head and the time mean): observed
    2.5e-6 (features) and 2.7e-7 (logits) of the largest value; bounds
    2e-5 and 2.5e-6 of it."""
    tp, jp = i3d_params
    x = _rand((2, 9, 193, 193, 3), 13, -1.0, 1.0)
    with torch.no_grad():
        feats, logits = ti3d.i3d_features(tp, x).numpy(), ti3d.i3d_logits(tp, x).numpy()
    ref_feats = np.asarray(ji3d.i3d_features(jp, jnp.asarray(x)))
    ref_logits = np.asarray(ji3d.i3d_logits(jp, jnp.asarray(x)))
    assert feats.shape == ref_feats.shape == (2, 2, 7, 7, 32) and logits.shape == (2, 16)
    np.testing.assert_allclose(feats, ref_feats, rtol=0, atol=2e-5 * np.abs(ref_feats).max())
    np.testing.assert_allclose(logits, ref_logits, rtol=0, atol=2.5e-6 * np.abs(ref_logits).max())


@pytest.mark.parametrize("shape,match", [((1, 8, 193, 193, 3), "≥9 input frames"),
                                         ((1, 9, 192, 200, 3), "≥7×7")])
def test_i3d_logits_refusals_match_jax(i3d_params, shape, match):
    tp, jp = i3d_params
    x = np.zeros(shape, np.float32)
    with pytest.raises(ValueError, match=match):
        ti3d.i3d_logits(tp, x)
    with pytest.raises(ValueError, match=match):
        ji3d.i3d_logits(jp, jnp.asarray(x))


def test_frechet_distance_and_fvd_match_jax(i3d_params):
    """The numpy float64 Fréchet fit (the same function: equal to 1e-12
    relative), StreamingFVD against the batch fvd on the same pairs (equal
    within 1e-9 relative), and fvd through the I3D feature_fn on the CPU
    against the JAX package's (observed 2.4e-7 relative; bound 2e-6)."""
    rng = np.random.default_rng(14)
    fa, fb = rng.standard_normal((40, 6)), rng.standard_normal((40, 6)) * 1.5 + 0.3
    np.testing.assert_allclose(tfvd.fvd_from_features(fa, fb), jfvd.fvd_from_features(fa, fb),
                               rtol=1e-12)
    mu, sig = tfvd.gaussian_stats(fa)
    np.testing.assert_allclose(tfvd.frechet_distance(mu, sig, mu, sig), 0.0, atol=1e-9)

    def feature_fn(batch):  # [B, T, H, W, C] -> [B, 8]
        flat = np.asarray(batch).reshape(len(batch), -1)
        return np.stack([flat[:, i::8].mean(axis=1) for i in range(8)], 1)

    vids_a, vids_b = rng.uniform(size=(5, 10, 4, 4, 3)), rng.uniform(size=(5, 12, 4, 4, 3))
    stream = tfvd.StreamingFVD(feature_fn, warmup_pairs=2)
    for a, b in zip(vids_a, vids_b):
        assert stream.add(a, b)
    assert not stream.add(vids_a[0][:8], vids_b[0][:8]) and stream.skipped == 1
    np.testing.assert_allclose(stream.result(), tfvd.fvd(vids_a, vids_b[:, :10], feature_fn,
                                                         batch_size=2), rtol=1e-9)
    tp, jp = i3d_params
    va, vb = rng.uniform(size=(3, 9, 40, 48, 3)), rng.uniform(size=(3, 9, 40, 48, 3)) ** 2
    port = tfvd.fvd(va, vb, ti3d.i3d_feature_fn(tp, device="cpu"), batch_size=2)
    ref = jfvd.fvd(va, vb, ji3d.i3d_feature_fn(jp), batch_size=2)
    np.testing.assert_allclose(port, ref, rtol=2e-6)
    assert abs(tfvd.fvd(va, va, ti3d.i3d_feature_fn(tp, device="cpu"))) < 1e-6 * abs(port)


def test_vbench_round_trip_matches_jax(tmp_path):
    entries = [{"prompt": "a cat", "video_path": "/x/v.mp4"},
               {"prompt": "a dog", "video_path": "/x/w.mp4"}]
    paths = [mod.write_full_info(str(tmp_path / name), entries, timestamp="2026-01-01-00:00:00")
             for name, mod in (("port", tvbench), ("jax", jvbench))]
    assert [os.path.basename(p) for p in paths] == \
        ["results_2026-01-01-00:00:00_full_info.json"] * 2
    assert json.load(open(paths[0])) == json.load(open(paths[1]))
    for name in ("port", "jax"):
        with open(tmp_path / name / "a_eval_results.json", "w") as f:
            json.dump({"Diversity": [0.8, {}], "Human_Anatomy": [0.9, {}]}, f)
        with open(tmp_path / name / "b_eval_results.json", "w") as f:
            json.dump({"Diversity": 0.6}, f)
    assert tvbench.summarize(str(tmp_path / "port")) == jvbench.summarize(str(tmp_path / "jax"))


# ---------------------------------------------------------------------------
# The sweep
# ---------------------------------------------------------------------------

class SmallCall:
    """A MoCA pipeline that the sweep calls at H x W, with the concept image
    cut to the latent size: both sweeps call at the pipeline's default
    512 x 320 with a 40 x 64 concept image. Attribute reads and writes go to
    the pipeline."""

    def __init__(self, pipe):
        object.__setattr__(self, "pipe", pipe)

    def __getattr__(self, name):
        return getattr(self.pipe, name)

    def __setattr__(self, name, value):
        setattr(self.pipe, name, value)

    def __call__(self, prompt, *args, cond_image, **kw):
        return self.pipe(prompt, *args, cond_image=cond_image[:H // 8, :W // 8], height=H,
                         width=W, **kw)


def _load_jax_sweep():
    spec = importlib.util.spec_from_file_location("jax_eval_sweep",
                                                  ROOT / "scripts" / "eval_sweep.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sweep_inputs(tmp_path, models):  # noqa: F811
    """A 2-row prompt CSV with concept images, the text tower's checkpoint
    (the tiny model's, with the last block and text_projection), the
    OpenCLIP visual state dict (prefix ''), the LPIPS pair and the I3D state
    dict, all from seeds."""
    tmodel = models[1]
    rows = ["prompt,conditioned_object,conditioned_image_path,conditioned_prompt,gamma"]
    for i, (prompt, concept) in enumerate((("a red fox", "cat"), ("a blue bird", "dog"))):
        path = tmp_path / f"{concept}.png"
        Image.fromarray(np.random.default_rng(50 + i).integers(0, 255, (16, 16, 4), np.uint8),
                        "RGBA").save(path)
        rows.append(f"{prompt},{concept},{path},a {concept},0.{4 + i}")
    (tmp_path / "prompts.csv").write_text("\n".join(rows) + "\n")
    sd = {"cond_stage_model.model." + k: v.clone() for k, v in tmodel.clip.state_dict().items()}
    last = f"transformer.resblocks.{CLIP['layers'] - 1}."
    for k, v in tmodel.clip.state_dict().items():  # the block conditioning skips
        if k.startswith("transformer.resblocks.0."):
            sd["cond_stage_model.model." + k.replace("transformer.resblocks.0.", last)] = \
                (v * 0.9 + 0.01).clone()
    sd["cond_stage_model.model.text_projection"] = torch.from_numpy(_rand((16, 16), 51))
    torch.save({"state_dict": sd}, tmp_path / "text.ckpt")
    vision = tvision.CLIPVisionEncoder(tvision.CLIPVisionConfig(**VISION))
    with torch.no_grad():
        for i, (name, p) in enumerate(vision.named_parameters()):
            p.copy_(torch.from_numpy(_rand(tuple(p.shape), 60 + i) * 0.3))
            if "ln_" in name and name.endswith(".weight"):
                p.add_(1.0)
    torch.save(vision.state_dict(), tmp_path / "visual.pt")
    alex, lins = _lpips_state_dicts(9)
    torch.save({"alexnet": alex, "lpips": lins}, tmp_path / "lpips.pt")
    i3d = _tiny_synthetic_state_dict(seed=12, width=8, classes=16)
    torch.save({k: torch.from_numpy(v) for k, v in i3d.items()}, tmp_path / "i3d.pt")
    return ["--ckpt_path", str(tmp_path / "text.ckpt"), "--prompt_file",
            str(tmp_path / "prompts.csv"), "--new_video_length", "4", "--seed", "5",
            "--precision", "fp32", "--clip_vision_ckpt", str(tmp_path / "visual.pt"),
            "--lpips_ckpt", str(tmp_path / "lpips.pt"), "--i3d_ckpt", str(tmp_path / "i3d.pt")]


SWEEP_ATOL = {"cass": 5e-4, "rel_cass": 2.5e-4, "frame_psnr_adjacent": 5e-5}  # else 3e-5


def test_eval_sweep_matches_jax_sweep(models, tmp_path, monkeypatch):  # noqa: F811
    """Both sweeps on the same 2-row CSV and tower checkpoints with the
    same tiny MoCA pipeline injected (ViT at 28 px for ViT-H/14; the port's
    noise replayed from the JAX sweep's keys): the same files (2 mp4s, the
    base-latent caches, metrics_rank0.json, one full_info), the same metric
    keys, and the same values (absolute errors observed: <= 6.1e-5 on CASS,
    its x100 scale, 2.6e-5 on relCASS, 5.7e-6 dB on PSNR, <= 3.2e-6 on the
    rest; bounds SWEEP_ATOL). The 4-frame source clips are below I3D's 9,
    so both sweeps skip FVD's pairs."""
    jmodel, tmodel = models
    argv = _sweep_inputs(tmp_path, models)
    kw = dict(video_length=F, num_partitions=N, new_video_length=2, guidance_scale=7.5)
    jpipe = JPipeline(jmodel, JHashTokenizer(), **kw)
    tpipe = MoCAVideoPipeline(tmodel, HashTokenizer(), **kw)
    # the JAX sweep's ViT-H/14 tower and its 32-layer converter, shrunk to the test's tower
    tiny_vision = jvision.CLIPVisionConfig(**VISION)
    monkeypatch.setattr(jvision, "CLIPVisionConfig", lambda: tiny_vision)
    monkeypatch.setattr(jconvert, "convert_clip_vision", functools.partial(
        jconvert.convert_clip_vision, layers=VISION["layers"]))
    monkeypatch.setattr(eval_sweep, "CLIPVisionConfig",
                        lambda: tvision.CLIPVisionConfig(**VISION))
    monkeypatch.setattr(jcli, "load_pipeline", lambda a: SmallCall(jpipe))
    steps, total = F * N, 4 + F * N - F

    def replay(seed, idx, sample_index, n_samples, device):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), idx)
        return JaxReplayNormal(pipeline_keys(key, steps, total, jpipe.plan.num_windows, F))

    monkeypatch.setattr(eval_sweep, "sample_normal", replay)
    outs = {}
    for name in ("jax", "port"):
        out = tmp_path / name
        if name == "jax":
            monkeypatch.setattr(sys, "argv", ["eval_sweep.py"] + argv + ["--out_dir", str(out)])
            _load_jax_sweep().main()
        else:
            summary = eval_sweep.main(eval_sweep.build_parser().parse_args(
                argv + ["--out_dir", str(out)]), pipe=SmallCall(tpipe))
            assert summary == {"videos": 2, "cass_convention": eval_sweep.CASS_CONVENTION}
        files = sorted(str(p.relative_to(out)) for p in out.rglob("*") if p.is_file())
        with open(out / "metrics_rank0.json") as f:
            outs[name] = (files, json.load(f))
    (jfiles, ref), (tfiles, port) = outs["jax"], outs["port"]
    no_info = lambda files: [f for f in files if "full_info" not in f]
    assert no_info(tfiles) == no_info(jfiles)
    assert "000.mp4" in tfiles and f"latents_1/{steps}.npz" in tfiles
    assert sum("full_info" in f for f in tfiles) == sum("full_info" in f for f in jfiles) == 1
    assert set(port) == set(ref) == {"0", "1", "_cass_convention", "_fvd_edited_vs_source",
                                     "_fvd_videos_skipped"}
    assert port["_fvd_edited_vs_source"] is ref["_fvd_edited_vs_source"] is None
    assert port["_fvd_videos_skipped"] == ref["_fvd_videos_skipped"] == 2
    assert port["_cass_convention"] == ref["_cass_convention"]
    for idx in ("0", "1"):
        assert set(port[idx]) == set(ref[idx]) == {
            "prompt", "temporal_consistency", "frame_ssim_adjacent", "frame_psnr_adjacent",
            "sim_src_src", "sim_src_tgt", "sim_out_src", "sim_out_tgt", "cass", "rel_cass",
            "lpips_i", "lpips_t"}
        for k, v in ref[idx].items():
            if k == "prompt":
                assert port[idx][k] == v
            else:
                np.testing.assert_allclose(port[idx][k], v, rtol=0,
                                           atol=SWEEP_ATOL.get(k, 3e-5), err_msg=k)
