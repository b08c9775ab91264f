"""The port's config reader, checkpoint loader and CLI against the JAX package's.

`config.py` on the shipped YAML field by field and on the refused targets;
a tiny upstream-layout `model.ckpt` (the port's modules carry the upstream
key names) in the plain, DeepSpeed and EMA layouts, loaded by the JAX
package's `convert_checkpoint` and by the port's loader, with the U-Net,
encoder, decoder and text tower compared; and `cli.main` in prompt and
DAVIS mode beside `moca_tpu.cli.main`, both with a tiny injected pipeline on
the CPU: the same files, frame counts and tail slices. The loader and the
CLI also run unmocked on that checkpoint and a shrunk YAML.
"""

import copy
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image
from test_torch_davis import models, seed_weights  # noqa: F401  (fixture)
from test_torch_sampling import one_torch_thread  # noqa: F401  (fixture)
from test_torch_slice import F, H, N, W

import moca_tpu.cli.main as jcli
from moca_tpu import config as jconfig
from moca_tpu.models.convert import convert_checkpoint
from moca_tpu.models.latent_diffusion import LatentDiffusion as JLatentDiffusion
from moca_tpu.models.tokenizer import HashTokenizer as JHashTokenizer
from moca_tpu.pipelines.moca_video import MoCAVideoPipeline as JPipeline
import moca_tpu_torch.cli.main as tcli
from moca_tpu_torch import config as tconfig
from moca_tpu_torch.io.checkpoint import load_checkpoint
from moca_tpu_torch.models.latent_diffusion import LatentDiffusion
from moca_tpu_torch.models.tokenizer import HashTokenizer
from moca_tpu_torch.pipelines.moca_video import MoCAVideoPipeline

ROOT = Path(__file__).resolve().parent.parent
SHIPPED = str(ROOT / "configs/inference_t2v_512_v2.0.yaml")
# a shrunk YAML of the reference's schema; the text tower's size keys are
# the JAX package's extension for such configs
TINY_YAML = f"""
model:
  target: lvdm.models.ddpm3d.LatentDiffusion
  params:
    scale_factor: 0.18215
    use_scale: true
    scale_b: 0.7
    uncond_type: empty_seq
    conditioning_key: crossattn
    unet_config:
      target: lvdm.modules.networks.openaimodel3d.UNetModel
      params:
        model_channels: 32
        num_res_blocks: 1
        attention_resolutions: [1, 2]
        channel_mult: [1, 2]
        num_head_channels: 8
        context_dim: 16
        temporal_length: {F}
        addition_attention: true
        fps_cond: true
    first_stage_config:
      target: lvdm.models.autoencoder.AutoencoderKL
      params:
        embed_dim: 4
        ddconfig:
          resolution: {H}
          ch: 16
          ch_mult: [1, 1, 2, 2]
          num_res_blocks: 1
          attn_resolutions: []
    cond_stage_config:
      target: lvdm.modules.encoders.condition.FrozenOpenCLIPEmbedder
      params:
        layer: penultimate
        width: 16
        heads: 2
        layers: 2
"""


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _assert_config_matches(port, ref):
    for part in ("diffusion", "unet", "vae", "clip"):
        p, r = _fields(getattr(port, part)), _fields(getattr(ref, part))
        for name, value in p.items():
            if name == "dropout":  # the port's UNetConfig field with no JAX counterpart
                continue
            assert value == r[name], (part, name)
    assert port.is_i2v == ref.is_i2v and port.finegrained == ref.finegrained


@pytest.mark.parametrize("which", ["shipped", "tiny"])
def test_config_matches_jax(which, tmp_path):
    """Every field of the port's configs equals the JAX package's read of
    the same file (the JAX configs' dtype fields aside: the port's parameter
    type is the caller's)."""
    path = SHIPPED
    if which == "tiny":
        path = tmp_path / "tiny.yaml"
        path.write_text(TINY_YAML)
    port, ref = tconfig.load_model_config(str(path)), jconfig.load_model_config(str(path))
    _assert_config_matches(port, ref)
    if which == "shipped":
        assert port.unet.model_channels == 320 and port.clip.penultimate
        assert port.diffusion.use_scale and port.diffusion.scale_b == 0.7


@pytest.mark.parametrize("case", ["FrozenT5Embedder", "FrozenCLIPEmbedder", "ClipImageEmbedder",
                                  "FrozenCLIPT5Encoder", "unknown", "i2v_vestigial",
                                  "i2v", "bad_conditioning_key"])
def test_config_rejections_match_jax(case):
    """The refused targets and keys raise the same error type in both
    packages; the i2v target reads as i2v in both."""
    with open(SHIPPED) as f:
        raw = yaml.safe_load(f)
    mp = raw["model"]["params"]
    if case == "unknown":
        mp["cond_stage_config"]["target"] = "lvdm.modules.encoders.condition.Mystery"
    elif case == "i2v_vestigial":
        mp["cond_img_config"] = {"target": "lvdm.modules.encoders.condition.ClipImageEmbedder"}
    elif case == "i2v":
        raw["model"]["target"] = "lvdm.models.ddpm3d.LatentVisualDiffusion"
        mp["cond_img_config"] = {
            "target": "lvdm.modules.encoders.condition.FrozenOpenCLIPImageEmbedderV2"}
    elif case == "bad_conditioning_key":
        mp["conditioning_key"] = "telepathy"
    else:
        mp["cond_stage_config"]["target"] = f"lvdm.modules.encoders.condition.{case}"
    results = []
    for mod in (tconfig, jconfig):
        try:
            results.append(mod.model_config_from_dict(copy.deepcopy(raw)))
        except (NotImplementedError, ValueError) as exc:
            results.append(type(exc))
    if case == "i2v":
        assert results[0].is_i2v and results[1].is_i2v
    else:
        assert results[0] == results[1] and isinstance(results[0], type), results


# ---------------------------------------------------------------------------
# The checkpoint loader
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    """(YAML path, port model, upstream state dict): a port model built from
    the shrunk YAML with weights from a seed, its towers' tensors under the
    upstream prefixes, plus keys the loaders skip: schedule buffers,
    LitEma's counters, OpenCLIP's visual tower, projection and scale, and the
    text tower's last block (conditioning stops one block early)."""
    root = tmp_path_factory.mktemp("ckpt")
    path = root / "tiny.yaml"
    path.write_text(TINY_YAML)
    cfg = tconfig.load_model_config(str(path))
    model = seed_weights(LatentDiffusion(cfg.unet, cfg.vae, cfg.clip), 70)
    sd = {}
    for tower, prefix in (("unet", "model.diffusion_model."), ("vae", "first_stage_model."),
                          ("clip", "cond_stage_model.model.")):
        sd.update({prefix + k: v.clone() for k, v in getattr(model, tower).state_dict().items()})
    last = "cond_stage_model.model.transformer.resblocks.1."
    sd.update({k.replace("resblocks.0.", "resblocks.1."): v.clone()
               for k, v in sd.items() if k.startswith(last.replace(".1.", ".0."))})
    sd.update({"betas": torch.linspace(1e-4, 2e-2, 1000), "alphas_cumprod": torch.ones(1000),
               "model_ema.decay": torch.tensor(0.9999), "model_ema.num_updates": torch.tensor(7),
               "cond_stage_model.model.text_projection": torch.ones(16, 16),
               "cond_stage_model.model.logit_scale": torch.tensor(4.6),
               "cond_stage_model.model.visual.conv1.weight": torch.ones(8, 3, 2, 2)})
    return str(path), model, sd


def _write(sd, layout, path):
    if layout == "plain":
        torch.save({"state_dict": sd}, path)
    elif layout == "deepspeed":  # a 16-character prefix on every key
        torch.save({"module": {"_forward_module." + k: v for k, v in sd.items()}}, path)
    else:  # LitEma: the live U-Net zeroed, its shadows (dots stripped) hold the weights
        out = dict(sd)
        for k, v in sd.items():
            if k.startswith("model."):
                out["model_ema." + k[len("model."):].replace(".", "")] = v
                out[k] = torch.zeros_like(v)
        torch.save({"state_dict": out}, path)


@functools.lru_cache(maxsize=None)
def _jax_towers(cfg_path):
    """Jitted forwards of the JAX package's towers, weights as arguments."""
    cfg = jconfig.load_model_config(cfg_path)
    m = JLatentDiffusion(cfg.unet, cfg.vae, cfg.clip, None, None, None)
    return dict(
        unet=jax.jit(lambda p, x, t, c: m._unet.apply(p, x, t, c, fps=10)),
        encode=jax.jit(lambda p, x: m._vae.apply(p, x, method=m._vae.encode_moments)),
        decode=jax.jit(lambda p, z: m._vae.apply(p, z, method=m._vae.decode)),
        text=jax.jit(lambda p, tok: m._clip.apply(p, tok)))


@pytest.mark.parametrize("layout", ["plain", "deepspeed", "ema"])
def test_checkpoint_loader_matches_jax(tiny_ckpt, layout, tmp_path):
    """Both packages load the same file; the port's towers then equal the
    source weights exactly and match the JAX towers' outputs. Observed
    2.1e-6 relative to each output's max; bound 1e-5 of it."""
    cfg_path, source, sd = tiny_ckpt
    ckpt = tmp_path / "model.ckpt"
    _write(sd, layout, ckpt)
    use_ema = layout == "ema"
    jcfg = jconfig.load_model_config(cfg_path)
    jparams = convert_checkpoint(str(ckpt), jcfg.unet, jcfg.vae, jcfg.clip, use_ema=use_ema)
    cfg = tconfig.load_model_config(cfg_path)
    model = LatentDiffusion(cfg.unet, cfg.vae, cfg.clip).eval()
    skipped = load_checkpoint(str(ckpt), model, use_ema=use_ema)
    assert "betas" in skipped and "cond_stage_model.model.visual.conv1.weight" in skipped
    for tower in ("unet", "vae", "clip"):
        for k, v in getattr(source, tower).state_dict().items():
            assert torch.equal(getattr(model, tower).state_dict()[k], v), (tower, k)

    rng = np.random.default_rng(71)
    x = rng.standard_normal((2, F, H // 8, W // 8, 4)).astype(np.float32)
    t = rng.integers(0, 1000, (2, F))
    ctx = rng.standard_normal((2, 77, 16)).astype(np.float32)
    frames = rng.uniform(-1, 1, (2, H, W, 3)).astype(np.float32)
    tokens = HashTokenizer()(["a cat surfing", "a dog"])
    jt = _jax_towers(cfg_path)
    unet_p, vae_p, clip_p = jparams
    pairs = []
    with torch.no_grad():
        pairs.append((model.unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                                 fps=10), jt["unet"](unet_p, x, t, ctx)))
        pairs += list(zip(model.vae.encode_moments(torch.from_numpy(frames)),
                          jt["encode"](vae_p, frames)))
        pairs.append((model.vae.decode(torch.from_numpy(x[0])), jt["decode"](vae_p, x[0])))
        pairs.append((model.clip(torch.from_numpy(tokens).long()),
                      jt["text"](clip_p, jnp.asarray(tokens))))
    for port, ref in pairs:
        ref = np.asarray(ref)
        np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_checkpoint_loader_refuses_stray_and_missing_keys(tiny_ckpt, tmp_path):
    cfg_path, _, sd = tiny_ckpt
    cfg = tconfig.load_model_config(cfg_path)
    model = LatentDiffusion(cfg.unet, cfg.vae, cfg.clip)
    _write({**sd, "cond_stage_model.transformer.extra": torch.ones(1)}, "plain",
           tmp_path / "stray.ckpt")
    with pytest.raises(ValueError, match="outside the model"):
        load_checkpoint(str(tmp_path / "stray.ckpt"), model)
    _write({**sd, "model.diffusion_model.out.9.weight": torch.ones(1)}, "plain",
           tmp_path / "extra.ckpt")
    with pytest.raises(RuntimeError, match="Unexpected"):
        load_checkpoint(str(tmp_path / "extra.ckpt"), model)
    missing = {k: v for k, v in sd.items() if not k.startswith("first_stage_model.encoder.")}
    _write(missing, "plain", tmp_path / "missing.ckpt")
    with pytest.raises(RuntimeError, match="Missing"):
        load_checkpoint(str(tmp_path / "missing.ckpt"), model)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def _files(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*") if p.is_file())


def _frame_count(path):
    if str(path).endswith(".gif"):
        with Image.open(path) as img:
            return img.n_frames
    import cv2

    cap = cv2.VideoCapture(str(path))
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    return n


def _run_both(models, argv, tmp_path, monkeypatch, new_len):  # noqa: F811
    """Run each package's cli.main in a directory of its own with a tiny
    pipeline injected; returns the two directories."""
    jmodel, tmodel = models
    kw = dict(video_length=F, num_partitions=N, new_video_length=new_len, guidance_scale=7.5)
    dirs = []
    for name, cli, pipe in (("jax", jcli, JPipeline(jmodel, JHashTokenizer(), **kw)),
                            ("port", tcli, MoCAVideoPipeline(tmodel, HashTokenizer(), **kw))):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        monkeypatch.setattr(cli, "load_pipeline", lambda args, _p=pipe: _p)
        cli.main(cli.build_parser().parse_args(argv))
        dirs.append(d)
    return dirs


def _common_args(new_len):
    return ["--height", str(H), "--width", str(W), "--video_length", str(F), "-n", str(N),
            "-l", str(new_len)]


def test_cli_prompt_mode_matches_jax(models, tmp_path, monkeypatch):  # noqa: F811
    """Prompt mode, odd -l 3 (the tail slice keeps ceil(3/2) = 2 frames),
    per-frame PNGs and the visualizations: the same tree of files (video,
    fifo/*.png, visualizations/*, the base-latent cache) from both CLIs."""
    cond = tmp_path / "cat.png"
    Image.fromarray(np.full((16, 16, 4), 128, np.uint8), "RGBA").save(cond)
    csv = tmp_path / "prompts.csv"
    csv.write_text("prompt,conditioned_object,conditioned_image_path,conditioned_prompt,gamma\n"
                   f"a red fox,cat,{cond},a cat,0.4\n")
    argv = _common_args(3) + ["--prompt_file", str(csv), "--output_dir", "out",
                              "--save_visualizations"]
    jdir, tdir = _run_both(models, argv, tmp_path, monkeypatch, 3)
    files = _files(tdir)
    assert files == _files(jdir)
    assert "out/cat/a red fox.mp4" in files and "out/cat/fifo/0.png" in files
    assert f"results/moca_tpu/latents/{F * N}steps/a red fox/eta1.0/{F * N}.npz" in files
    assert any(f.startswith("out/cat/visualizations/pred_x0/") for f in files)
    assert _frame_count(tdir / "out/cat/a red fox.mp4") == 2
    assert _frame_count(jdir / "out/cat/a red fox.mp4") == 2


def test_cli_davis_mode_matches_jax(models, tmp_path, monkeypatch):  # noqa: F811
    """DAVIS mode on a 6-frame clip (all of it: 72 asked, uniform stride 1),
    gif output, -l 4: the head slice keeps 4 // 2 = 2 frames."""
    frames_dir = tmp_path / "DAVIS" / "JPEGImages" / "480p" / "bear"
    masks_dir = tmp_path / "DAVIS" / "Annotations" / "480p" / "bear"
    frames_dir.mkdir(parents=True)
    masks_dir.mkdir(parents=True)
    rng = np.random.default_rng(72)
    for i in range(6):
        Image.fromarray(rng.integers(0, 255, (H, W, 3), np.uint8), "RGB").save(
            frames_dir / f"{i:05d}.jpg")
        m = np.zeros((H, W), np.uint8)
        m[8:24, 8 + i: 24 + i] = 255
        Image.fromarray(m, "L").save(masks_dir / f"{i:05d}.png")
    cond = tmp_path / "concept.png"
    Image.fromarray(np.full((16, 16, 4), 90, np.uint8), "RGBA").save(cond)
    argv = _common_args(4) + ["--use_davis", "--video_name", "bear",
                              "--davis_root", str(tmp_path / "DAVIS"),
                              "--conditioned_image_path", str(cond), "--output_dir", "out",
                              "--no_use_mp4"]
    jdir, tdir = _run_both(models, argv, tmp_path, monkeypatch, 4)
    assert _files(tdir) == _files(jdir) == ["out/concept/bear.gif"]
    assert _frame_count(tdir / "out/concept/bear.gif") == 2
    assert _frame_count(jdir / "out/concept/bear.gif") == 2


def test_cli_unmocked_checkpoint_to_video(tiny_ckpt, tmp_path, monkeypatch):
    """load_pipeline on the shrunk YAML and the tiny checkpoint (a tiny BPE
    vocab, fp32 and bf16) on the CPU, then main to a video file."""
    import gzip

    cfg_path, source, sd = tiny_ckpt
    monkeypatch.chdir(tmp_path)
    _write(sd, "plain", tmp_path / "model.ckpt")
    bpe = tmp_path / "vocab.txt.gz"
    with gzip.open(bpe, "wt", encoding="utf-8") as f:
        f.write("version\nc a\nca t</w>\nd o\ndo g</w>\n")
    cond = tmp_path / "cat.png"
    Image.fromarray(np.full((16, 16, 4), 128, np.uint8), "RGBA").save(cond)
    csv = tmp_path / "prompts.csv"
    csv.write_text("prompt,conditioned_object,conditioned_image_path,conditioned_prompt,gamma\n"
                   f"a cat dog,cat,{cond},cat,0.4\n")
    argv = _common_args(2) + ["--ckpt_path", str(tmp_path / "model.ckpt"), "--config", cfg_path,
                              "--bpe_path", str(bpe), "--prompt_file", str(csv),
                              "--output_dir", "out", "--no_save_frames"]
    for precision, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        args = tcli.build_parser().parse_args(argv + ["--precision", precision])
        args.num_inference_steps = F * N
        pipe = tcli.load_pipeline(args, device="cpu")
        weight = pipe.model.unet.out[2].weight
        assert weight.dtype == dtype
        torch.testing.assert_close(weight.float(), source.unet.out[2].weight.to(dtype).float())
    monkeypatch.setattr(tcli, "load_pipeline", lambda a, _p=pipe: _p)
    tcli.main(args)
    assert _frame_count(tmp_path / "out/cat/a cat dog.mp4") == 1  # ceil(2 / 2)


def test_cli_help_runs_and_mesh_is_refused(models, tmp_path, monkeypatch):  # noqa: F811
    """--help of both entry points; the JAX CLI's flags and defaults;
    --mesh 1,2 without WORLD_SIZE=2 is refused before anything loads, and
    --mesh 1,1 runs on a one-rank group that main starts and ends, writing
    the same mp4 as no --mesh."""
    for module in ("moca_tpu_torch.cli.main", "moca_tpu_torch.cli"):
        out = subprocess.run([sys.executable, "-m", module, "--help"], cwd=ROOT,
                             capture_output=True, text=True, timeout=120,
                             env={**os.environ, "PYTHONPATH": str(ROOT)})
        assert out.returncode == 0 and "--use_davis" in out.stdout, out.stderr
    jflags = {a.dest: a.default for a in jcli.build_parser()._actions}
    tflags = {a.dest: a.default for a in tcli.build_parser()._actions}
    assert tflags == jflags  # the same flags and defaults
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match=r"DP\*FIFO = 2 ranks, but WORLD_SIZE is 1"):
        tcli.main(tcli.build_parser().parse_args(["--mesh", "1,2"]))
    assert not torch.distributed.is_initialized()

    cond = tmp_path / "cat.png"
    Image.fromarray(np.full((16, 16, 4), 128, np.uint8), "RGBA").save(cond)
    csv = tmp_path / "prompts.csv"
    csv.write_text("prompt,conditioned_object,conditioned_image_path,conditioned_prompt,gamma\n"
                   f"a red fox,cat,{cond},a cat,0.4\n")
    argv = _common_args(2) + ["--prompt_file", str(csv), "--output_dir", "out",
                              "--no_save_frames"]
    kw = dict(video_length=F, num_partitions=N, new_video_length=2, guidance_scale=7.5)
    pipes = []

    def load(a):
        pipes.append(MoCAVideoPipeline(models[1], HashTokenizer(), mesh=tcli.parse_mesh(a), **kw))
        return pipes[-1]

    monkeypatch.setattr(tcli, "load_pipeline", load)
    for run, extra in (("plain", []), ("mesh", ["--mesh", "1,1"])):
        (tmp_path / run).mkdir()
        monkeypatch.chdir(tmp_path / run)
        tcli.main(tcli.build_parser().parse_args(argv + extra))
        assert not torch.distributed.is_initialized()
    assert pipes[0].mesh is None and pipes[1].mesh.shape == (1, 1)
    video = "out/cat/a red fox.mp4"
    assert (tmp_path / "mesh" / video).read_bytes() == (tmp_path / "plain" / video).read_bytes()
