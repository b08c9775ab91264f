"""The port's batched prompts and its batch text-to-video CLI.

MoCAVideoPipeline with B=2 prompts against the JAX package's B=2 run (noise
replayed from its keys) and against two B=1 runs of the port, under both
uncond types, and its refusals at B > 1; `cli.inference` (prompt file,
contiguous shards, --bs rounds, the n_samples grid, FreeInit, DDPM, its
noise mapping, the loader and its refusals) with a tiny pipeline on the CPU,
mirroring tests/test_cli_inference.py; and the video IO it writes with
(`save_video_grid`, `load_image_batch`) beside the JAX package's.
"""

import gzip
import os
import subprocess
import sys
from pathlib import Path

import cv2
import imageio
import jax
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_cli import TINY_YAML, _write, tiny_ckpt  # noqa: F401  (fixture)
from test_torch_davis import models  # noqa: F401  (fixture)
from test_torch_sampling import JaxReplayNormal, one_torch_thread, pipeline_keys  # noqa: F401
from test_torch_slice import F, FRAME_ATOL, H, N, NEW, W

import moca_tpu.cli.inference as jinf
from moca_tpu.io import video as jvideo
from moca_tpu.models.tokenizer import HashTokenizer as JHashTokenizer
from moca_tpu.pipelines.moca_video import MoCAVideoPipeline as JPipeline
import moca_tpu_torch.cli.inference as inf
import moca_tpu_torch.cli.main as tcli
from moca_tpu_torch.io import video as tvideo
from moca_tpu_torch.models.tokenizer import HashTokenizer
from moca_tpu_torch.pipelines.moca_video import MoCAVideoPipeline
from moca_tpu_torch.pipelines.t2v import T2VPipeline

ROOT = Path(__file__).resolve().parent.parent
PROMPTS = ["a cat surfing", "a dog skating"]


@pytest.mark.parametrize("uncond_type", ["empty_seq", "zero_embed"])
def test_moca_batched_prompts_match_jax_and_single_runs(models, uncond_type):  # noqa: F811
    """Two prompts in one queue, with the concept image and the conditioned
    prompt: each stream equals the JAX package's B=2 run and the port's B=1
    run of its prompt with the same noise, both within FRAME_ATOL
    (test_torch_slice's; the CPU's matrix products round differently at
    another batch size: B=2 against B=1 observed 1.5e-5)."""
    jmodel, tmodel = models
    kw = dict(video_length=F, num_partitions=N, new_video_length=NEW, guidance_scale=7.5,
              uncond_type=uncond_type)
    jpipe, tpipe = JPipeline(jmodel, JHashTokenizer(), **kw), \
        MoCAVideoPipeline(tmodel, HashTokenizer(), **kw)
    cond = np.random.default_rng(1).standard_normal((H // 8, W // 8, 4)).astype(np.float32)
    call = dict(cond_image=cond, conditioned_prompt="a bird", gamma=0.7, height=H, width=W)
    key = jax.random.PRNGKey(5)
    total = NEW + F * N - F
    replay = lambda: JaxReplayNormal(pipeline_keys(key, F * N, total, tpipe.plan.num_windows, F))
    ref = jpipe(PROMPTS, key, **call)
    port = tpipe(PROMPTS, normal=replay(), **call)
    assert len(port) == len(ref) == 2
    for b in range(2):
        single = tpipe(PROMPTS[b], normal=replay(), **call)
        assert len(port[b]) == len(single) == total
        for p, r, s in zip(port[b], ref[b], single):
            np.testing.assert_allclose(p, np.asarray(r), atol=FRAME_ATOL)
            np.testing.assert_allclose(p, s, atol=FRAME_ATOL)
    assert np.abs(port[0][-1] - port[1][-1]).max() > 1e-3  # the streams differ


@pytest.mark.parametrize("name", ["masks", "davis_frames", "clean_latents", "multiprompts",
                                  "mask_provider", "viz"])
def test_moca_batched_prompts_refuse_per_stream_state(models, name):  # noqa: F811
    value = {"masks": np.zeros((F, 4, 4)), "davis_frames": np.zeros((F, H, W, 3)),
             "clean_latents": np.zeros((2, F, 4, 4, 4)), "multiprompts": [("a", 1)],
             "mask_provider": lambda *a: None, "viz": object()}[name]
    pipe = MoCAVideoPipeline(models[1], HashTokenizer(), video_length=F, num_partitions=N,
                             new_video_length=NEW)
    with pytest.raises(ValueError, match=f"batched prompts .*{name}"):
        pipe(PROMPTS, height=H, width=W, **{name: value})


# ---------------------------------------------------------------------------
# cli/inference.py
# ---------------------------------------------------------------------------

LINES = "a red fox\na blue bird\na green frog\n"


@pytest.fixture(scope="module")
def t2v_pipe(models):  # noqa: F811
    return T2VPipeline.build(models[1], HashTokenizer(), num_steps=F, guidance_scale=7.5, fps=8)


def _run(argv, pipe, tmp_path, monkeypatch=None, lines=LINES):
    """main() on a prompt file with `pipe` injected; returns (savedir,
    {file name: the sample videos save_video_grid was given})."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    prompt_file = tmp_path / "prompts.txt"
    prompt_file.write_text(lines)
    savedir = tmp_path / "out"
    args = inf.build_parser().parse_args([
        "--ckpt_path", "/nonexistent.ckpt", "--prompt_file", str(prompt_file),
        "--savedir", str(savedir), "--height", str(H), "--width", str(W),
        "--frames", str(F)] + argv)
    written = {}
    if monkeypatch is not None:
        def capture(samples, path, fps):
            written[os.path.basename(path)] = samples
            tvideo.save_video_grid(samples, path, fps=fps)

        monkeypatch.setattr(inf, "save_video_grid", capture)
    inf.main(args, pipe=pipe)
    return savedir, written


@pytest.mark.parametrize("argv,files", [
    ([], ["a blue bird.mp4", "a green frog.mp4", "a red fox.mp4"]),
    (["--num_processes", "2", "--rank", "1"], ["a green frog.mp4"]),  # contiguous shards
    (["--bs", "2"], ["a blue bird.mp4", "a green frog.mp4", "a red fox.mp4"]),  # rounds 2 + 1
    (["--n_samples", "2", "--num_processes", "3"], ["a red fox.mp4"]),
])
def test_batch_cli_writes_one_mp4_per_prompt(t2v_pipe, tmp_path, argv, files):
    """The reference's file layout (tests/test_cli_inference.py:65-118): one
    mp4 per prompt of this rank's contiguous shard, with --bs or without,
    and n_samples side by side in one make_grid row (W = n(w+2)+2,
    H = h+4)."""
    savedir, _ = _run(argv, t2v_pipe, tmp_path)
    assert sorted(os.listdir(savedir)) == files
    n = 2 if "--n_samples" in argv else 1
    cap = cv2.VideoCapture(str(savedir / files[0]))
    assert int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)) == n * (W + 2) + 2
    assert int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)) == H + 4
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == F
    cap.release()


def test_batch_cli_round_draws_what_single_prompt_runs_draw(t2v_pipe, tmp_path, monkeypatch):
    """--bs 2 on 3 prompts (rounds [0, 1] and [2]) against --bs 1: a round's
    first prompt draws what the single run of that prompt draws, so its
    video is the same (within FRAME_ATOL: the CPU's matrix products round
    per batch size); the round's second prompt shares the first's noise,
    not the one its single run uses."""
    _, batched = _run(["--bs", "2"], t2v_pipe, tmp_path / "bs2", monkeypatch)
    _, single = _run([], t2v_pipe, tmp_path / "bs1", monkeypatch)
    for name in ("a red fox.mp4", "a green frog.mp4"):
        np.testing.assert_allclose(np.stack(batched[name][0]), np.stack(single[name][0]),
                                   atol=FRAME_ATOL)
    diff = np.abs(np.stack(batched["a blue bird.mp4"][0]) - np.stack(single["a blue bird.mp4"][0]))
    assert diff.max() > 1e-3


@pytest.mark.parametrize("mode", ["freeinit", "ddpm"])
def test_batch_cli_freeinit_and_ddpm(models, t2v_pipe, tmp_path, monkeypatch, mode):  # noqa: F811
    """--freeinit_iters 2 runs FreeInit and --ddim_steps 0 ancestral DDPM
    (here on a 20-timestep schedule), each with the noise of sample_normal
    (seed, prompt index, sample index): the video saved equals the
    pipeline's own call with that noise."""
    if mode == "ddpm":
        pipe = T2VPipeline.build(models[1], HashTokenizer(), num_steps=0, num_timesteps=20,
                                 guidance_scale=7.5, fps=8)
        argv = ["--ddim_steps", "0"]
    else:
        pipe, argv = t2v_pipe, ["--freeinit_iters", "2"]
    _, written = _run(argv + ["--seed", "7"], pipe, tmp_path, monkeypatch, lines="a red fox\n")
    normal = inf.sample_normal(7, 0, 0, 1, "cpu")
    size = dict(height=H, width=W, frames=F)
    if mode == "ddpm":
        ref = pipe("a red fox", normal=normal, use_ddpm=True, **size)
    else:
        ref = pipe.sample_with_freeinit("a red fox", normal=normal, iterations=2, **size)
    np.testing.assert_allclose(np.stack(written["a red fox.mp4"][0]), ref.numpy(), atol=1e-6)


def test_batch_cli_loader_and_refusals(tiny_ckpt, tmp_path, monkeypatch):  # noqa: F811
    """load_pipeline on the shrunk YAML and checkpoint carries the flags
    (steps, eta, guidance, temporal guidance, fps) and the YAML's
    uncond_type ('zero_embed', which cli.main now takes too) into the
    pipeline, and main writes the video; with --mesh 1,1 main starts and
    ends a one-rank group on the CPU and writes the same mp4; --mesh 1,2
    without WORLD_SIZE=2, --bs with n_samples, FreeInit or --mode i2v (also
    on an i2v config), and --mode i2v without --cond_image_dir are refused
    (the i2v loader: tests/test_torch_i2v.py)."""
    cfg_path, _, sd = tiny_ckpt
    zero = tmp_path / "zero.yaml"
    zero.write_text(TINY_YAML.replace("uncond_type: empty_seq", "uncond_type: zero_embed"))
    _write(sd, "plain", tmp_path / "model.ckpt")
    bpe = tmp_path / "vocab.txt.gz"
    with gzip.open(bpe, "wt", encoding="utf-8") as f:  # test_torch_cli's tiny vocab
        f.write("version\nc a\nca t</w>\nd o\ndo g</w>\n")
    (tmp_path / "p.txt").write_text("a cat\n")
    base = ["--ckpt_path", str(tmp_path / "model.ckpt"), "--config", str(zero),
            "--bpe_path", str(bpe),
            "--prompt_file", str(tmp_path / "p.txt"), "--savedir", str(tmp_path / "out"),
            "--height", str(H), "--width", str(W), "--frames", str(F)]
    args = inf.build_parser().parse_args(base + [
        "--ddim_steps", "3", "--ddim_eta", "0.5", "--unconditional_guidance_scale", "6",
        "--unconditional_guidance_scale_temporal", "2", "--fps", "9", "--precision", "fp32"])
    pipe = inf.load_pipeline(args, device="cpu")
    assert (pipe.sch.num_ddim_steps, pipe.guidance_scale, pipe.temporal_cfg_scale, pipe.fps,
            pipe.uncond_type) == (3, 6.0, 2.0, 9, "zero_embed")
    assert float(pipe.sch.ddim_sigmas[1]) > 0 and pipe.model.device.type == "cpu"
    inf.main(args, pipe=pipe)
    assert os.listdir(tmp_path / "out") == ["a cat.mp4"]
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    loader, loaded = inf.load_pipeline, []

    def load_on_cpu(a):
        loaded.append(loader(a, device="cpu"))
        return loaded[-1]

    monkeypatch.setattr(inf, "load_pipeline", load_on_cpu)
    mesh_args = inf.build_parser().parse_args(
        [a if a != str(tmp_path / "out") else str(tmp_path / "mesh") for a in base]
        + ["--ddim_steps", "3", "--ddim_eta", "0.5", "--unconditional_guidance_scale", "6",
           "--unconditional_guidance_scale_temporal", "2", "--fps", "9", "--precision", "fp32",
           "--mesh", "1,1"])
    inf.main(mesh_args)
    assert loaded[0].mesh.shape == (1, 1) and not torch.distributed.is_initialized()
    assert ((tmp_path / "mesh" / "a cat.mp4").read_bytes()
            == (tmp_path / "out" / "a cat.mp4").read_bytes())
    monkeypatch.setattr(inf, "load_pipeline", loader)
    margs = tcli.build_parser().parse_args(["--ckpt_path", str(tmp_path / "model.ckpt"),
                                            "--config", str(zero), "--bpe_path", str(bpe)])
    assert tcli.load_pipeline(margs, device="cpu").uncond_type == "zero_embed"

    i2v = tmp_path / "i2v.yaml"
    i2v.write_text(TINY_YAML.replace("lvdm.models.ddpm3d.LatentDiffusion",
                                     "lvdm.models.ddpm3d.LatentVisualDiffusion"))
    refusals = [(["--config", str(i2v), "--mode", "i2v", "--bs", "2"], ValueError,
                 "plain base sampling"),
                (["--mode", "i2v"], ValueError, "cond_image_dir"),
                (["--mesh", "1,2"], ValueError, "DP\\*FIFO = 2 ranks, but WORLD_SIZE is 1"),
                (["--bs", "2", "--n_samples", "2"], ValueError, "plain base sampling"),
                (["--bs", "2", "--freeinit_iters", "2"], ValueError, "plain base sampling")]
    for extra, exc, match in refusals:
        with pytest.raises(exc, match=match):
            inf.main(inf.build_parser().parse_args(base + extra))


def test_batch_cli_help_and_flags_match_jax():
    out = subprocess.run([sys.executable, "-m", "moca_tpu_torch.cli.inference", "--help"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0 and "--n_samples" in out.stdout, out.stderr
    flags = lambda p: {a.dest: a.default for a in p._actions}
    # the port's additions for DynamiCrafter's hybrid configs, at defaults
    # that keep the JAX CLI's sampling
    added = {"frame_stride": None, "guidance_rescale": 0.0, "timestep_spacing": "uniform"}
    assert flags(inf.build_parser()) == {**flags(jinf.build_parser()), **added}
    assert not set(added) & set(flags(jinf.build_parser()))


# ---------------------------------------------------------------------------
# io/video.py
# ---------------------------------------------------------------------------

def test_save_video_grid_layout_matches_jax(tmp_path):
    """make_grid's layout to the pixel (tests/test_cli_inference.py:122): a
    127-gray border, the samples in one row; the same gif as the JAX
    package's, and save_gif adds the extension."""
    a = [np.full((4, 6, 3), v, np.float32) for v in (-1.0, 0.0)]
    b = [np.full((4, 6, 3), 1.0, np.float32)] * 2
    tvideo.save_video_grid([a, b], str(tmp_path / "port.gif"), fps=5)
    jvideo.save_video_grid([a, b], str(tmp_path / "jax.gif"), fps=5)
    port = np.asarray(imageio.mimread(str(tmp_path / "port.gif")))
    np.testing.assert_array_equal(port, np.asarray(imageio.mimread(str(tmp_path / "jax.gif"))))
    frame = port[0][..., :3]
    assert port.shape[0] == 2 and frame.shape == (4 + 4, 2 * (6 + 2) + 2, 3)
    assert (frame[0] == 127).all() and (frame[2:6, 2:8] == 0).all()
    assert (frame[2:6, 10:16] == 255).all()
    tvideo.save_gif(a, str(tmp_path / "clip"), fps=5)
    assert (tmp_path / "clip.gif").exists()


def test_load_image_batch_matches_jax(tmp_path):
    """png and jpg (as RGBA), and an mp4's first frame, resized to (H, W) and
    scaled to [-1, 1], equal to the JAX package's read of the same files
    (its uint8 conversion may differ by one fp32 ulp)."""
    rng = np.random.default_rng(3)
    Image.fromarray(rng.integers(0, 255, (20, 30, 4), np.uint8), "RGBA").save(tmp_path / "a.png")
    Image.fromarray(rng.integers(0, 255, (20, 30, 3), np.uint8), "RGB").save(tmp_path / "b.jpg")
    tvideo.save_video([rng.uniform(-1, 1, (16, 16, 3)).astype(np.float32)] * 2,
                      str(tmp_path / "c.mp4"))
    for name in ("a.png", "b.jpg", "c.mp4"):
        paths = [str(tmp_path / name)]
        port = tvideo.load_image_batch(paths, (H, W))
        np.testing.assert_allclose(port, jvideo.load_image_batch(paths, (H, W)), atol=1.2e-6)
        assert port.shape == (1, H, W, 3 if name == "c.mp4" else 4)
    with pytest.raises(NotImplementedError):
        tvideo.load_image_batch([str(tmp_path / "a.bmp")])
