"""The port's user scripts (moca_tpu_torch/cli/) beside the JAX package's scripts/.

`v2i` and `convert_gifs` run on the same files as scripts/v2i.py and
scripts/convert_gifs.py and must write the same file names and pixels;
`generate_condition_images` runs beside the JAX script on the same tiny
weights (tests/test_torch_davis.py's seeded model, carried to the JAX
package) with the port's noise replayed from the JAX keys, and the RGBA PNGs
must agree within one uint8 level; `verify_drive` runs its whole drive with
the CPU named. fp32 on the CPU.
"""

import importlib.util
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_davis import models  # noqa: F401  (fixture)
from test_torch_sampling import JaxReplayNormal, one_torch_thread  # noqa: F401
from test_torch_t2v import t2v_keys

import moca_tpu.config as jconfig_mod
import moca_tpu.io.checkpoint as jckpt_mod
import moca_tpu.models.tokenizer as jtok_mod
from moca_tpu.models.tokenizer import HashTokenizer as JHashTokenizer
from moca_tpu_torch.cli import (acceptance, convert_gifs, eval_sweep, generate_condition_images,
                                v2i, verify_drive)
from moca_tpu_torch.cli.main import PRECISIONS
from moca_tpu_torch.io.video import load_video_frames, save_video
from moca_tpu_torch.models.tokenizer import HashTokenizer
from moca_tpu_torch.pipelines.t2v import T2VPipeline

ROOT = Path(__file__).resolve().parent.parent


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _frames(n, seed, hw=(32, 48)):
    return [np.random.default_rng(seed + i).integers(0, 256, hw + (3,), dtype=np.uint8)
            for i in range(n)]


@pytest.fixture(params=["numpy", "native"])
def conversion(request, monkeypatch):
    """Both packages' uint8 <-> float conversions pinned to one state: numpy
    on both sides, or the host library of native/fastio.cpp on both. Each
    package decides by itself whether its library loads (the JAX package
    once, at import, if native/libfastio.so exists; the port at first use,
    building its own copy), so in a parallel run the two could take
    different paths, which differ in the last bit of uint8 -> float and
    then by one level after the truncation back to uint8. The JAX side's
    library is the port's build of the same source and flags."""
    import moca_tpu.io.fastio as jfastio
    import moca_tpu.io.video as jvideo
    from moca_tpu_torch.io import fastio

    if request.param == "numpy":
        monkeypatch.setattr(jvideo, "_HAVE_FASTIO", False)
        monkeypatch.setattr(fastio, "available", lambda: False)
    else:
        if not fastio.available():
            pytest.skip("the host library does not build here")
        monkeypatch.setattr(jfastio, "_LIB", fastio._load())
        monkeypatch.setattr(jvideo, "_fastio", jfastio)
        monkeypatch.setattr(jvideo, "_HAVE_FASTIO", True)
    return request.param


@pytest.mark.parametrize("frame_rate,fmt", [(1, "png"), (2, "png"), (3, "jpg")])
def test_v2i_matches_jax_script(tmp_path, monkeypatch, conversion, frame_rate, fmt):
    """The same mp4 through both, each side's conversions pinned to the
    same state (`conversion`): the same frame_{N:06d}.{fmt} names and the
    same pixels (the same decoder and encoder on both sides)."""
    mp4 = tmp_path / "v.mp4"
    save_video(_frames(7, 1), str(mp4), fps=10)
    argv = ["--video_path", str(mp4), "--frame_rate", str(frame_rate), "--image_format", fmt]
    monkeypatch.setattr(sys, "argv", ["v2i.py"] + argv + ["--output_dir", str(tmp_path / "jax")])
    runpy.run_path(str(ROOT / "scripts" / "v2i.py"), run_name="__main__")
    paths = v2i.main(argv + ["--output_dir", str(tmp_path / "port")])
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert [Path(p).name for p in paths] == names
    assert names == [f"frame_{i:06d}.{fmt}" for i in range(len(range(0, 7, frame_rate)))]
    for name in names:
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port" / name)),
                                      np.asarray(Image.open(tmp_path / "jax" / name)))


SCRIPT_PARSERS = [  # each user script with --precision, and its required flags
    (eval_sweep, ["--ckpt_path", "model.ckpt"]),
    (acceptance, ["--ckpt", "model.ckpt", "--bpe", "vocab.txt.gz"]),
    (generate_condition_images, ["--ckpt_path", "model.ckpt"]),
]


@pytest.mark.parametrize("spelling", ["fp32", "float32", "bf16", "bfloat16"])
@pytest.mark.parametrize("script,argv", SCRIPT_PARSERS,
                         ids=[m.__name__.rsplit(".", 1)[-1] for m, _ in SCRIPT_PARSERS])
def test_script_parsers_take_the_jax_precision_spellings(script, argv, spelling):
    """--precision takes each spelling that the JAX scripts pass to
    `_dtype_of` (moca_tpu/config.py:63-68) and maps it to the torch
    counterpart of the dtype that gives."""
    args = script.build_parser().parse_args(argv + ["--precision", spelling])
    want = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[
        jconfig_mod._dtype_of(spelling)]
    assert PRECISIONS[args.precision] == want


@pytest.mark.parametrize("script,argv", SCRIPT_PARSERS,
                         ids=[m.__name__.rsplit(".", 1)[-1] for m, _ in SCRIPT_PARSERS])
def test_script_parsers_refuse_what_dtype_of_refuses(script, argv):
    """A name `_dtype_of` refuses stops at argparse."""
    with pytest.raises(ValueError):
        jconfig_mod._dtype_of("float16")
    with pytest.raises(SystemExit):
        script.build_parser().parse_args(argv + ["--precision", "float16"])


def test_convert_gifs_matches_jax_script(tmp_path):
    """One gif (with an alpha channel) in each of two trees: the JAX
    script's `convert` and the port's CLI write the mp4 beside it, with the
    same frames."""
    import imageio

    frames = [np.dstack([f, np.full(f.shape[:2], 255, np.uint8)]) for f in _frames(5, 2)]
    outs = {}
    for side in ("jax", "port"):
        gif = tmp_path / side / "sub" / "clip.gif"
        gif.parent.mkdir(parents=True)
        imageio.mimsave(str(gif), frames, duration=100)
        if side == "jax":
            outs[side] = _jax_script("convert_gifs").convert(str(gif), fps=10)
        else:
            written = convert_gifs.main([str(tmp_path / side), "--fps", "10"])
            assert written == [str(gif.with_suffix(".mp4"))]
            outs[side] = written[0]
    assert Path(outs["port"]).name == Path(outs["jax"]).name == "clip.mp4"
    port, ref = load_video_frames(outs["port"]), load_video_frames(outs["jax"])
    assert port.shape == (5, 32, 48, 3)
    np.testing.assert_array_equal(port, ref)


def test_generate_condition_images_matches_jax_script(models, tmp_path, monkeypatch):  # noqa: F811
    """Both scripts on one CSV (two rows with a missing image, one present)
    with the same tiny weights and the port's noise replayed from the JAX
    script's keys (fold_in(PRNGKey(seed), i) for the i-th missing row):
    the same files, RGBA at the asked size, pixels within one uint8 level
    (the frames differ by fp32 summation order, observed <= 1 level where a
    value sits on a rounding boundary); a second run finds every image
    present and writes nothing."""
    jmodel, tmodel = models
    steps, seed = 2, 5
    cfg = jconfig_mod.ModelConfig(diffusion=jconfig_mod.DiffusionParams(), unet=jmodel.unet_cfg,
                                  vae=jmodel.vae_cfg, clip=jmodel.clip_cfg)
    monkeypatch.setattr(jconfig_mod, "load_model_config", lambda *a, **k: cfg)
    monkeypatch.setattr(jckpt_mod, "load_or_convert", lambda *a, **k: (
        jmodel.unet_params, jmodel.vae_params, jmodel.clip_params))
    monkeypatch.setattr(jtok_mod, "load_tokenizer", lambda *a: JHashTokenizer())
    monkeypatch.setattr(generate_condition_images, "sample_normal", lambda s, i, *_: (
        JaxReplayNormal(t2v_keys(jax.random.fold_in(jax.random.PRNGKey(s), i), "base",
                                 steps).__getitem__)))
    pipe = T2VPipeline.build(tmodel, HashTokenizer(), num_steps=steps,
                             use_scale=cfg.diffusion.use_scale, guidance_scale=7.5)
    files = {}
    for side in ("jax", "port"):
        assets = tmp_path / side / "assets"
        assets.mkdir(parents=True)
        (assets / "present.png").write_bytes(b"")
        csv = tmp_path / side / "prompts.csv"
        csv.write_text("prompt,conditioned_object,conditioned_image_path,conditioned_prompt,"
                       "gamma\n"
                       f"a red fox,cat,{assets}/cat.png,a cat,0.4\n"
                       f"a cow,cow,{assets}/present.png,a cow,0.5\n"
                       f"a blue bird,dog,{assets}/dog.png,,0.6\n")
        argv = ["--ckpt_path", "model.ckpt", "--prompts_file", str(csv), "--assets_dir",
                str(assets), "--height", "32", "--width", "32", "--num_steps", str(steps),
                "--seed", str(seed)]
        if side == "jax":
            script = _jax_script("generate_condition_images")
            monkeypatch.setattr(sys, "argv", ["generate_condition_images.py"] + argv)
            script.main()
        else:
            written = generate_condition_images.main(argv, pipe=pipe)
            assert written == [str(assets / "cat.png"), str(assets / "dog.png")]
            assert generate_condition_images.main(argv, pipe=pipe) == []
        files[side] = sorted(p.name for p in assets.iterdir())
    assert files["port"] == files["jax"] == ["cat.png", "dog.png", "present.png"]
    for name in ("cat.png", "dog.png"):
        port, ref = (Image.open(tmp_path / side / "assets" / name) for side in ("port", "jax"))
        assert port.mode == ref.mode == "RGBA" and port.size == ref.size == (32, 32)
        diff = np.abs(np.asarray(port, np.int16) - np.asarray(ref, np.int16))
        assert diff.max() <= 1, diff.max()
    cat, dog = (np.asarray(Image.open(tmp_path / "port" / "assets" / n)) for n in
                ("cat.png", "dog.png"))
    assert not np.array_equal(cat, dog)  # each row drew its own noise


def test_verify_drive_runs_with_the_cpu_named(tmp_path):
    """The drive on the CPU: finite frames, an mp4 and a gif, the cached
    rerun identical and gamma leaving the frames as they are (the
    reference-faithful mode)."""
    out = verify_drive.main(["--out_dir", str(tmp_path / "drive")], device="cpu")
    assert len(out["frames"]) == 8 and out["frames"][0].shape == (32, 32, 3)
    assert out["finite"] and out["identical"]
    np.testing.assert_array_equal(np.stack(out["frames_gamma0"]), np.stack(out["frames"]))
    assert Path(out["mp4"]).stat().st_size > 0 and Path(out["gif"]).stat().st_size > 0
    assert (tmp_path / "drive" / "latents" / "8.npz").exists()
    assert load_video_frames(out["mp4"]).shape == (8, 32, 32, 3)
