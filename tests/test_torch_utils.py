"""The port's host utilities against the JAX package's: io/fastio.py (and
io/video.py's use of it), utils/ema.py, utils/profiling.py and the plot
helpers of utils/visualization.py.

fastio: the port builds native/fastio.cpp itself (into a directory of its
own, never into native/); the JAX bindings load the same source built by
native/Makefile into tmp_path. Each function is held to numpy and to the
JAX bindings on the same arrays, as tests/test_fastio.py holds the JAX ones:
float -> uint8 and the packing bit for bit; uint8 -> float bit for bit to
the JAX bindings and within one float32 rounding (2^-23 at |x| <= 1) of
numpy's (x / 255 - 0.5) * 2, which the library computes as x * (2/255) - 1.
"""

import json
import os
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_davis import models  # noqa: F401  (fixture)
from test_torch_sampling import one_torch_thread  # noqa: F401  (fixture)
from test_torch_slice import F, H, N, W

from moca_tpu.io import fastio as jfastio
from moca_tpu.io import segmentation as jseg
from moca_tpu.models.tokenizer import HashTokenizer as JHashTokenizer
from moca_tpu.pipelines.moca_video import MoCAVideoPipeline as JPipeline
from moca_tpu.utils import ema as jema
from moca_tpu.utils import profiling as jprofiling
from moca_tpu.utils import visualization as jviz
from moca_tpu_torch.io import fastio, video
from moca_tpu_torch.io import segmentation as tseg
from moca_tpu_torch.models.tokenizer import HashTokenizer
from moca_tpu_torch.pipelines.moca_video import MoCAVideoPipeline
from moca_tpu_torch.utils import ema, profiling
from moca_tpu_torch.utils import visualization as tviz

NATIVE = os.path.join(os.path.dirname(os.path.dirname(__file__)), "native")
U8_ULP = 2.0 ** -23


@pytest.fixture(scope="module")
def jax_fastio(tmp_path_factory):
    """The JAX bindings on native/Makefile's build of native/fastio.cpp in
    tmp_path (the module finds the library next to its package root)."""
    root = tmp_path_factory.mktemp("jax_fastio")
    target = root / "native" / "libfastio.so"
    target.parent.mkdir()
    out = subprocess.run(["make", "-C", NATIVE, f"TARGET={target}"], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    mp = pytest.MonkeyPatch()
    mp.setattr(jfastio, "__file__", str(root / "moca_tpu" / "io" / "fastio.py"))
    mp.setattr(jfastio, "_LIB", None)
    assert jfastio.available()
    yield jfastio
    mp.undo()


def test_fastio_builds_into_its_own_directory(tmp_path, monkeypatch):
    """The library is built at first use into BUILD_DIR, loads with the ABI
    check, and native/ is left as it was."""
    before = sorted(os.listdir(NATIVE))
    monkeypatch.setattr(fastio, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(fastio, "_LIB", None)
    assert fastio.available()
    built = os.listdir(tmp_path / "build")
    assert len(built) == 1 and built[0].startswith("libfastio-") and built[0].endswith(".so")
    assert fastio._load().fastio_abi_version() == 1
    assert sorted(os.listdir(NATIVE)) == before
    monkeypatch.setattr(fastio, "_LIB", None)
    monkeypatch.setenv("CXX", str(tmp_path / "no-compiler"))
    monkeypatch.setattr(fastio, "BUILD_DIR", str(tmp_path / "other"))
    assert not fastio.available()  # no compiler: the numpy paths


def test_fastio_float_to_uint8(jax_fastio):
    x = np.random.default_rng(0).uniform(-1.5, 1.5, size=(7, 33, 3)).astype(np.float32)
    got = fastio.float_to_uint8(x)
    np.testing.assert_array_equal(got, ((np.clip(x, -1, 1) + 1.0) * 127.5).astype(np.uint8))
    np.testing.assert_array_equal(got, jax_fastio.float_to_uint8(x))


def test_fastio_uint8_to_float(jax_fastio):
    x = np.arange(256, dtype=np.uint8).reshape(16, 16)
    got = fastio.uint8_to_float(x)
    np.testing.assert_allclose(got, (x.astype(np.float32) / 255.0 - 0.5) * 2.0, rtol=0,
                               atol=U8_ULP)
    np.testing.assert_array_equal(got, jax_fastio.uint8_to_float(x))


def test_fastio_roundtrip_large_parallel_path(jax_fastio):
    """> 1 << 16 elements: the threaded chunks."""
    img = np.random.default_rng(1).integers(0, 256, size=(320, 512, 3), dtype=np.uint8)
    f = fastio.uint8_to_float(img)
    np.testing.assert_array_equal(f, jax_fastio.uint8_to_float(img))
    back = fastio.float_to_uint8(f)
    np.testing.assert_array_equal(back, jax_fastio.float_to_uint8(f))
    assert np.abs(back.astype(np.int32) - img.astype(np.int32)).max() <= 1


def test_fastio_pack_frames(jax_fastio):
    rng = np.random.default_rng(2)
    frames = [rng.integers(0, 256, size=(40, 64, 3), dtype=np.uint8) for _ in range(9)]
    np.testing.assert_array_equal(fastio.pack_frames(frames), np.stack(frames))
    np.testing.assert_array_equal(fastio.pack_frames(frames), jax_fastio.pack_frames(frames))
    with pytest.raises(ValueError):
        fastio.pack_frames([np.zeros((2, 2), np.uint8), np.zeros((3, 2), np.uint8)])


def test_video_uses_fastio_where_available(monkeypatch):
    """io/video.py's uint8 -> float calls the library, and its numpy path,
    taken without the library, gives the same values; float -> uint8 and the
    packing stay on numpy (the library was no faster there on the H100's
    host) and equal the library's results."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-1.2, 1.2, (8, 12, 3)).astype(np.float32)
    u8 = rng.integers(0, 256, (8, 12, 3), dtype=np.uint8)
    frames = [np.full((4, 4, 3), i, np.uint8) for i in range(5)]
    calls = []
    for name in ("float_to_uint8", "uint8_to_float", "pack_frames"):
        fn = getattr(fastio, name)
        monkeypatch.setattr(fastio, name, lambda *a, _n=name, _f=fn: calls.append(_n) or _f(*a))
    native = (video.tensor_to_uint8(x), video.uint8_to_tensor(u8), video.stack_frames(frames))
    assert video.stack_frames([np.zeros((4, 4, 3), np.float32)] * 3).shape == (3, 4, 4, 3)
    assert calls == ["uint8_to_float"]
    np.testing.assert_array_equal(native[0], fastio.float_to_uint8(x))
    np.testing.assert_array_equal(native[2], fastio.pack_frames(frames))
    monkeypatch.setattr(fastio, "available", lambda: False)
    plain = (video.tensor_to_uint8(x), video.uint8_to_tensor(u8), video.stack_frames(frames))
    assert calls == ["uint8_to_float", "float_to_uint8", "pack_frames"]
    np.testing.assert_array_equal(native[0], plain[0])
    np.testing.assert_allclose(native[1], plain[1], rtol=0, atol=U8_ULP)
    np.testing.assert_array_equal(native[2], plain[2])


@pytest.mark.parametrize("use_num_updates", [True, False])
def test_ema_update_matches_jax(use_num_updates):
    """Five updates of a small parameter set (tests/test_utils_oracle.py's
    case) against the JAX package's ema_update, fp32."""
    rng = np.random.default_rng(4)
    shapes = {"conv.weight": (4, 3, 3, 3), "conv.bias": (4,), "lin.weight": (7, 5)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    tstate = ema.EMAState.create({k: torch.from_numpy(v.copy()) for k, v in params.items()})
    jstate = jema.EMAState.create({k: jnp.asarray(v) for k, v in params.items()})
    assert tstate.num_updates.dtype == torch.int32 and tstate.num_updates.ndim == 0
    for step in range(5):
        params = {k: v + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
                  for k, v in params.items()}
        tstate = ema.ema_update(tstate, {k: torch.from_numpy(v) for k, v in params.items()},
                                decay=0.99, use_num_updates=use_num_updates)
        jstate = jema.ema_update(jstate, {k: jnp.asarray(v) for k, v in params.items()},
                                 decay=0.99, use_num_updates=use_num_updates)
        assert int(tstate.num_updates) == int(jstate.num_updates) == step + 1
        for k in shapes:
            np.testing.assert_allclose(tstate.params[k].numpy(), np.asarray(jstate.params[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=f"step {step} {k}")


def test_step_timer_matches_jax(monkeypatch, capsys):
    """The enabled default from MOCA_TPU_PROFILE, the summary's keys and the
    report line, beside the JAX StepTimer."""
    monkeypatch.setenv("MOCA_TPU_PROFILE", "1")
    timers = (profiling.StepTimer(), jprofiling.StepTimer())
    monkeypatch.setenv("MOCA_TPU_PROFILE", "0")
    assert not profiling.StepTimer().enabled and not jprofiling.StepTimer().enabled
    lines = []
    for timer in timers:
        assert timer.enabled
        for _ in range(2):
            with timer.stage("decode"):
                pass
        timer.report()
        lines.append(json.loads(capsys.readouterr().out.strip()))
    assert lines[0].keys() == lines[1].keys() == {"profile"}
    assert lines[0]["profile"].keys() == lines[1]["profile"].keys() == {"decode"}
    assert (lines[0]["profile"]["decode"].keys() == lines[1]["profile"]["decode"].keys()
            == {"count", "total_s", "mean_s", "min_s"})
    assert lines[0]["profile"]["decode"]["count"] == 2
    quiet = profiling.StepTimer(enabled=False)
    with quiet.stage("decode"):
        pass
    quiet.report()
    assert quiet.times == {} and capsys.readouterr().out == ""


def test_pipeline_profile_line_has_jax_stages(models, monkeypatch, capsys):  # noqa: F811
    """MOCA_TPU_PROFILE=1: a tiny open-vocab run of each package prints one
    {"profile": ...} line; the port's stages hold every stage of the JAX
    package's, and `timings` reads the same records."""
    monkeypatch.setenv("MOCA_TPU_PROFILE", "1")
    kw = dict(video_length=F, num_partitions=N, new_video_length=2, guidance_scale=7.5)
    call = dict(height=H, width=W, target="cat")
    seg = lambda frame, target: (frame[:, :, 0] > 127).astype(np.float32)  # noqa: E731
    import jax

    JPipeline(models[0], JHashTokenizer(), **kw)(
        "a mouse", jax.random.PRNGKey(0), mask_provider=jseg.CallbackMaskProvider(seg), **call)
    jline = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    pipe = MoCAVideoPipeline(models[1], HashTokenizer(), **kw)
    pipe("a mouse", seed=0, mask_provider=tseg.CallbackMaskProvider(seg), **call)
    out = [line for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert len(out) == 1
    tline = json.loads(out[0])
    assert set(jline["profile"]) == {"fifo_iteration", "decode", "mask_provider"}
    assert set(jline["profile"]) <= set(tline["profile"])
    for name, s in tline["profile"].items():
        assert s.keys() == {"count", "total_s", "mean_s", "min_s"}
        assert s["total_s"] == round(pipe.timings[name], 4)


def test_trace_writes_chrome_trace(tmp_path):
    """trace() profiles the block on the CPU and writes a Chrome trace that
    holds the annotate() range."""
    with profiling.trace(str(tmp_path / "trace")) as d:
        with profiling.annotate("moca_step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(d, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "moca_step" for e in events)


def _pngs(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, root)
            out[rel] = np.asarray(Image.open(path)) if name.endswith(".png") else np.load(path)
    return out


@pytest.mark.parametrize("helper", ["mask_and_latent", "sampling", "masks", "latents",
                                    "object_attention"])
def test_visualization_helpers_match_jax(tmp_path, helper):
    """Each plot helper writes the JAX helper's files from the same inputs:
    the same names, image sizes and pixels (matplotlib's renderings too),
    and the same raw dumps."""
    rng = np.random.default_rng(5)
    calls = {
        "mask_and_latent": lambda m: m.visualize_mask_and_latent(
            (np.arange(64).reshape(8, 8) % 2).astype(np.float32),
            rng.normal(size=(8, 8, 4)).astype(np.float32), timestep=300, frame_idx=2,
            save_dir=d),
        "sampling": lambda m: m.visualize_sampling(
            rng.normal(size=(4, 8, 8, 4)).astype(np.float32),
            rng.normal(size=(4, 8, 8, 2)).astype(np.float32), d, step=7, is_manipulated=True),
        "masks": lambda m: m.visualize_masks(
            (rng.uniform(size=(3, 6, 6, 1)) > 0.5).astype(np.float32), d, step=3),
        "latents": lambda m: m.visualize_latents(rng.normal(size=(3, 5, 5, 4)).astype(np.float32),
                                                 d),
        "object_attention": lambda m: m.visualize_object_attention(
            rng.normal(size=(8, 8, 3)).astype(np.float32),
            rng.normal(size=(8, 8, 1)).astype(np.float32),
            (rng.uniform(size=(8, 8)) > 0.5).astype(np.float32),
            rng.uniform(size=(8, 8)).astype(np.float32),
            (rng.uniform(size=(8, 8)) * 4).astype(np.int32), "cat", d, step=5),
    }
    outs = []
    for name, module in (("jax", jviz), ("port", tviz)):
        d = str(tmp_path / name)
        rng = np.random.default_rng(5)
        calls[helper](module)
        outs.append(_pngs(d))
    jout, tout = outs
    assert tout.keys() == jout.keys() and tout
    for rel in jout:
        assert tout[rel].shape == jout[rel].shape, rel
        np.testing.assert_array_equal(tout[rel], jout[rel], err_msg=rel)
