"""The port's acceptance certification beside scripts/acceptance.py.

One tiny upstream-layout model.ckpt (tests/test_torch_cli.py's `tiny_ckpt`:
the port's seeded towers under the upstream prefixes, plus the keys the
loaders skip), the shrunk YAML and a four-merge BPE table. Each package's
acceptance runs once on it at 32x32, f=4, n=2, 4 new frames, fp32 by
default, with --skip_oracles, the port with its noise replayed from the JAX
script's key (PRNGKey(seed) in the pipeline's layout) and the CPU named:
the verdicts must carry the same keys and stage verdicts, the same towers'
parameter counts and tokenizer entries, and golden frames within
FRAME_ATOL (tests/test_torch_slice.py's fp32 summation-order bound). More
runs of the port cover the SSIM gate (its own frames pass, a planted
reference fails), the --masks semantics, a PNG-directory reference, the
LitEma layout and the oracles stage with no reference repository.
"""

import gzip
import json

import jax
import numpy as np
import pytest
from test_torch_cli import TINY_YAML, _write, tiny_ckpt  # noqa: F401  (fixture)
from test_torch_sampling import JaxReplayNormal, one_torch_thread, pipeline_keys  # noqa: F401
from test_torch_slice import FRAME_ATOL, F, N, H, W

from moca_tpu_torch.cli import acceptance

NEW = 4
TOWERS = ("unet", "vae", "clip")


@pytest.fixture(scope="module")
def fixture_dir(tiny_ckpt, tmp_path_factory):  # noqa: F811
    """model.ckpt (plain and LitEma layouts), config.yaml, bpe.txt.gz."""
    _, _, sd = tiny_ckpt
    d = tmp_path_factory.mktemp("acceptance")
    _write(sd, "plain", d / "model.ckpt")
    _write(sd, "ema", d / "ema.ckpt")
    (d / "config.yaml").write_text(TINY_YAML)
    with gzip.open(d / "bpe.txt.gz", "wt", encoding="utf-8") as f:
        f.write("version\nc a\nca t</w>\nd o\ndo g</w>\n")
    return d


def _argv(d, tmp, extra, ckpt="model.ckpt"):
    return ["--ckpt", str(d / ckpt), "--bpe", str(d / "bpe.txt.gz"),
            "--config", str(d / "config.yaml"), "--out", str(tmp / "verdict.json"),
            "--artifacts", str(tmp / "artifacts"), "--height", str(H), "--width", str(W),
            "--video_length", str(F), "--num_partitions", str(N),
            "--new_video_length", str(NEW), "--guidance_scale", "7.5",
            "--skip_oracles"] + extra


def _replay(seed, device):
    """The JAX script's noise, PRNGKey(seed) in MoCAVideoPipeline's layout."""
    steps = F * N
    return JaxReplayNormal(pipeline_keys(jax.random.PRNGKey(seed), steps, NEW + steps - F,
                                         2 * N, F))


def _run_port(d, tmp, extra=(), ckpt="model.ckpt"):
    """(exit code, verdict, artifacts dir) of the port's acceptance on the CPU."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(acceptance, "GeneratorNormal", _replay)
        code = acceptance.main(_argv(d, tmp, list(extra), ckpt), device="cpu")
    return code, json.loads((tmp / "verdict.json").read_text()), tmp / "artifacts"


@pytest.fixture(scope="module")
def runs(fixture_dir, tmp_path_factory):
    """{package: (exit code, verdict, artifacts dir)}: one no-reference run
    of each package."""
    from scripts.acceptance import main as jax_main

    out = {"port": _run_port(fixture_dir, tmp_path_factory.mktemp("port"))}
    tmp = tmp_path_factory.mktemp("jax")
    code = jax_main(_argv(fixture_dir, tmp, []))
    out["jax"] = (code, json.loads((tmp / "verdict.json").read_text()), tmp / "artifacts")
    return out


def _golden(art):
    return np.load(art / "golden_frames.npz")["frames"]


def test_verdicts_match_jax(runs):
    """The same keys at the top and in every stage, the same stage verdicts,
    parameter counts, checkpoint facts and tokenizer entries."""
    (pcode, port, _), (jcode, ref, _) = runs["port"], runs["jax"]
    assert pcode == jcode == 0
    assert set(port) == set(ref) == {"stages", "ckpt", "config", "seed", "ok", "passed",
                                     "skipped"}
    assert list(port["stages"]) == list(ref["stages"]) == ["convert", "tokenizer", "oracles",
                                                           "golden", "ssim"]
    for name, stage in ref["stages"].items():
        assert set(port["stages"][name]) == set(stage), name
        assert port["stages"][name]["ok"] == stage["ok"], name
    for k in ("ok", "passed", "skipped", "seed", "config", "ckpt"):
        assert port[k] == ref[k], k
    conv, jconv = port["stages"]["convert"], ref["stages"]["convert"]
    for k in ["ckpt_keys", "ema_shadow_present"] + [f"{t}_params" for t in TOWERS]:
        assert conv[k] == jconv[k], k
    # the port loads the shadows where the JAX script converts them
    assert conv["note"] == jconv["note"].replace("converting", "loading")
    assert conv["unet_params"] > 0
    assert port["stages"]["tokenizer"] == ref["stages"]["tokenizer"]
    assert port["stages"]["tokenizer"]["known_answer_checked"] is False
    assert port["stages"]["oracles"] == ref["stages"]["oracles"] == {
        "ok": None, "skipped": "--skip_oracles"}
    g, jg = port["stages"]["golden"], ref["stages"]["golden"]
    for k in ("ok", "frames", "finite", "injection"):
        assert g[k] == jg[k], k
    assert g["frames"] == 2 and "inactive" in g["injection"]
    assert port["stages"]["ssim"] == ref["stages"]["ssim"]


def test_golden_frames_match_jax(runs):
    """The tail slice of the clip (the last new_video_length // 2 frames)
    within FRAME_ATOL, written as the JAX script writes it."""
    (_, _, art), (_, _, jart) = runs["port"], runs["jax"]
    port, ref = _golden(art), _golden(jart)
    assert port.shape == ref.shape == (NEW // 2, H, W, 3)
    np.testing.assert_allclose(port, ref, rtol=0, atol=FRAME_ATOL)
    assert np.abs(port[0] - port[-1]).max() > 1e-2  # not vacuous: the frames move
    for name in ("golden_frames.npz", "golden.mp4", "frame_0000.png", "frame_0001.png"):
        assert (art / name).exists() and (jart / name).exists(), name


def test_ssim_gate(fixture_dir, runs, tmp_path):
    """The run's own frames pass the 0.98 gate and the exit code says so;
    an inverted clip as the reference fails it, with exit code 1."""
    frames = _golden(runs["port"][2])
    for name, ref, ok in (("same", frames, True), ("inverted", -frames, False)):
        np.savez(tmp_path / f"{name}.npz", frames=ref)
        code, report, _ = _run_port(fixture_dir, tmp_path / name,
                                    ["--reference_frames", str(tmp_path / f"{name}.npz")])
        s = report["stages"]["ssim"]
        assert s["ok"] is ok and s["compared_frames"] == 2
        assert (s["ssim_per_frame_min"] >= 0.98) is ok
        assert code == (0 if ok else 1) and report["ok"] is ok
        np.testing.assert_array_equal(_golden(tmp_path / name / "artifacts"), frames)


def test_masks_injection_semantics(fixture_dir, runs, tmp_path):
    """--masks goes through PrecomputedMaskProvider; faithful to the
    reference the emitted frames are the same as without masks, and
    --inject_into_queue changes them (tests/test_acceptance.py:113)."""
    base = _golden(runs["port"][2])
    masks = tmp_path / "masks.npz"
    np.savez(masks, masks=np.ones((3, H // 8, W // 8), np.float32))
    code, report, art = _run_port(fixture_dir, tmp_path / "faithful", ["--masks", str(masks)])
    assert code == 0 and report["stages"]["golden"]["injection"].startswith("precomputed masks")
    np.testing.assert_array_equal(_golden(art), base)
    code, report, art = _run_port(fixture_dir, tmp_path / "fixed",
                                  ["--masks", str(masks), "--inject_into_queue"])
    assert code == 0 and "(into queue)" in report["stages"]["golden"]["injection"]
    assert not np.allclose(_golden(art), base)


def test_png_directory_reference(fixture_dir, runs, tmp_path):
    """--reference_frames takes the run's PNG directory; the uint8 round
    trip keeps SSIM above the gate."""
    art = runs["port"][2]
    assert sorted(p.name for p in art.glob("frame_*.png")) == ["frame_0000.png", "frame_0001.png"]
    code, report, _ = _run_port(fixture_dir, tmp_path, ["--reference_frames", str(art)])
    s = report["stages"]["ssim"]
    assert code == 0 and s["ok"] is True and s["compared_frames"] == 2


def test_ema_layout(fixture_dir, runs, tmp_path):
    """A LitEma checkpoint (live U-Net zeroed, the shadows hold the weights):
    the convert stage says so and loads the shadows, so the golden clip is
    the plain checkpoint's."""
    code, report, art = _run_port(fixture_dir, tmp_path, ckpt="ema.ckpt")
    conv = report["stages"]["convert"]
    assert code == 0 and conv["ema_shadow_present"] is True and "EMA" in conv["note"]
    assert conv["unet_params"] == runs["port"][1]["stages"]["convert"]["unet_params"]
    np.testing.assert_array_equal(_golden(art), _golden(runs["port"][2]))


def test_oracles_skipped_without_the_reference(fixture_dir, tmp_path):
    """Without --skip_oracles and with a reference path that holds no lvdm,
    the oracles stage records its missing prerequisites as skipped and the
    verdict stays ok."""
    empty = tmp_path / "no_reference"
    empty.mkdir()
    argv = [a for a in _argv(fixture_dir, tmp_path, ["--reference_repo", str(empty),
                                                     "--skip_golden"])
            if a != "--skip_oracles"]
    code = acceptance.main(argv, device="cpu")
    report = json.loads((tmp_path / "verdict.json").read_text())
    o = report["stages"]["oracles"]
    assert o["ok"] is None and o["skipped"].startswith("oracle prerequisites missing")
    assert "lvdm" in o["skipped"]
    assert code == 0 and report["ok"] is True and "golden" not in report["stages"]
