"""The plain reference against the port at a tiny configuration on the CPU,
network by network and through a whole run of each cell."""

from __future__ import annotations

import pytest
import torch

from benchmark import common, program
from benchmark.reference import build, diffusion as rd, layout
from benchmark.run import execute
from benchmark.tests.tiny import tiny_cell

CELLS = ("vc2-fifo-davis", "vc1-i2v-clip")


@pytest.fixture(scope="module", params=CELLS)
def models(request):
    cell = tiny_cell(request.param, precision="float32")
    return (cell, program.build_model(cell.config, common.seed_weights(cell)),
            build(cell.config, common.seed_weights(cell)))


def test_weights_have_the_programs_names_and_shapes(models):
    cell, prog, _ = models
    assert layout(cell.config)[0] == {k: tuple(v.shape) for k, v in prog.state_dict().items()}


@torch.inference_mode()
def test_unet(models):
    cell, prog, ref = models
    g = torch.Generator().manual_seed(1)
    ctx_len = 77 + (16 if "vision" in cell.config else 0)
    x = torch.randn(2, 4, 4, 8, 4, generator=g)
    t = torch.randint(0, 1000, (2, 4), generator=g)
    ctx = torch.randn(2, ctx_len, cell.config["unet"]["context_dim"], generator=g)
    assert common.rel_l2(prog.apply_unet(x, t, ctx, 10), ref.unet(x, t, ctx, 10)) < 1e-5


@torch.inference_mode()
def test_text_tower_and_tokens(models):
    _, prog, ref = models
    texts = ["A superhero in a dynamic pose, cape flowing", ""]
    tokens = rd.hash_tokens(texts)
    assert (tokens == program.tokenizer()(texts)).all()
    assert common.rel_l2(prog.encode_tokens(tokens), ref.clip(torch.as_tensor(tokens))) < 1e-5


@torch.inference_mode()
def test_vae(models):
    cell, prog, ref = models
    g = torch.Generator().manual_seed(2)
    frames = torch.rand(3, 32, 64, 3, generator=g) * 2 - 1
    mean, logvar = prog.vae.encode_moments(frames)
    rmean, rlogvar = ref.vae.moments(frames)
    assert common.rel_l2(mean, rmean) < 1e-5 and common.rel_l2(logvar, rlogvar) < 1e-5
    z = torch.randn(3, 4, 8, 4, generator=g)
    assert common.rel_l2(prog.decode_single(z).clamp(-1, 1), ref.decode(z)) < 1e-5


@torch.inference_mode()
def test_image_towers():
    cell = tiny_cell("vc1-i2v-clip", precision="float32")
    prog = program.build_model(cell.config, common.seed_weights(cell))
    ref = build(cell.config, common.seed_weights(cell))
    image = torch.rand(1, 32, 64, 3, generator=torch.Generator().manual_seed(3)) * 2 - 1
    assert common.rel_l2(prog.get_image_embeds(image), ref.image_embeds(image)) < 1e-5


def test_schedule_matches_the_programs():
    from moca_tpu_torch.schedule import make_schedule

    cell = tiny_cell("vc2-fifo-davis")
    ours = rd.Schedule(64, 1.0, cell.config["diffusion"], "cpu")
    theirs = make_schedule(ddim_num_steps=64, ddim_eta=1.0, device="cpu")
    assert (ours.timesteps == theirs.ddim_timesteps_np).all()
    for a, b in ((ours.a, theirs.ddim_alphas), (ours.a_prev, theirs.ddim_alphas_prev),
                 (ours.sigma, theirs.ddim_sigmas), (ours.scale, theirs.ddim_scale_arr),
                 (ours.scale_prev, theirs.ddim_scale_arr_prev)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", CELLS)
def test_a_whole_run_is_correct(name):
    """The port in float32 equals the reference to rounding through a whole
    run. (In bf16 the tiny model reads above the full-size limits, which were
    set from the cells' own sizes; test_benchmark_control.py compares it
    with the control.)"""
    line, _ = execute(tiny_cell(name, precision="float32"), started=0.0)
    assert line["correct"], line["check"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    # rounding, amplified 12x by classifier-free guidance in the step numbers
    assert all(r["value"] < 1e-3 for r in line["check"].values()), line["check"]
