"""The port's batch text-to-video path against the JAX package's.

The samplers (`expand_context`'s tiling, the CFG variants with temporal
guidance on a real tiny U-Net, `ddim_decode`, `ddim_invert_frames`,
`ddim_sample` from a given x_T at a temperature, and DDPM on a 50-timestep
schedule), the model bundle's `count_params` and `decode_latents`, and
`T2VPipeline` end to end: two prompts in one batch, `uncond_type=
'zero_embed'`, `cfg_ours` with temporal guidance, DDPM and FreeInit. The
port's noise is replayed from the JAX package's keys (`JaxReplayNormal`);
weights are the tiny seeded model of tests/test_torch_davis.py. fp32 on the
CPU; tolerances are stated per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_davis import models  # noqa: F401  (fixture)
from test_torch_sampling import JaxReplayNormal, _rand, _t, one_torch_thread  # noqa: F401
from test_torch_slice import F, H, W

from moca_tpu import schedule as jschedule
from moca_tpu.models.tokenizer import HashTokenizer as JHashTokenizer
from moca_tpu.pipelines.t2v import T2VPipeline as JT2VPipeline
from moca_tpu.sampling import ddim as jddim
from moca_tpu.sampling import ddpm as jddpm
from moca_tpu_torch import schedule as tschedule
from moca_tpu_torch.models.tokenizer import HashTokenizer
from moca_tpu_torch.pipelines.t2v import T2VPipeline
from moca_tpu_torch.sampling import ddim as tddim
from moca_tpu_torch.sampling import ddpm as tddpm

ATOL = 1e-5  # elementwise fp32 maths on O(1) values
STEPS = 4


def ddim_keys(key, steps: int, prefix: tuple):
    """ddim_sample's layout under `prefix`: key -> (x_T, split [steps])."""
    key_init, key_steps = jax.random.split(key)
    step_keys = jax.random.split(key_steps, steps)
    return {prefix + ("init",): key_init,
            **{prefix + ("step", i): step_keys[i] for i in range(steps)}}


def test_expand_context_tiles_prompt_minor():
    """A [B, L, D] context covers R*B window rows prompt-minor (jnp.tile), a
    [1, L, D] one broadcasts, and rows that B does not divide are refused."""
    ctx = _rand((2, 3, 5), 1)
    for c, rows in ((ctx, 6), (ctx[:1], 6), (ctx, 2)):
        ref = jddim.expand_context(jnp.asarray(c), rows)
        port = tddim.expand_context(_t(c), rows)
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    assert tddim.expand_context(_t(ctx), 6)[3, 0, 0] == ctx[1, 0, 0]
    with pytest.raises(ValueError):
        tddim.expand_context(_t(ctx), 5)


# (uc_type, temporal_guidance_scale, with an uncond context)
CFG_CASES = {"standard": (None, None, True), "cfg_original": ("cfg_original", None, True),
             "cfg_ours": ("cfg_ours", None, True), "temporal": (None, 2.0, True),
             "cfg_ours_temporal": ("cfg_ours", 2.0, True), "cond_only_temporal": (None, 2.0, False)}


@pytest.mark.parametrize("case", sorted(CFG_CASES))
def test_cfg_variants_match_jax(models, case):  # noqa: F811
    """make_cfg_eps_fn's three uc_types and the temporal term (two more
    cond-only calls, one with no_temporal_attn) on the tiny U-Net, B=2
    rows of a 1-prompt context; observed <= 3e-6 of the output's magnitude,
    bound 3e-5."""
    jmodel, tmodel = models
    uc_type, s_t, with_uc = CFG_CASES[case]
    x = _rand((2, F, H // 8, W // 8, 4), 2)
    ts = np.random.default_rng(3).integers(0, 1000, (2, F)).astype(np.int32)
    ctx, uc = _rand((1, 7, 16), 4), _rand((1, 7, 16), 5) if with_uc else None
    j = lambda a: None if a is None else jnp.asarray(a)
    ref = jddim.make_cfg_eps_fn(jmodel.apply_unet, jmodel.unet_params, j(ctx), j(uc), 7.5, fps=8,
                                uc_type=uc_type, temporal_guidance_scale=s_t)(j(x), j(ts))
    with torch.no_grad():
        port = tddim.make_cfg_eps_fn(tmodel.apply_unet, _t(ctx), None if uc is None else _t(uc),
                                     7.5, fps=8, uc_type=uc_type,
                                     temporal_guidance_scale=s_t)(_t(x), torch.from_numpy(ts))
    ref = np.asarray(ref)
    np.testing.assert_allclose(port.numpy(), ref, atol=3e-5 * np.abs(ref).max())


@pytest.mark.parametrize("case", ["decode", "invert", "x_T_temperature"])
def test_ddim_variants_match_jax(case):
    """ddim_decode from schedule index 6 (ddim.py:673-692), the closed-form
    inversion of 3 frames into an 8-slot stack (ddim.py:972-1032), and
    ddim_sample from a given x_T at temperature 0.5, B=2 with the step
    noise shared; use_scale on."""
    jsch = jschedule.make_schedule(8, use_scale=True)
    tsch = tschedule.make_schedule(8, use_scale=True, device="cpu")
    key = jax.random.PRNGKey(6)
    x = _rand((2, 2, 4, 4, 3), 7)
    jeps = lambda x, t: 0.1 * x + 1e-4 * t[:, :, None, None, None].astype(jnp.float32)
    teps = lambda x, t: 0.1 * x + 1e-4 * t[:, :, None, None, None].float()
    if case == "decode":
        ref = jddim.ddim_decode(jeps, jsch, jnp.asarray(x), 6, key)
        keys = jax.random.split(key, 6)
        normal = JaxReplayNormal(lambda tag: keys[tag[2]])
        port = tddim.ddim_decode(teps, tsch, _t(x), 6, normal)
    elif case == "invert":
        clean = _rand((1, 3, 4, 4, 3), 8)
        ref = jddim.ddim_invert_frames(jsch, jnp.asarray(clean), key)
        normal = JaxReplayNormal(lambda tag: key)
        port = tddim.ddim_invert_frames(tsch, _t(clean), normal)
        assert port.shape == (1, 8, 4, 4, 3) and normal.tags == [("invert",)]
    else:
        ref, _ = jddim.ddim_sample(jeps, jsch, x.shape, key, x_T=jnp.asarray(x), temperature=0.5)
        keys = ddim_keys(key, 8, ("base",))
        normal = JaxReplayNormal(keys.__getitem__)
        port, x_T = tddim.ddim_sample(teps, tsch, x.shape, normal, x_T=_t(x), temperature=0.5)
        assert ("base", "init") not in normal.tags and torch.equal(x_T, _t(x))
    # 8 steps of fp32 maths (observed <= 8.6e-6)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=1e-4)


@pytest.fixture(scope="module")
def ddpm_schedules():
    kw = dict(ddim_num_steps=10, num_timesteps=50, use_scale=True, mid_step=20)
    return jschedule.make_schedule(**kw), tschedule.make_schedule(**kw, device="cpu")


@pytest.mark.parametrize("per_frame", [False, True])
def test_ddpm_math_matches_jax(ddpm_schedules, per_frame):
    """q_sample (with and without the use_scale ramp), predict_start_from_noise
    and q_posterior on the 50-timestep schedule of tests/test_ddpm.py, at one
    t or one t per frame."""
    jsch, tsch = ddpm_schedules
    t = np.array([0, 5, 20, 49]) if per_frame else 20
    x0, x_t, noise = (_rand((2, 4, 3, 3, 2), s) for s in (9, 10, 11))
    jt, tt = jnp.asarray(t), torch.as_tensor(t)
    pairs = [(tddpm.q_sample(tsch, _t(x0), tt, _t(noise)),
              jddpm.q_sample(jsch, jnp.asarray(x0), jt, jnp.asarray(noise))),
             (tddpm.q_sample(tsch, _t(x0), tt, _t(noise), use_scale=False),
              jddpm.q_sample(jsch, jnp.asarray(x0), jt, jnp.asarray(noise), use_scale=False)),
             (tddpm.predict_start_from_noise(tsch, _t(x_t), tt, _t(noise)),
              jddpm.predict_start_from_noise(jsch, jnp.asarray(x_t), jt, jnp.asarray(noise)))]
    pairs += list(zip(tddpm.q_posterior(tsch, _t(x0), _t(x_t), tt),
                      jddpm.q_posterior(jsch, jnp.asarray(x0), jnp.asarray(x_t), jt)))
    for port, ref in pairs:
        ref = np.asarray(ref)
        np.testing.assert_allclose(port.numpy(), ref, rtol=2e-5, atol=ATOL)  # sqrt(1/a) at t=49


@pytest.mark.parametrize("parameterization,clip", [("eps", False), ("x0", True)])
def test_ddpm_sample_matches_jax(ddpm_schedules, parameterization, clip):
    """The ancestral loop over all 50 timesteps, B=2 with the noise shared,
    both parameterizations (x0 with clip_denoised); fp32 through 50 steps,
    observed <= 1.5e-6, bound 1e-5."""
    jsch, tsch = ddpm_schedules
    key = jax.random.PRNGKey(12)
    jfn = lambda x, t: 0.05 * x + 1e-3 * t[:, :, None, None, None].astype(jnp.float32)
    tfn = lambda x, t: 0.05 * x + 1e-3 * t[:, :, None, None, None].float()
    shape = (2, 2, 4, 4, 2)
    ref = jddpm.ddpm_sample(jfn, jsch, shape, key, parameterization=parameterization,
                            clip_denoised=clip)
    keys = ddim_keys(key, 50, ("ddpm",))
    normal = JaxReplayNormal(keys.__getitem__)
    port = tddpm.ddpm_sample(tfn, tsch, shape, normal, parameterization=parameterization,
                             clip_denoised=clip)
    assert len(normal.tags) == 51
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=ATOL)


def test_count_params_and_decode_latents_match_jax(models):  # noqa: F811
    """Parameters per tower, and decode_latents on [B=2, T=3] latents, the 6
    frames in one decoder call and in calls of 4; observed ~1e-6 of the
    frames' magnitude, bound 1e-5."""
    jmodel, tmodel = models
    assert tmodel.count_params() == jmodel.count_params()
    z = _rand((2, 3, H // 8, W // 8, 4), 13)
    ref = np.asarray(jmodel.decode_latents(jnp.asarray(z)))
    with torch.no_grad():
        for chunk in (8, 4):
            port = tmodel.decode_latents(_t(z), chunk=chunk)
            assert port.shape == (2, 3, H, W, 3)
            np.testing.assert_allclose(port.numpy(), ref, atol=1e-5 * np.abs(ref).max())


# case -> (build keywords, call keywords, prompts); FreeInit runs 2 iterations
T2V_CASES = {
    "two_prompts": ({}, {}, ["a cat surfing", "a dog skating"]),
    "zero_embed": (dict(uncond_type="zero_embed"), {}, "a cat surfing"),
    "cfg_ours_temporal": (dict(uc_type="cfg_ours", temporal_cfg_scale=2.0), {}, "a cat"),
    "ddpm": (dict(num_steps=0, num_timesteps=50), dict(use_ddpm=True), "a cat surfing"),
    "freeinit": ({}, dict(freeinit=2), "a cat surfing"),
}


def t2v_keys(key, case, steps):
    """T2VPipeline's key layout in the JAX package (t2v.py:26-254)."""
    if case == "ddpm":
        return ddim_keys(key, 50, ("ddpm",))
    if case != "freeinit":
        return ddim_keys(key, steps, ("base",))
    key, k0 = jax.random.split(key)
    keys = ddim_keys(k0, steps, ("freeinit", 0))
    key, k_noise, k_mix, k_samp = jax.random.split(key, 4)
    keys.update({("freeinit", 1, "noise"): k_noise, ("freeinit", 1, "mix"): k_mix})
    keys.update({k: v for k, v in ddim_keys(k_samp, steps, ("freeinit", 1)).items()
                 if k[-1] != "init"})
    return keys


@pytest.mark.parametrize("case", sorted(T2V_CASES))
def test_t2v_pipeline_matches_jax(models, case):  # noqa: F811
    """Prompt encoding, the uncond context, CFG, the sampler and the clipped
    batched decode, frames [B?, T, H, W, 3] in [-1, 1]; the fp32 summation
    order differs, carried through the guided steps (observed <= 2.4e-5 over
    the cases, FreeInit's FFTs the largest; bound 2e-4, test_torch_slice's)."""
    jmodel, tmodel = models
    build, call, prompt = T2V_CASES[case]
    build = {"num_steps": STEPS, "guidance_scale": 7.5, "fps": 8, **build}
    jpipe = JT2VPipeline.build(jmodel, JHashTokenizer(), **build)
    tpipe = T2VPipeline.build(tmodel, HashTokenizer(), **build)
    key = jax.random.PRNGKey(14)
    size = dict(height=H, width=W, frames=F)
    normal = JaxReplayNormal(t2v_keys(key, case, STEPS).__getitem__)
    if case == "freeinit":
        ref = jpipe.sample_with_freeinit(prompt, key, iterations=2, **size)
        port = tpipe.sample_with_freeinit(prompt, normal=normal, iterations=2, **size)
    else:
        ref = jpipe(prompt, key, **size, **call)
        port = tpipe(prompt, normal=normal, **size, **call)
    batch = () if isinstance(prompt, str) else (len(prompt),)
    assert port.shape == batch + (F, H, W, 3) and set(tpipe.timings) == {"encode", "sample",
                                                                          "decode"}
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=2e-4)
    if case == "two_prompts":  # the prompts condition their rows
        assert np.abs(port[0].numpy() - port[1].numpy()).max() > 1e-3
    if case == "zero_embed":
        ctx = tpipe.encode_prompts(["a"])
        assert tpipe.uncond_context(2, like=torch.cat([ctx, ctx], 1)).shape == (2, 154, 16)
        assert float(tpipe.uncond_context(1).abs().max()) == 0.0
