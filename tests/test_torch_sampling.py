"""The port's schedule, FreeInit mix and samplers against the JAX package.

Inputs come from numpy seeds; the noise the port draws through
`normal(tag, shape)` is replayed from the JAX package's `jax.random` key
layout (docs/RNG.md) by `JaxReplayNormal`, so both sides consume identical
numbers. fp32 on the CPU throughout; tolerances are stated per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moca_tpu import freeinit as jfreeinit
from moca_tpu import schedule as jschedule
from moca_tpu.sampling import ddim as jddim
from moca_tpu.sampling import fifo as jfifo
from moca_tpu.sampling import moca as jmoca
from moca_tpu_torch import freeinit as tfreeinit
from moca_tpu_torch import schedule as tschedule
from moca_tpu_torch.sampling import ddim as tddim
from moca_tpu_torch.sampling import fifo as tfifo
from moca_tpu_torch.sampling import moca as tmoca

ATOL = 1e-5  # elementwise fp32 maths on O(1) values


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for these tiny tensors: the tests run in parallel
    workers, and torch's thread pools oversubscribe the cores between them
    (a test of a few seconds alone took minutes in a 6-worker run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class JaxReplayNormal:
    """`normal(tag, shape)` that replays jax.random.normal(resolve(tag), shape)."""

    def __init__(self, resolve):
        self.resolve = resolve
        self.tags = []

    def __call__(self, tag, shape):
        self.tags.append(tag)
        draw = jax.random.normal(self.resolve(tag), tuple(shape), jnp.float32)
        return torch.from_numpy(np.array(draw))


def window_keys(key, windows: int, f: int):
    """fifo_step's layout: key -> split [R] per window -> split [f] per frame."""
    per_window = jax.random.split(key, windows)
    return lambda r, j: jax.random.split(per_window[r], f)[j]


def pipeline_keys(root, steps: int, total: int, windows: int, f: int, encode_key=None):
    """MoCAVideoPipeline.__call__'s key layout (moca_video.py:119, 285, ddim.py:170-174,
    fifo.py:140,174,256, moca.py:87,128): tag -> key. ("encode",) is the
    posterior draw of `encode_frames`, made with `encode_key` (the JAX CLI's
    key_enc, cli/main.py:191-192, beside the pipeline's key `root`)."""
    k_base, k_queue, k_fifo = jax.random.split(root, 3)
    key_init, key_steps = jax.random.split(k_base)
    step_keys = jax.random.split(key_steps, steps)
    iter_keys = jax.random.split(k_fifo, total)

    def resolve(tag):
        if tag == ("encode",) and encode_key is not None:
            return encode_key
        if tag == ("base", "init"):
            return key_init
        if tag[:2] == ("base", "step"):
            return step_keys[tag[2]]
        if tag == ("queue",):
            return k_queue
        if tag[0] == "fifo":
            k_win, k_shift, k_anchor = jax.random.split(iter_keys[tag[1]], 3)
            if tag[2] == "shift":
                return k_shift
            if tag[2] == "anchor":
                return k_anchor
            assert tag[2] == "win" and tag[4] == "frame", tag
            return window_keys(k_win, windows, f)(tag[3], tag[5])
        raise KeyError(tag)

    return resolve


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


@pytest.mark.parametrize("use_scale", [True, False])
def test_schedule_arrays_match(use_scale):
    ref = jschedule.make_schedule(64, use_scale=use_scale)
    port = tschedule.make_schedule(64, use_scale=use_scale, device="cpu")
    for field in ("betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
                  "sqrt_one_minus_alphas_cumprod", "scale_arr", "ddim_timesteps",
                  "ddim_alphas", "ddim_alphas_prev", "ddim_sigmas",
                  "ddim_sqrt_one_minus_alphas", "ddim_scale_arr", "ddim_scale_arr_prev"):
        np.testing.assert_array_equal(getattr(port, field).numpy(),
                                      np.asarray(getattr(ref, field)), err_msg=field)
    np.testing.assert_array_equal(port.ddim_timesteps_np, np.asarray(ref.ddim_timesteps))


def test_timestep_embedding_matches():
    ts = np.array([[0, 1, 250, 999], [17, 500, 501, 3]])
    for dim in (64, 33):
        ref = jschedule.timestep_embedding(jnp.asarray(ts), dim)
        port = tschedule.timestep_embedding(torch.from_numpy(ts), dim)
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=1e-4)  # fp32 sin/cos of ~1e3


@pytest.mark.parametrize("filter_type", ["gaussian", "butterworth", "ideal", "box"])
def test_freq_mix_3d_matches(filter_type):
    shape = (2, 3, 4, 8, 6)
    x, n = _rand(shape, 1), _rand(shape, 2)
    lpf_np = np.asarray(jfreeinit.get_freq_filter(shape[-3:], filter_type, 4, 0.25, 0.25))
    port_lpf = tfreeinit.get_freq_filter(shape[-3:], filter_type, 4, 0.25, 0.25)
    np.testing.assert_array_equal(port_lpf.numpy(), lpf_np)
    ref = jfreeinit.freq_mix_3d(jnp.asarray(x), jnp.asarray(n), jnp.asarray(lpf_np))
    port = tfreeinit.freq_mix_3d(_t(x), _t(n), port_lpf)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("use_scale", [True, False])
@pytest.mark.parametrize("per_frame", [False, True])
def test_ddim_step_math_matches(use_scale, per_frame):
    jsch = jschedule.make_schedule(16, use_scale=use_scale)
    tsch = tschedule.make_schedule(16, use_scale=use_scale, device="cpu")
    x, eps, noise = (_rand((2, 4, 3, 3, 4), s) for s in (3, 4, 5))
    index = np.array([0, 5, 9, 15]) if per_frame else 7  # per-frame: one index per T
    ref = jddim.ddim_step_math(jsch, jnp.asarray(x), jnp.asarray(eps), jnp.asarray(index),
                               jnp.asarray(noise))
    port = tddim.ddim_step_math(tsch, _t(x), _t(eps), torch.as_tensor(index), _t(noise))
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=ATOL)


def test_cfg_eps_fn_interleaves_rows():
    """Row 2i = cond_i, row 2i+1 = uncond_i; guidance combine."""
    seen = {}

    def fake_unet(x, t, ctx, fps):
        seen["ctx"] = ctx.clone()
        return x * ctx[:, 0, 0].reshape(-1, 1, 1, 1, 1) + t[..., None, None, None]

    x = _t(_rand((3, 2, 2, 2, 4), 6))
    t = torch.arange(6).reshape(3, 2)
    ctx, uc = torch.ones(1, 5, 8), torch.full((1, 5, 8), 2.0)
    eps = tddim.make_cfg_eps_fn(fake_unet, ctx, uc, 7.5)(x, t)
    assert seen["ctx"][:, 0, 0].tolist() == [1.0, 2.0] * 3
    e_c, e_u = x + t[..., None, None, None], 2 * x + t[..., None, None, None]
    torch.testing.assert_close(eps, e_u + 7.5 * (e_c - e_u))


@pytest.mark.parametrize("branch", ["no_masks", "davis", "seg", "davis_no_cond",
                                    "inject_into_queue"])
def test_moca_window_step_matches(branch):
    """Momentum, both injection branches, zero-cond injection and the gamma
    blend, with the noise replayed from the window key; tolerance 1e-4
    (the momentum recurrence carries fp32 rounding across frames)."""
    f = 6
    jsch = jschedule.make_schedule(f * 2)
    tsch = tschedule.make_schedule(f * 2, device="cpu")
    cfg_kw = dict(inject_into_queue=branch == "inject_into_queue")
    jcfg, tcfg = jmoca.MoCAConfig(**cfg_kw), tmoca.MoCAConfig(**cfg_kw)
    x, eps = _rand((1, f, 4, 4, 4), 7), _rand((1, f, 4, 4, 4), 8)
    indices = np.arange(f) * 2
    timesteps = np.asarray(jsch.ddim_timesteps)[indices]  # spans t <= 300 and above
    cond = None if branch in ("no_masks", "davis_no_cond") else _rand((4, 4, 4), 9)
    masks = None
    if branch != "no_masks":
        masks = np.zeros((1, f, 4, 4, 1), np.float32)
        masks[:, :, 1:3, 1:4] = 1.0
        masks[:, 2] = 0.0  # one frame with an empty mask: the gate stays shut
    davis = branch != "seg"
    key = jax.random.PRNGKey(11)
    ref = jmoca.moca_window_step(
        jsch, jcfg, jnp.asarray(x), jnp.asarray(eps), jnp.asarray(indices),
        jnp.asarray(timesteps), key, cond_image=None if cond is None else jnp.asarray(cond),
        masks=None if masks is None else jnp.asarray(masks), masks_are_davis=davis,
        gamma=0.7)
    frame_keys = jax.random.split(key, f)
    normal = JaxReplayNormal(lambda tag: frame_keys[tag[-1]])
    port = tmoca.moca_window_step(
        tsch, tcfg, _t(x), _t(eps), indices, timesteps, normal, ("w",),
        cond_image=None if cond is None else _t(cond),
        masks=None if masks is None else _t(masks), masks_are_davis=davis, gamma=0.7)
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=1e-4)


def _plan_pair(f=4, n=2, lookahead=True):
    jsch = jschedule.make_schedule(f * n)
    tsch = tschedule.make_schedule(f * n, device="cpu")
    plan = jfifo.make_fifo_plan(np.asarray(jsch.ddim_timesteps), f, n, lookahead)
    tplan = tfifo.make_fifo_plan(tsch.ddim_timesteps_np, f, n, lookahead)
    np.testing.assert_array_equal(tplan.timesteps, plan.timesteps)
    np.testing.assert_array_equal(tplan.indices, plan.indices)
    return jsch, tsch, plan, tplan


@pytest.mark.parametrize("lookahead", [True, False])
def test_prepare_queue_matches(lookahead):
    jsch, tsch, plan, tplan = _plan_pair(lookahead=lookahead)
    clean = _rand((1, 4, 3, 3, 4), 12)
    key = jax.random.PRNGKey(13)
    ref = jfifo.prepare_queue(jsch, plan, jnp.asarray(clean), key)
    port = tfifo.prepare_queue(tsch, tplan, _t(clean), JaxReplayNormal(lambda tag: key))
    assert port.shape == (1, tplan.queue_length, 3, 3, 4)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("tail_mode", ["freeinit", "plain"])
def test_shift_queue_matches(tail_mode):
    latents = _rand((1, 6, 4, 6, 4), 14)
    key = jax.random.PRNGKey(15)
    ref = jfifo.shift_queue(jnp.asarray(latents), key, tail_mode=tail_mode)
    port = tfifo.shift_queue(_t(latents), JaxReplayNormal(lambda tag: key), ("s",),
                             tail_mode=tail_mode)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("with_masks", [False, True])
def test_fifo_step_matches(with_masks):
    """All windows in one eps call, MoCA per window, lookahead write-back;
    tolerance 1e-4 (momentum recurrence)."""
    f, n = 4, 2
    jsch, tsch, plan, tplan = _plan_pair(f, n)
    q = plan.queue_length
    latents = _rand((1, q, 3, 3, 4), 16)
    cond = _rand((3, 3, 4), 17)
    masks = None
    if with_masks:
        masks = np.zeros((1, q, 3, 3, 1), np.float32)
        masks[:, :, 1:, :2] = 1.0
    key = jax.random.PRNGKey(18)
    jeps = lambda x, t: 0.1 * x + 1e-3 * t[:, :, None, None, None]
    teps = lambda x, t: 0.1 * x + 1e-3 * t[:, :, None, None, None]
    ref = jfifo.fifo_step(jeps, jsch, plan, jmoca.MoCAConfig(), jnp.asarray(latents), key,
                          cond_image=jnp.asarray(cond),
                          masks=None if masks is None else jnp.asarray(masks), gamma=0.5)
    keys = window_keys(key, plan.num_windows, f)
    normal = JaxReplayNormal(lambda tag: keys(tag[2], tag[4]))
    port = tfifo.fifo_step(teps, tsch, tplan, tmoca.MoCAConfig(), _t(latents), normal, ("i",),
                           cond_image=_t(cond), masks=None if masks is None else _t(masks),
                           gamma=0.5)
    assert len(normal.tags) == plan.num_windows * f
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=1e-4)
