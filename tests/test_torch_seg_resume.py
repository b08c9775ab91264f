"""The port's open-vocab mask provider, mid-run resume, base-latent cache and
multiprompts against the JAX package's.

The providers' gates on the same inputs; `fifo_step`'s queue-aligned
pre-injection pred_x0; the pipeline with a deterministic CallbackMaskProvider
at lag 1 (seg_async off) and lag 2 (on), frame by frame and call by call;
a run killed mid-stream and resumed from its `fifo_state.npz`, equal to the
uninterrupted run exactly with the port's GeneratorNormal, and within the
slice's tolerance to the JAX package's uninterrupted run with the JAX noise
replayed; the `{steps}.npz` base-latent cache; multi-prompt scene switching.
fp32 on the CPU; tolerances are stated per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_davis import _davis_inputs, models  # noqa: F401  (fixture)
from test_torch_sampling import (  # noqa: F401  (one_torch_thread: fixture)
    JaxReplayNormal, _plan_pair, _rand, _t, one_torch_thread, pipeline_keys, window_keys)
from test_torch_slice import FRAME_ATOL, F, H, N, W

from moca_tpu.io import segmentation as jseg
from moca_tpu.models.tokenizer import HashTokenizer as JHashTokenizer
from moca_tpu.pipelines.moca_video import MoCAVideoPipeline as JPipeline
from moca_tpu.sampling import fifo as jfifo
from moca_tpu.sampling import moca as jmoca
from moca_tpu_torch.io import segmentation as tseg
from moca_tpu_torch.models.tokenizer import HashTokenizer
from moca_tpu_torch.pipelines.moca_video import SNAPSHOT, MoCAVideoPipeline
from moca_tpu_torch.sampling import fifo as tfifo
from moca_tpu_torch.sampling import moca as tmoca

NEW = 3
KW = dict(video_length=F, num_partitions=N, new_video_length=NEW, guidance_scale=7.5)
COND = np.random.default_rng(50).standard_normal((H // 8, W // 8, 4)).astype(np.float32)


@pytest.fixture(scope="module")
def jpipe(models):  # noqa: F811
    """One JAX pipeline for the module, so its jitted iteration compiles once."""
    return JPipeline(models[0], JHashTokenizer(), **KW)


def _replay(key, jp, total):
    return JaxReplayNormal(pipeline_keys(key, F * N, total, jp.plan.num_windows, F))


def _segment_fn(every=0):
    """A deterministic stand-in detector: threshold channel 0 of the uint8
    frame; with `every`, every `every`-th call detects nothing. Records the
    masks it returns."""
    calls = []

    def seg(frame, target):
        assert target.endswith(".")
        calls.append(None)
        if every and len(calls) % every == 0:
            return None
        m = (frame[:, :, 0] > 127).astype(np.float32)
        calls[-1] = m
        return m

    return seg, calls


def test_mask_providers_match_jax():
    """latent_to_uint8_frame, mask_iou and both providers' outputs and
    state, call by call, on the same inputs (exact)."""
    rng = np.random.default_rng(51)
    for scale in (0.5, 3.0):  # max <= 1 scales by 255; otherwise a direct cast
        lat = rng.standard_normal((4, 5, 4)).astype(np.float32) * scale
        np.testing.assert_array_equal(tseg.latent_to_uint8_frame(lat),
                                      jseg.latent_to_uint8_frame(lat))
        np.testing.assert_array_equal(tseg.latent_to_uint8_frame(lat[..., :1]),
                                      jseg.latent_to_uint8_frame(lat[..., :1]))
    z = np.zeros((4, 4), np.float32)
    for a, b in ((z, z), (z, z + 1), (rng.random((4, 4)), rng.random((4, 4)))):
        assert tseg.mask_iou(a, b) == jseg.mask_iou(a, b)
    masks = (rng.random((3, 4, 4)) > 0.5).astype(np.float32)
    tp, jp = tseg.PrecomputedMaskProvider(masks), jseg.PrecomputedMaskProvider(masks)
    for i in range(5):
        np.testing.assert_array_equal(tp(i), jp(i))
    # empty detections, a drift below the IoU gate, an over-covering mask
    square = np.zeros((8, 8), np.float32)
    square[2:6, 2:6] = 1
    moved = np.roll(square, 3, axis=1)
    full = np.ones((8, 8), np.float32)
    script = [None, square, None, moved, square, full, None, square]
    providers = []
    for mod in (tseg, jseg):
        it = iter(script)
        providers.append(mod.CallbackMaskProvider(lambda frame, target, it=it: next(it)))
    frame = np.zeros((8, 8, 3), np.uint8)
    for i in range(len(script)):
        out = [p(i, frame, "cat") for p in providers]
        assert (out[0] is None) == (out[1] is None), i
        if out[0] is not None:
            np.testing.assert_array_equal(out[0], out[1])
        np.testing.assert_array_equal(np.asarray(providers[0].prev_mask, np.float32),
                                      np.asarray(providers[1].prev_mask, np.float32))


@pytest.mark.parametrize("lookahead", [True, False])
def test_fifo_step_pred_x0_matches(lookahead):
    """Provider masks (masks_are_davis=False: injection gated at t <= 300)
    and the queue-aligned pre-injection pred_x0 (values up to ~40). Observed
    3.8e-6; bound 3e-5."""
    f, n = 4, 2
    jsch, tsch, plan, tplan = _plan_pair(f, n, lookahead)
    q = plan.queue_length
    latents, cond = _rand((1, q, 3, 3, 4), 52), _rand((3, 3, 4), 53)
    masks = np.zeros((1, q, 3, 3, 1), np.float32)
    masks[:, :, 1:, :2] = 1.0
    key = jax.random.PRNGKey(54)
    jeps = lambda x, t: 0.1 * x + 1e-3 * t[:, :, None, None, None]
    ref = jfifo.fifo_step(jeps, jsch, plan, jmoca.MoCAConfig(), jnp.asarray(latents), key,
                          cond_image=jnp.asarray(cond), masks=jnp.asarray(masks),
                          masks_are_davis=False, gamma=0.5, with_pred_x0=True)
    keys = window_keys(key, plan.num_windows, f)
    port = tfifo.fifo_step(jeps, tsch, tplan, tmoca.MoCAConfig(), _t(latents),
                           JaxReplayNormal(lambda tag: keys(tag[2], tag[4])), ("i",),
                           cond_image=_t(cond), masks=_t(masks), masks_are_davis=False,
                           gamma=0.5, with_pred_x0=True)
    assert port[2].shape == (1, q, 3, 3, 4)
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=3e-5)


@pytest.mark.parametrize("seg_async", [False, True], ids=["lag1", "lag2"])
def test_open_vocab_matches_jax(models, jpipe, seg_async):  # noqa: F811
    """Prompt mode with a mask provider: the same provider calls (every
    low-t slot of every iteration, the drain included) return the same
    masks, placed at slot j - lag, and the frames match. Observed 2.5e-5 on
    frames in [-1, 1]; bound FRAME_ATOL (test_torch_slice)."""
    jmodel, tmodel = models
    key = jax.random.PRNGKey(55)
    total = NEW + F * N - F
    call = dict(cond_image=COND, gamma=0.6, height=H, width=W, target="cat")
    jpipe.seg_async = seg_async
    jseg_fn, jcalls = _segment_fn(every=4)
    ref = jpipe("a mouse", key, mask_provider=jseg.CallbackMaskProvider(jseg_fn), **call)
    tpipe = MoCAVideoPipeline(tmodel, HashTokenizer(), seg_async=seg_async, **KW)
    tseg_fn, tcalls = _segment_fn(every=4)
    port = tpipe("a mouse", normal=_replay(key, jpipe, total),
                 mask_provider=tseg.CallbackMaskProvider(tseg_fn), **call)
    assert len(tcalls) == len(jcalls) == total * tpipe._num_low_t_slots()
    assert sum(m is not None and m.any() for m in tcalls) > 0  # masks reach the queue
    for i, (a, b) in enumerate(zip(tcalls, jcalls)):
        assert (a is None) == (b is None), i
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f"call {i}")
    assert set(tpipe.timings) >= {"mask_provider", "fifo_iteration", "decode"}
    assert len(port) == len(ref) == total
    for i, (p, r) in enumerate(zip(port, ref)):
        np.testing.assert_allclose(p, np.asarray(r), atol=FRAME_ATOL, err_msg=f"frame {i}")


class Kill(Exception):
    pass


def _killer(at):
    def cb(i, frame):
        if i == at:
            raise Kill
    return cb


def _stateless_provider():
    return tseg.CallbackMaskProvider(lambda frame, target: (
        None if frame[:, :, 1].mean() > 140 else (frame[:, :, 0] > 127).astype(np.float32)))


@pytest.mark.parametrize("mode", ["prompt", "seg_async", "seg_sync", "davis"])
def test_resume_with_generator_equals_uninterrupted(models, tmp_path, mode):  # noqa: F811
    """A run killed after its third frame and resumed from the snapshot (the
    queue, masks, emitted frames, the provider's state and the generator's
    position) equals the uninterrupted run exactly, noise from the port's
    seeded GeneratorNormal."""
    _, tmodel = models
    pipe = MoCAVideoPipeline(tmodel, HashTokenizer(), checkpoint_every=2, decode_batch=1,
                             seg_async=mode != "seg_sync", **KW)
    call = dict(seed=56, cond_image=COND, gamma=0.5, height=H, width=W)
    if mode == "davis":
        frames, masks, _ = _davis_inputs()
        call.update(clean_latents=tmodel.encode_frames(frames[None]), masks=masks,
                    davis_frames=frames)
    provider = _stateless_provider if mode.startswith("seg") else (lambda: None)
    full = pipe("a mouse", latents_dir=str(tmp_path / "ref"), mask_provider=provider(), **call)
    run_dir = tmp_path / "run"
    with pytest.raises(Kill):
        pipe("a mouse", latents_dir=str(run_dir), frame_callback=_killer(2),
             mask_provider=provider(), **call)
    snap = np.load(run_dir / SNAPSHOT)
    assert int(snap["i"]) == 2 and len(snap["frames"]) == 2 and "normal_state" in snap
    if mode == "seg_async":
        assert {"seg_frame_counter", "seg_prev_mask", "seg_pending_pred"} <= set(snap.files)
    resumed = pipe("a mouse", latents_dir=str(run_dir), mask_provider=provider(), **call)
    np.testing.assert_array_equal(np.stack(resumed), np.stack(full))
    assert not (run_dir / SNAPSHOT).exists()


def test_resume_matches_jax(models, jpipe, tmp_path):  # noqa: F811
    """Open vocab, async: the killed and resumed port run against the JAX
    package's uninterrupted run (noise replayed by tag, so the snapshot
    needs no generator state). Observed 2.4e-5; bound FRAME_ATOL."""
    jmodel, tmodel = models
    key = jax.random.PRNGKey(57)
    total = NEW + F * N - F
    call = dict(cond_image=COND, gamma=0.5, height=H, width=W, target="cat")
    jpipe.seg_async = True
    ref = jpipe("a mouse", key, mask_provider=jseg.CallbackMaskProvider(
        _stateless_provider().segment_fn), **call)
    pipe = MoCAVideoPipeline(tmodel, HashTokenizer(), checkpoint_every=2, decode_batch=1, **KW)
    with pytest.raises(Kill):
        pipe("a mouse", normal=_replay(key, jpipe, total), latents_dir=str(tmp_path),
             frame_callback=_killer(2), mask_provider=_stateless_provider(), **call)
    normal = _replay(key, jpipe, total)
    resumed = pipe("a mouse", normal=normal, latents_dir=str(tmp_path),
                   mask_provider=_stateless_provider(), **call)
    assert min(t[1] for t in normal.tags if t[0] == "fifo") == 2  # resumed at iteration 2
    assert len(resumed) == len(ref) == total
    for i, (p, r) in enumerate(zip(resumed, ref)):
        np.testing.assert_allclose(p, np.asarray(r), atol=FRAME_ATOL, err_msg=f"frame {i}")


def test_base_latent_cache_matches_jax_and_hits(models, jpipe, tmp_path):  # noqa: F811
    """The base sample lands in `{steps}.npz` (latents, x_T) as the JAX
    package writes it, and a second run reads it instead of sampling.
    Observed 4.9e-6 of max |latent| after 8 guided steps; bound 1e-5 of it."""
    jmodel, tmodel = models
    key = jax.random.PRNGKey(58)
    total = NEW + F * N - F
    call = dict(cond_image=COND, conditioned_prompt="a dog", gamma=0.5, height=H, width=W)
    jpipe("a mouse", key, latents_dir=str(tmp_path / "jax"), **call)
    tpipe = MoCAVideoPipeline(tmodel, HashTokenizer(), **KW)
    first = tpipe("a mouse", normal=_replay(key, jpipe, total),
                  latents_dir=str(tmp_path / "port"), **call)
    name = f"{F * N}.npz"
    ref, port = np.load(tmp_path / "jax" / name), np.load(tmp_path / "port" / name)
    assert set(port.files) == set(ref.files) == {"latents", "x_T"}
    for k in ("latents", "x_T"):
        np.testing.assert_allclose(port[k], ref[k], rtol=0, atol=1e-5 * np.abs(ref[k]).max())
    normal = _replay(key, jpipe, total)
    second = tpipe("a mouse", normal=normal, latents_dir=str(tmp_path / "port"), **call)
    assert not any(t[0] == "base" for t in normal.tags)
    np.testing.assert_array_equal(np.stack(second), np.stack(first))


def test_multiprompts_matches_jax(models, jpipe):  # noqa: F811
    """Two scenes (1 and 2 frames) with the concept concat on each scene's
    context, switched at the frame boundary. Observed 1.1e-5; bound 1e-4."""
    jmodel, tmodel = models
    key = jax.random.PRNGKey(59)
    scenes = [("a red fox", 1), ("a blue bird", 2)]
    total = 3 + F * N - F
    call = dict(cond_image=COND, conditioned_prompt="a dog", gamma=0.5, height=H, width=W,
                multiprompts=scenes)
    ref = jpipe("a red fox", key, **call)
    tpipe = MoCAVideoPipeline(tmodel, HashTokenizer(), **KW)
    port = tpipe("a red fox", normal=_replay(key, jpipe, total), **call)
    assert len(port) == len(ref) == total
    for i, (p, r) in enumerate(zip(port, ref)):
        np.testing.assert_allclose(p, np.asarray(r), atol=1e-4, err_msg=f"frame {i}")
    single = tpipe("a red fox", normal=_replay(key, jpipe, total), **{
        **call, "multiprompts": [("a red fox", 3)]})
    assert np.abs(np.stack(single) - np.stack(port)).max() > 1e-4  # the switch is seen
