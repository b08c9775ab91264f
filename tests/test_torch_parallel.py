"""The port's mesh (parallel/mesh.py) on gloo ranks against the JAX mesh and
against the port's own unsharded runs.

Two and three ranks (processes spawned with a `file://` rendezvous under
tmp_path and a join timeout, `run_ranks`) run the tiny
model of test_torch_davis with its weights: the MoCA pipeline on a (1, 2)
mesh held to JAX's `MoCAVideoPipeline(mesh=make_mesh((1, 2)))` with the JAX
noise replayed (FRAME_ATOL, test_torch_slice); then a (2, 1) dp mesh with
B=2 prompts, 3 ranks on 16 rows (padded to 18), DAVIS mode, a run killed
mid-stream and resumed, the open-vocab provider (called on rank 0 only), and
the T2V pipeline with its rows tiling the ranks and not. Every rank must
return the same frames bit for bit, and those must equal, bit for bit, one
process computing the same row blocks in turn (`split_rows`): the gather's
order, the pad, the broadcast masks and rank 0's files add nothing. Against
the port's unsharded run the bound is FRAME_ATOL: the CPU's fp32 kernels
round differently at another batch size (the U-Net at 2 rows against 4,
in one process, moves the frames by up to 1.8e-5 on this model), the
same summation-order bound test_torch_slice uses.
"""

import contextlib
import multiprocessing
import os
import traceback

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from test_torch_davis import _davis_inputs, models  # noqa: F401  (fixture)
from test_torch_sampling import JaxReplayNormal, one_torch_thread, pipeline_keys  # noqa: F401
from test_torch_slice import CLIP, FRAME_ATOL, UNET, VAE, F, H, N, NEW, W

from moca_tpu.models.tokenizer import HashTokenizer as JHashTokenizer
from moca_tpu.parallel.mesh import make_mesh as jmake_mesh
from moca_tpu.pipelines.moca_video import MoCAVideoPipeline as JPipeline
from moca_tpu_torch.io.segmentation import CallbackMaskProvider
from moca_tpu_torch.models.clip_text import CLIPTextConfig
from moca_tpu_torch.models.latent_diffusion import LatentDiffusion
from moca_tpu_torch.models.tokenizer import HashTokenizer
from moca_tpu_torch.models.unet3d import UNetConfig
from moca_tpu_torch.models.vae import VAEConfig
from moca_tpu_torch.parallel.mesh import initialize_distributed, make_mesh, map_rows, shard_rows
from moca_tpu_torch.pipelines.moca_video import MoCAVideoPipeline
from moca_tpu_torch.pipelines.t2v import T2VPipeline

KW = dict(video_length=F, num_partitions=N, new_video_length=NEW, guidance_scale=7.5)
COND = np.random.default_rng(60).standard_normal((H // 8, W // 8, 4)).astype(np.float32)
MASKS = np.zeros((F, H // 8, W // 8), np.float32)
MASKS[:, 1:3, 1:4] = 1.0
SLICE_CALL = dict(prompt="a cat surfing", cond_image=COND, conditioned_prompt="a dog", gamma=0.7,
                  height=H, width=W, masks=MASKS)
ROW_SIZES = (16, 8, 2, 1)
# B=2 prompts: 16 U-Net rows on 3 ranks
IRREGULAR = ("irregular", (1, 3), KW, dict(prompt=["a cat", "a dog"], seed=66, cond_image=COND,
                                           gamma=0.6, height=H, width=W), {})


# --- the rank processes ---------------------------------------------------
# `run_ranks` spawns `world` processes that join one gloo group through a
# `file://` store (no TCP port to collide between test workers), each calling
# `fn(rank, out_dir, *args)` with a join timeout, and fails if a rank dies,
# hangs or exits non-zero. The scenario functions build the tiny port model
# from a saved state dict and write each rank's outputs as .npz under
# `out_dir`.

def _entry(rank, world, store, out_dir, fn, args):
    try:
        torch.set_num_threads(1)
        initialize_distributed(f"file://{store}", world, rank, backend="gloo")
        fn(rank, out_dir, *args)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"error_rank{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn, world: int, out_dir: str, *args, timeout: float = 120.0):
    """fn(rank, out_dir, *args) on `world` gloo ranks; raises unless every
    rank exits 0 within `timeout` seconds."""
    ctx = multiprocessing.get_context("spawn")
    store = os.path.join(out_dir, "store")
    procs = [ctx.Process(target=_entry, args=(r, world, store, out_dir, fn, args))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [open(os.path.join(out_dir, f)).read() for f in sorted(os.listdir(out_dir))
              if f.startswith("error_rank")]
    codes = [p.exitcode for p in procs]
    if hung or errors or any(codes):
        raise RuntimeError(f"ranks hung {hung}, exit codes {codes}\n" + "\n".join(errors))


def load_rank_outputs(out_dir: str, name: str, world: int):
    return [dict(np.load(os.path.join(out_dir, f"{name}_rank{r}.npz"))) for r in range(world)]


class TableNormal:
    """`normal(tag, shape)` replaying recorded draws by tag."""

    def __init__(self, table):
        self.table = table
        self.tags = []

    def __call__(self, tag, shape):
        self.tags.append(tag)
        draw = self.table[tag]
        assert draw.shape == tuple(shape), (tag, draw.shape, shape)
        return torch.from_numpy(draw.copy())


class Kill(Exception):
    pass


def build_model(spec):
    """The tiny port model from (unet, vae, clip config dicts, state dict path)."""
    unet, vae, clip, path = spec
    model = LatentDiffusion(UNetConfig(**unet), VAEConfig(**vae), CLIPTextConfig(**clip))
    model.load_state_dict(torch.load(path))
    return model.eval().requires_grad_(False)


def threshold_segment(log):
    """A deterministic stand-in detector that logs each call."""

    def seg(frame, target):
        log.append(target)
        if frame[:, :, 1].mean() > 140:
            return None
        return (frame[:, :, 0] > 127).astype(np.float32)

    return seg


def moca_runs(rank, out_dir, spec, runs):
    """Each run: (name, mesh shape, pipeline kwargs, call kwargs, options).
    Options: "table" replays recorded noise, else `seed`; "kill_at" kills the
    first call at that frame and resumes; "provider" adds the logging
    detector (its calls are saved)."""
    model = build_model(spec)
    for name, shape, pipe_kw, call_kw, opts in runs:
        mesh = make_mesh(shape)
        pipe = MoCAVideoPipeline(model, HashTokenizer(), mesh=mesh, **pipe_kw)
        call_kw = dict(call_kw)
        log = []
        if opts.get("provider"):
            call_kw["mask_provider"] = CallbackMaskProvider(threshold_segment(log))
        if "table" in opts:
            call_kw["normal"] = TableNormal(opts["table"])
        if "kill_at" in opts:
            call_kw["latents_dir"] = os.path.join(out_dir, name)

            def killer(i, frame, at=opts["kill_at"]):
                if i == at:
                    raise Kill

            try:
                pipe(frame_callback=killer, **call_kw)
            except Kill:
                pass
            else:
                raise AssertionError("the run was not killed")
            if "mask_provider" in call_kw:
                call_kw["mask_provider"] = CallbackMaskProvider(threshold_segment(log))
        frames = pipe(**call_kw)
        np.savez(os.path.join(out_dir, f"{name}_rank{rank}.npz"), frames=np.asarray(frames),
                 provider_calls=len(log), stages=sorted(pipe.timings))


def t2v_runs(rank, out_dir, spec, runs):
    """Each run: (name, mesh shape, T2VPipeline.build kwargs, call kwargs)."""
    model = build_model(spec)
    for name, shape, build_kw, call_kw in runs:
        pipe = T2VPipeline.build(model, HashTokenizer(), mesh=make_mesh(shape), **build_kw)
        video = pipe(**call_kw)
        np.savez(os.path.join(out_dir, f"{name}_rank{rank}.npz"), video=video.numpy())


def scenarios(rank, out_dir, spec, moca, t2v, sizes):
    """moca_runs, t2v_runs and mesh_rows in one set of ranks."""
    moca_runs(rank, out_dir, spec, moca)
    t2v_runs(rank, out_dir, spec, t2v)
    mesh_rows(rank, out_dir, sizes)


def mesh_rows(rank, out_dir, sizes):
    """shard_rows and map_rows on the flat mesh for each batch size."""
    mesh = make_mesh()
    out = {}
    for n in sizes:
        out[f"shard_{n}"] = np.asarray(shard_rows(mesh, n))
        x = torch.arange(n * 3, dtype=torch.float32).reshape(n, 3)
        out[f"map_{n}"] = map_rows(lambda a: a * 2 + 1, mesh, x).numpy()
        out[f"map_bf16_{n}"] = map_rows(lambda a: a.to(torch.bfloat16), mesh, x).float().numpy()
    np.savez(os.path.join(out_dir, f"rows_rank{rank}.npz"), **out)


# --- the tests ---------------------------------------------------------------

class Recording:
    """Wraps a `normal` and keeps every draw by tag."""

    def __init__(self, inner):
        self.inner, self.table = inner, {}

    def __call__(self, tag, shape):
        draw = self.inner(tag, shape)
        self.table[tag] = draw.numpy().copy()
        return draw


def _moca_runs(tmodel):
    """The 2-rank MoCA runs: (name, mesh, pipeline kwargs, call kwargs, options)
    and the unsharded port run of each."""
    frames, masks, cond = _davis_inputs()
    clean = tmodel.encode_frames(frames[None]).numpy()
    davis = dict(prompt="object bear cat.", seed=61, cond_image=cond, gamma=0.7, height=H,
                 width=W, clean_latents=clean, masks=masks, davis_frames=frames)
    common = dict(cond_image=COND, gamma=0.6, height=H, width=W)
    return [
        ("dp", (2, 1), KW, dict(prompt=["a cat", "a dog"], seed=62, **common), {}),
        ("davis", (1, 2), KW, davis, {}),
        ("resume", (1, 2), dict(KW, checkpoint_every=2, decode_batch=1),
         dict(prompt="a mouse", seed=63, target="cat", **common),
         {"kill_at": 2, "provider": True}),
        ("provider", (1, 2), dict(KW, seg_async=False),
         dict(prompt="a mouse", seed=64, target="cat", **common), {"provider": True}),
    ]


def _t2v_runs(world):
    build = dict(num_steps=3, guidance_scale=7.5)
    size = dict(height=H, width=W, frames=F)
    if world == 3:
        return [("t2v3_bs1", (1, 3), build, dict(prompt="a cat", seed=70, **size))]
    return [("t2v_bs2", (1, 2), build, dict(prompt=["a cat", "a dog"], seed=71, **size)),
            ("t2v_bs1", (1, 2), dict(build, temporal_cfg_scale=2.0),
             dict(prompt="a cat", seed=72, **size))]


@pytest.fixture(scope="module")
def spec(models, tmp_path_factory):  # noqa: F811
    path = tmp_path_factory.mktemp("weights") / "tiny.pt"
    torch.save(models[1].state_dict(), path)
    return UNET, VAE, CLIP, str(path)


@pytest.fixture(scope="module")
def jax_table(models):  # noqa: F811
    """(JAX frames on a (1, 2) mesh, the port's unsharded frames, the JAX
    noise the port drew, by tag)."""
    jmodel, tmodel = models
    jpipe = JPipeline(jmodel, JHashTokenizer(), mesh=jmake_mesh((1, 2), devices=jax.devices()[:2]),
                      **KW)
    key = jax.random.PRNGKey(65)
    call = {k: v for k, v in SLICE_CALL.items() if k != "prompt"}
    ref = jpipe("a cat surfing", key, **call)
    total = NEW + F * N - F
    normal = Recording(JaxReplayNormal(pipeline_keys(key, F * N, total, jpipe.plan.num_windows,
                                                     F)))
    plain = MoCAVideoPipeline(tmodel, HashTokenizer(), **KW)(normal=normal, **SLICE_CALL)
    return np.stack([np.asarray(r) for r in ref]), np.stack(plain), normal.table


@pytest.fixture(scope="module")
def ranks2(models, spec, jax_table, tmp_path_factory):  # noqa: F811
    out = str(tmp_path_factory.mktemp("ranks2"))
    moca = [("jax", (1, 2), KW, SLICE_CALL, {"table": jax_table[2]})] + _moca_runs(models[1])
    run_ranks(scenarios, 2, out, spec, moca, _t2v_runs(2), ROW_SIZES)
    return out


@pytest.fixture(scope="module")
def ranks3(spec, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ranks3"))
    run_ranks(scenarios, 3, out, spec, [IRREGULAR], _t2v_runs(3), ROW_SIZES)
    return out


def _ranks_agree(out, name, world, key="frames"):
    """Rank 0's output; every rank's must be the same bit for bit."""
    outs = load_rank_outputs(out, name, world)
    for r in range(1, world):
        np.testing.assert_array_equal(outs[r][key], outs[0][key], err_msg=f"rank {r}")
    return outs[0][key]


def _blocks(fn, k, *arrays):
    """fn over k blocks of ceil(n / k) rows in turn, the last padded with the
    last row (shard_rows' layout), the pad dropped."""
    n = arrays[0].shape[0]
    per = -(-n // k)
    padded = [torch.cat([a, a[-1:].expand((per * k - n,) + tuple(a.shape[1:]))]) for a in arrays]
    return torch.cat([fn(*(p[i * per:(i + 1) * per] for p in padded)) for i in range(k)])[:n]


@contextlib.contextmanager
def split_rows(model, k, whole=(), decoder="decode_single"):
    """The model's U-Net and the pipeline's decoder (MoCA's head decode, or
    T2V's `decode_latents`) computing the row blocks k ranks would, in this
    one process: the decoder where its rows tile k, the U-Net but for
    batches of `whole` rows (the T2V calls that do not tile the mesh)."""
    apply_unet, decode = model.apply_unet, getattr(model, decoder)

    def unet(x, t, c, fps=16, **kw):
        if x.shape[0] in whole:
            return apply_unet(x, t, c, fps, **kw)
        return _blocks(lambda a, b, d: apply_unet(a, b, d, fps, **kw), k, x, t, c)

    model.apply_unet = unet
    setattr(model, decoder, lambda z: decode(z) if z.shape[0] % k else _blocks(decode, k, z))
    try:
        yield
    finally:
        delattr(model, "apply_unet")
        delattr(model, decoder)


def _moca(tmodel, pipe_kw, call_kw, provider_log=None):
    call_kw = dict(call_kw)
    if provider_log is not None:
        call_kw["mask_provider"] = CallbackMaskProvider(threshold_segment(provider_log))
    return np.asarray(MoCAVideoPipeline(tmodel, HashTokenizer(), **pipe_kw)(**call_kw))


def _hold(port, tmodel, k, run, **split):
    """port against run() unsharded (FRAME_ATOL) and run() on k row blocks in
    this process (exact)."""
    plain = run()
    with split_rows(tmodel, k, **split):
        blocks = run()
    assert port.shape == plain.shape and np.isfinite(port).all()
    np.testing.assert_array_equal(port, blocks)
    np.testing.assert_allclose(port, plain, atol=FRAME_ATOL)
    return plain


def test_make_mesh_and_shard_rows_one_rank():
    """make_mesh's default and its shape check (the JAX message), shard_rows
    on one rank, in a one-rank gloo group of this process."""
    initialize_distributed(num_processes=1, backend="gloo")
    try:
        mesh = make_mesh()
        assert mesh.shape == (1, 1) and mesh.mesh_dim_names == ("dp", "fifo")
        assert shard_rows(mesh, 5) == (0, 5)
        with pytest.raises(AssertionError, match=r"mesh \(1, 2\) != 1 devices"):
            make_mesh((1, 2))
        with pytest.raises(AssertionError, match=rf"mesh \(1, 3\) != {len(jax.devices())} devices"):
            jmake_mesh((1, 3))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("world", [2, 3])
def test_shard_rows_padding_and_gather_order(ranks2, ranks3, world):
    """Blocks of ceil(n / size) rows in rank order over the padded batch;
    map_rows returns fn of every row in order (the pad dropped), in fp32 and
    bf16, on every rank."""
    out = {2: ranks2, 3: ranks3}[world]
    rows = load_rank_outputs(out, "rows", world)
    for n in ROW_SIZES:
        per = -(-n // world)
        assert [tuple(r[f"shard_{n}"]) for r in rows] == [(k * per, (k + 1) * per)
                                                          for k in range(world)]
        x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
        for r in rows:
            np.testing.assert_array_equal(r[f"map_{n}"], x * 2 + 1)
            np.testing.assert_array_equal(r[f"map_bf16_{n}"], x)  # small integers: exact in bf16


def test_sharded_moca_matches_jax_mesh_and_unsharded(models, ranks2, jax_table):  # noqa: F811
    """2 gloo ranks, each computing 4 of the 8 U-Net rows, against JAX's
    (1, 2) mesh and the port's unsharded run, on the same noise."""
    jref, _, table = jax_table
    port = _ranks_agree(ranks2, "jax", 2)
    assert port.shape == (NEW + F * N - F, H, W, 3)
    np.testing.assert_allclose(port, jref, atol=FRAME_ATOL)
    _hold(port, models[1], 2, lambda: _moca(models[1], KW, dict(SLICE_CALL,
                                                                normal=TableNormal(table))))
    assert np.abs(jref[0] - jref[-1]).max() > 1e-2


@pytest.mark.parametrize("name", ["dp", "davis", "resume", "provider"])
def test_sharded_moca_modes_match_unsharded(models, ranks2, name):  # noqa: F811
    """A (2, 1) dp mesh with B=2 prompts, DAVIS mode, a run killed at its
    third frame and resumed from rank 0's snapshot, and the open-vocab
    provider at lag 1, each against the port's unsharded run. The provider
    runs on rank 0 only, as often as in the unsharded run."""
    _, tmodel = models
    _, _, pipe_kw, call_kw, opts = next(r for r in _moca_runs(tmodel) if r[0] == name)
    log = [] if opts.get("provider") else None
    port = _ranks_agree(ranks2, name, 2)
    _hold(port, tmodel, 2, lambda: _moca(tmodel, pipe_kw, call_kw, log))
    outs = load_rank_outputs(ranks2, name, 2)
    if log is not None:
        calls = [int(o["provider_calls"]) for o in outs]
        assert calls[1] == 0 and calls[0] >= len(log) // 2 > 0, calls
    if name == "resume":
        assert not os.path.exists(os.path.join(ranks2, name, "fifo_state.npz"))


def test_three_ranks_irregular_rows(models, ranks3):  # noqa: F811
    """3 ranks on the 16-row batch of B=2 prompts (blocks of 6, the last
    padded with 2 repeated rows); the 8-row decode does not tile 3 ranks and
    runs whole on each."""
    _, tmodel = models
    port = _ranks_agree(ranks3, "irregular", 3)
    assert port.shape == (2, NEW + F * N - F, H, W, 3)
    # the base sample's 4 CFG rows take the T2V path's skip
    _hold(port, tmodel, 3, lambda: _moca(tmodel, IRREGULAR[2], IRREGULAR[3]), whole={4})


@pytest.mark.parametrize("world,name", [(2, "t2v_bs2"), (2, "t2v_bs1"), (3, "t2v3_bs1")])
def test_sharded_t2v_matches_unsharded(models, ranks2, ranks3, world, name):  # noqa: F811
    """T2V with the mesh: --bs 2 on 2 ranks (4 CFG rows and 8 decode rows
    tile the mesh); --bs 1 on 2 ranks with temporal guidance (the CFG call
    tiles, its two 1-row calls take the skip path); --bs 1 on 3 ranks (2 rows
    and 4 decode rows skip)."""
    _, tmodel = models
    _, _, build, call = next(r for r in _t2v_runs(world) if r[0] == name)
    port = _ranks_agree({2: ranks2, 3: ranks3}[world], name, world, key="video")
    _hold(port, tmodel, world,
          lambda: T2VPipeline.build(tmodel, HashTokenizer(), **build)(**call).numpy(),
          whole={n for n in (1, 2, 4) if n % world}, decoder="decode_latents")

