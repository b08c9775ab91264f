"""MoCA's one-launch window step (moca_tpu_torch/ops/moca_scan.py) on the CPU.

The kernel (csrc/moca_scan.cu) runs only on a card, where
tests/test_torch_cuda.py holds its output to the per-window loop it stands
for (sampling/fifo.py `_moca_window_loop`, `moca_window_step` for each
window) in every branch. Here its inputs and its plan are held to that
loop: the frame table against the scalars the loop computes, the slot table
against the write-back's tiling, the thread walk, the tables kept with the
plan, and the wrapper's refusals. Then the routing: CPU tensors take the
loop unchanged and launch nothing, and the kernel route draws the loop's
noise under the loop's tags in the loop's order.
"""

import numpy as np
import pytest
import torch

from moca_tpu_torch.ops import cuda_libs
from moca_tpu_torch.ops import moca_scan as tms
from moca_tpu_torch.sampling import fifo as tfifo
from moca_tpu_torch.sampling import moca as tmoca
from moca_tpu_torch.sampling.ddim import GeneratorNormal
from moca_tpu_torch.schedule import make_schedule

# (f, n, lookahead): the stream cell's plan, a small one, and no lookahead
PLANS = [(16, 4, True), (4, 2, True), (6, 3, False)]
BRANCHES = ["no_masks", "davis", "seg", "davis_no_cond", "inject_into_queue"]


def _plan(f, n, lookahead):
    sch = make_schedule(f * n, device="cpu")
    return sch, tfifo.make_fifo_plan(sch.ddim_timesteps_np, f, n, lookahead)


# the reference's settings, and others for every scalar the table carries
SETTINGS = {"default": {}, "other": dict(correction_gain=0.75, inject_threshold=600,
                                         davis_enhancement=1.25, seg_enhancement=3.0)}


@pytest.mark.parametrize("setting", SETTINGS)
@pytest.mark.parametrize("have_masks", [True, False], ids=["masks", "no_masks"])
@pytest.mark.parametrize("davis", [True, False], ids=["davis", "seg"])
@pytest.mark.parametrize("f,n,lookahead", PLANS, ids=lambda v: str(v))
def test_frame_table_matches_the_loops_scalars(f, n, lookahead, davis, have_masks, setting):
    """Every (r, j): the scalars `moca_window_step` computes, its expressions
    evaluated on the schedule's tensors as it evaluates them, bit for bit;
    the flags and factors of its branches, with timesteps on both sides of
    the injection threshold."""
    sch, plan = _plan(f, n, lookahead)
    cfg = tmoca.MoCAConfig(**SETTINGS[setting])
    w_idx, w_ts = plan.window_indices(), plan.window_timesteps()
    assert (w_ts <= cfg.inject_threshold).any() and (w_ts > cfg.inject_threshold).any()
    table = tmoca.moca_frame_table(sch, cfg, w_idx, w_ts, davis, have_masks)
    assert table.shape == (plan.num_windows, f, len(tms.TABLE_COLUMNS))
    assert table.dtype == np.float32
    col = {name: table[..., i] for i, name in enumerate(tms.TABLE_COLUMNS)}
    enh = cfg.davis_enhancement if davis else cfg.seg_enhancement
    for r in range(plan.num_windows):
        for j in range(f):
            idx, t_i = int(w_idx[r, j]), int(w_ts[r, j])
            a_t, a_prev = sch.ddim_alphas[idx], sch.ddim_alphas_prev[idx]
            sigma, sqrt_1ma = sch.ddim_sigmas[idx], sch.ddim_sqrt_one_minus_alphas[idx]
            strength = cfg.correction_gain * (1.0 - np.float32(t_i) / np.float32(1000.0))
            want = {"sqrt_one_minus_alpha": sqrt_1ma, "sqrt_alpha": torch.sqrt(a_t),
                    "dir_coef": torch.sqrt(torch.clamp(1.0 - a_prev - sigma**2, min=0.0)),
                    "sqrt_alpha_prev": torch.sqrt(a_prev), "sigma": sigma,
                    "strength": torch.tensor(float(strength), dtype=torch.float32)}
            for name, value in want.items():
                assert col[name][r, j] == value.item(), (name, r, j)
            below = t_i <= cfg.inject_threshold
            assert col["momentum"][r, j] == (j > 0)
            assert col["factor"][r, j] == np.float32(enh if below or not davis else 1.0)
            assert col["inject"][r, j] == (have_masks and (davis or below))
    off = tmoca.MoCAConfig(**SETTINGS[setting], enable_momentum=False, enable_injection=False)
    table = tmoca.moca_frame_table(sch, off, w_idx, w_ts, davis, have_masks)
    assert not table[..., tms.TABLE_COLUMNS.index("momentum")].any()
    assert not table[..., tms.TABLE_COLUMNS.index("inject")].any()


@pytest.mark.parametrize("f,n,lookahead", PLANS + [(2, 1, True), (16, 1, False)],
                         ids=lambda v: str(v))
def test_scan_slots_tile_the_write_back(f, n, lookahead):
    """The slot table, applied as the kernel applies it, writes each queue
    slot exactly once: the new queue `_scatter_windows` builds from the
    windows' outputs and the pred_x0 `scatter_pred_x0` builds; frame j of
    window r reads the slot the window's gather reads."""
    _, plan = _plan(f, n, lookahead)
    R, Q = plan.num_windows, plan.queue_length
    slots = plan.scan_slots()
    assert slots.shape == (R, f, len(tms.SLOT_COLUMNS)) and slots.dtype == np.int32
    src, dst, keep = (slots[..., i] for i in range(3))
    old = -1.0 - torch.arange(Q, dtype=torch.float32).reshape(1, Q, 1)  # slot q holds -1 - q
    windows = tfifo._gather_windows(old, plan)[:, 0, :, 0]
    assert (windows.numpy() == -1.0 - src).all()
    label = torch.arange(R * f, dtype=torch.float32).reshape(R, 1, f, 1)  # frame (r, j): r*f + j
    want_queue = tfifo._scatter_windows(old, label, plan)[0, :, 0].numpy()
    want_pred = tfifo.scatter_pred_x0(label, plan)[0, :, 0].numpy()
    queue, pred, writes = np.full(Q, np.nan), np.full(Q, np.nan), np.zeros(Q, int)
    for r in range(R):
        for j in range(f):
            if dst[r, j] >= 0:
                writes[dst[r, j]] += 1
                queue[dst[r, j]] = -1.0 - src[r, j] if keep[r, j] else r * f + j
                pred[dst[r, j]] = r * f + j
    assert (writes == 1).all()
    assert (queue == want_queue).all() and (pred == want_pred).all()
    assert keep.sum() == (f // 2 if lookahead else 0)


def _walk(R, B, frame, vec, threads, blocks):
    """The kernel's thread walk (`moca_scan_rows`): thread t < R * B * nv
    takes vector t % nv of (r, b) = divmod(t / nv, B); returns the (r, b,
    first value) of every thread that works."""
    nv = frame // vec
    seen = []
    for t in range(threads * blocks):
        if t >= R * B * nv:
            continue
        rb = t // nv
        seen.append((rb // B, rb % B, (t - rb * nv) * vec))
    return seen


@pytest.mark.parametrize("R,B,frame,vec", [(8, 1, 40 * 64 * 4, 4), (8, 2, 40 * 64 * 4, 4),
                                           (4, 1, 40 * 64 * 4, 1), (2, 2, 3 * 5 * 3, 1),
                                           (6, 1, 4 * 4 * 4, 4), (1, 3, 7, 1)])
def test_scan_walk_reaches_every_vector_once(R, B, frame, vec):
    """Every (window, batch row, vector) once, on the plan's grid, whose last
    block is the only one with idle threads."""
    threads, blocks = tms.scan_plan(R, B, frame, vec)
    assert threads == tms.SCAN_THREADS and threads % 32 == 0
    total = R * B * frame // vec
    assert (blocks - 1) * threads < total <= blocks * threads
    seen = _walk(R, B, frame, vec, threads, blocks)
    want = [(r, b, v * vec) for r in range(R) for b in range(B) for v in range(frame // vec)]
    assert sorted(seen) == want


def test_scan_vector_width():
    """Four values a thread where a frame is whole vectors and every pointer
    16-byte aligned (the U-Net's C = 4 latents), else one; the plan refuses
    a frame the vectors do not divide."""
    assert cuda_libs.vector(4, 40 * 64 * 4, 0, 4096, 8192) == 4
    assert cuda_libs.vector(4, 40 * 64 * 4, 0, 4100) == 1
    assert cuda_libs.vector(4, 3 * 5 * 3, 0) == 1
    with pytest.raises(ValueError, match="whole vectors"):
        tms.scan_plan(8, 1, 45, 4)


def _inputs(branch, f, n, lookahead, B, hwc=(3, 5, 4), seed=0):
    """(schedule, plan, cfg, queue, eps, noise, cond, masks) on the CPU, the
    branches of tests/test_torch_sampling.py's `test_moca_window_step_matches`;
    the masks leave some slots empty and give one slot values that sum to 0
    with pixels above 0.5 (the gate shuts it)."""
    sch, plan = _plan(f, n, lookahead)
    cfg = tmoca.MoCAConfig(inject_into_queue=branch == "inject_into_queue")
    gen = torch.Generator().manual_seed(seed)
    Q, R = plan.queue_length, plan.num_windows
    queue = torch.randn((B, Q) + hwc, generator=gen)
    eps = torch.randn((R, B, f) + hwc, generator=gen)
    noise = torch.randn((R, f) + hwc, generator=gen)
    cond = (None if branch in ("no_masks", "davis_no_cond")
            else torch.rand(hwc, generator=gen))
    masks = None
    if branch != "no_masks":
        h, w = hwc[:2]
        masks = torch.zeros((1, Q, h, w, 1))
        masks[:, :, 1:, 2:] = 1.0
        masks[:, 2::5] = 0.0
        masks[:, 2, 0, 0], masks[:, 2, 1, 1] = 1.0, -1.0
    return sch, plan, cfg, queue, eps, noise, cond, masks


@pytest.mark.parametrize("with_pred", [False, True], ids=["queue", "pred"])
@pytest.mark.parametrize("branch", BRANCHES)
def test_fifo_step_on_cpu_takes_the_loop(branch, with_pred, monkeypatch):
    """CPU tensors: the per-window loop and the write-back's concatenation, as
    before the kernel (the same code inline), bit for bit, in each branch of
    the loop; no launch, no table built."""
    sch, plan, cfg, queue, eps, _, cond, masks = _inputs(branch, 4, 2, True, 1)
    davis = branch != "seg"

    def refuse(*args, **kwargs):
        raise AssertionError("the kernel route ran on CPU tensors")

    monkeypatch.setattr(tfifo, "moca_scan", refuse)
    monkeypatch.setattr(tfifo, "scan_tables", refuse)
    eps_fn = lambda x, t: eps.reshape(x.shape)  # noqa: E731
    cuda_libs.reset_launch_counts()
    out = tfifo.fifo_step(eps_fn, sch, plan, cfg, queue, GeneratorNormal(3, "cpu"), ("i",),
                          cond_image=cond, masks=masks, masks_are_davis=davis, gamma=0.5,
                          with_pred_x0=with_pred)
    assert tms.moca_scan.launches == {} and plan.tables == {}
    normal, windows = GeneratorNormal(3, "cpu"), tfifo._gather_windows(queue, plan)
    w_masks = None if masks is None else tfifo._gather_windows(masks, plan)
    x_prev, pred = [], []
    for r in range(plan.num_windows):
        step = tmoca.moca_window_step(
            sch, cfg, windows[r], eps[r], plan.window_indices()[r], plan.window_timesteps()[r],
            normal, ("i", "win", r), cond_image=cond,
            masks=None if w_masks is None else w_masks[r], masks_are_davis=davis, gamma=0.5,
            with_preinject=True)
        x_prev.append(step[0])
        pred.append(step[2])
    want = tfifo._scatter_windows(queue, x_prev, plan)
    assert len(out) == (3 if with_pred else 2)
    assert torch.equal(out[0], want) and torch.equal(out[1], want[:, plan.head_slot])
    if with_pred:
        assert torch.equal(out[2], tfifo.scatter_pred_x0(pred, plan))


class RecordingNormal(GeneratorNormal):
    def __init__(self, seed):
        super().__init__(seed, "cpu")
        self.calls = []

    def __call__(self, tag, shape):
        self.calls.append((tag, tuple(shape)))
        return super().__call__(tag, shape)


@pytest.mark.parametrize("f,n,lookahead", PLANS, ids=lambda v: str(v))
def test_kernel_route_draws_the_loops_noise(f, n, lookahead):
    """`draw_window_noise` names the loop's draws, shapes and order, and a
    seeded generator gives it the loop's numbers: frame j of window r of
    the stack is the noise of that frame's step."""
    sch, plan = _plan(f, n, lookahead)
    hwc = (3, 5, 4)
    queue = torch.randn((1, plan.queue_length) + hwc)
    eps = torch.randn((plan.num_windows, 1, f) + hwc)
    loop_normal, scan_normal = RecordingNormal(5), RecordingNormal(5)
    windows = tfifo._gather_windows(queue, plan)
    tfifo._moca_window_loop(sch, plan, tmoca.MoCAConfig(), queue, windows, eps, loop_normal,
                            ("fifo", 7), None, None, True, None, False)
    noise = tfifo.draw_window_noise(scan_normal, ("fifo", 7), plan, hwc, "cpu")
    assert scan_normal.calls == loop_normal.calls
    assert [c[0] for c in scan_normal.calls] == [
        ("fifo", 7, "win", r, "frame", j) for r in range(plan.num_windows) for j in range(f)]
    assert noise.shape == (plan.num_windows, f) + hwc and noise.dtype == torch.float32
    replay = GeneratorNormal(5, "cpu")
    for r in range(plan.num_windows):
        for j in range(f):
            assert torch.equal(noise[r, j], replay(("fifo", 7, "win", r, "frame", j),
                                                   (1,) + hwc)[0])


@pytest.mark.parametrize("have_masks", [True, False], ids=["masks", "no_masks"])
@pytest.mark.parametrize("davis", [True, False], ids=["davis", "seg"])
def test_scan_tables_are_kept_with_the_plan(davis, have_masks):
    """The frame and slot tables for a (schedule, settings, device) are built
    once, kept in the plan's `tables` and found again; another schedule
    object, setting or plan builds its own."""
    sch, plan = _plan(4, 2, True)
    cfg = tmoca.MoCAConfig()
    first = tfifo.scan_tables(sch, plan, cfg, davis, have_masks, "cpu")
    again = tfifo.scan_tables(sch, plan, cfg, davis, have_masks, "cpu")
    assert again[0] is first[0] and again[1] is first[1] and len(plan.tables) == 1
    other, other_plan = _plan(4, 2, True)
    assert tfifo.scan_tables(other, plan, cfg, davis, have_masks, "cpu")[0] is not first[0]
    assert tfifo.scan_tables(sch, plan, cfg, not davis, have_masks, "cpu")[0] is not first[0]
    assert tfifo.scan_tables(sch, other_plan, cfg, davis, have_masks, "cpu")[0] is not first[0]
    assert len(plan.tables) == 3 and len(other_plan.tables) == 1
    assert "tables" not in repr(plan)
    want = tmoca.moca_frame_table(sch, cfg, plan.window_indices(),
                                  plan.window_timesteps(), davis, have_masks)
    assert np.array_equal(first[0].numpy(), want)
    assert np.array_equal(first[1].numpy(), plan.scan_slots())


def test_moca_scan_stays_out_of_the_attention_tally():
    """The benchmark's `attn_roofline` reads K1-K4's tallies alone; the scan
    is registered with the others and built from its own library."""
    from moca_tpu_torch.ops import flash_attention as tfa

    assert tms.moca_scan not in tfa.KERNELS and tms.moca_scan in cuda_libs.TALLIED
    lib = cuda_libs.LIBRARIES["moca_scan"]
    assert lib.sources == ("moca_scan.cu",) and "moca_scan" in lib.entries


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_moca_scan_refuses_cpu_tensors(dtype):
    """The wrapper takes a float32 queue on a CUDA device and nothing else:
    the error names what it takes."""
    sch, plan, cfg, queue, eps, noise, _, _ = _inputs("no_masks", 4, 2, True, 1)
    table, slots = tfifo.scan_tables(sch, plan, cfg, True, False, "cpu")
    with pytest.raises(ValueError, match="must be float32 on a CUDA device"):
        tms.moca_scan(queue.to(dtype), eps, noise, table, slots, beta=cfg.beta,
                      dir_weight=cfg.dir_weight)
