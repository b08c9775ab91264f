"""MoCA on a real clip (DAVIS mode): one stream, closed loop.

Set-up, as `cli/main.py --use_davis` runs it: the model from the seed's
weights; a clip of `davis_frames` frames and its masks, a concept-image
latent and a prompt row, all from the seed; the clip encoded once with
`encode_frames`; then `MoCAVideoPipeline.__call__` in DAVIS mode
(clean_latents, masks, davis_frames), with the row's conditioned prompt
and gamma. Every frame reaches the benchmark through `frame_callback`,
a flush of `decode_batch` frames at a time. The first `warmup_flushes`
flushes are set-up; the window opens when they are delivered and closes
at the first flush delivered `--seconds` or more later, from inside the
callback, which ends the call.

Check, after the window, against the float32 reference: the encoded clip
(all frames); the text contexts the call encoded (the prompt, the
conditioned prompt and the empty prompt); `check.iterations` FIFO
iterations of the window drawn by the seed (among the two a flush whose
states the run keeps, at positions drawn by the seed), each from the
program's own queue: the update of the slots that the iteration commits
(the new tail slot, a fresh draw mixed with the DAVIS anchor, is not
compared: see PERF.md); and every frame delivered in the window, decoded
by the reference from the program's head latent.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import common, flops, program, trace
from benchmark.reference import build, control as make_control, meta_model
from benchmark.reference import diffusion as rd


def inputs(cell: common.Cell):
    """(frames [T0, H, W, 3] in [-1, 1] on the device, masks [T0, h, w]
    numpy, concept latent [h, w, 4] numpy, prompt row)."""
    t, seed, dev = cell.traffic, cell.seed, cell.device
    H, W, T0 = t["height"], t["width"], t["davis_frames"]
    h, w = H // 8, W // 8
    frames = common.uniform(seed, "frames", (T0, H, W, 3), dev)
    rng = np.random.default_rng(common.derived_seed(seed, "masks"))
    mh, mw = t["mask"]["height"], t["mask"]["width"]
    top, left = rng.integers(0, h - mh + 1), rng.integers(0, w - mw + 1)
    masks = np.zeros((T0, h, w), np.float32)
    for f in range(T0):  # the box moves one latent pixel a frame, wrapping
        x0 = (left + f) % (w - mw + 1)
        masks[f, top:top + mh, x0:x0 + mw] = 1.0
    cond = common.uniform(seed, "concept", (h, w, 4), "cpu", 0.0, 1.0).numpy()
    rows = t["prompts"]
    row = rows[common.sample(seed, "prompt", range(len(rows)), 1)[0]]
    return frames, masks, cond, row


def run(cell: common.Cell) -> common.Outcome:
    from moca_tpu_torch.pipelines.moca_video import MoCAVideoPipeline

    t, dev = cell.traffic, cell.device
    model = program.build_model(cell.config, common.seed_weights(cell))
    frames, masks, cond, row = inputs(cell)
    normal = common.SeededNormal(cell.seed, dev)
    clean = model.encode_frames(frames[None], normal)
    pipe = MoCAVideoPipeline(
        model, program.tokenizer(), video_length=t["video_length"],
        num_partitions=t["num_partitions"], new_video_length=t["new_video_length"],
        guidance_scale=t["guidance_scale"], eta=t["eta"], fps=t["fps"],
        lookahead_denoising=t["lookahead"], decode_batch=t["decode_batch"])

    text_rows = []  # every text context the call encodes, a row each
    encode_tokens = model.encode_tokens

    def encoded(tokens):
        out = encode_tokens(tokens)
        text_rows.extend(out.detach().float().clone())
        return out
    model.encode_tokens = encoded

    spans = trace.Spans(cell.trace)
    spans.wrap(model, "apply_unet", "unet")
    spans.wrap(model, "decode_single", "vae.decode")
    spans.wrap(pipe, "_fifo_iteration", "fifo.iteration")
    flush = t["decode_batch"]
    warm = t["warmup_flushes"] * flush
    keep = common.sample(cell.seed, "kept iterations", range(flush), 2)
    states, heads = {}, {}
    iterate = pipe._fifo_iteration
    count = {"iterations": 0}  # the iteration's index: a frame a call, from frame 0

    def kept(latents, *args, **kwargs):
        i = count["iterations"]
        before = latents.clone() if i >= warm and i % flush in keep else None
        out = iterate(latents, *args, **kwargs)
        count["iterations"] += 1
        if i >= warm:
            heads[i] = out[1].clone()
            if before is not None:
                states[i] = (before, out[0].clone())
        return out
    pipe._fifo_iteration = kept

    window = common.Window(cell.seconds)
    profiler = trace.Profiler() if cell.trace else None
    delivered = {}

    def on_frame(n, frame):
        if n >= warm:
            delivered[n] = frame
        if (n + 1) % flush:
            return
        if n + 1 == warm:
            if profiler:
                profiler.start()
            program.reset_launches()
            window.open()
            return
        if n + 1 > warm and window.after(n + 1 - warm, time.perf_counter()):
            raise common.WindowClosed

    try:
        pipe(row["prompt"], normal=normal, cond_image=cond,
             conditioned_prompt=row["conditioned_prompt"], gamma=row["gamma"],
             height=t["height"], width=t["width"], clean_latents=clean, masks=masks,
             davis_frames=frames, frame_callback=on_frame)
        raise RuntimeError("the stream ended before the window closed: raise new_video_length")
    except common.WindowClosed:
        pass
    launched = program.launches()
    if profiler:
        profiler.stop()
    peak = common.peak_bytes(dev)
    unet_calls = window.units  # one CFG-fused U-Net call an iteration, an iteration a frame
    del pipe, model
    common.release(dev)

    view = None
    if profiler:
        rows = 2 * 2 * t["num_partitions"]  # windows x CFG
        ctx_len = 2 * rd.CONTEXT_LENGTH
        counted = unet_vae_flops(cell, rows, t["video_length"], ctx_len, flush)
        view = profiler.view(launched, {"unet": counted["unet"] * unet_calls,
                                        "vae": counted["vae"] * window.units / flush},
                             {"units": window.units, "decoded_frames": window.units})
    checked = check(cell, frames, row, clean, states, heads, delivered, text_rows,
                    control=cell.control)
    values = checked["program"]
    return common.Outcome(
        window=window, peak_bytes=peak, view=view,
        end_to_end={"s_per_frame": (window.per_unit, "s/frame")},
        readings=common.readings_of(values, cell.limits),
        failed=sum(v > cell.limits["frames"]["limit"] for v in values["frames"]),
        control=checked.get("control"),
        diagnostics={"values": values, "cond_move": checked["cond_move"]})


def unet_vae_flops(cell, rows, f, ctx_len, decode_rows) -> dict:
    """Model FLOPs of one U-Net call at `rows` rows and of one decode call."""
    t = cell.traffic
    h, w = t["height"] // 8, t["width"] // 8
    m = meta_model(cell.config)
    with torch.device("meta"):
        x = torch.empty(rows, f, h, w, 4)
        ts = torch.zeros(rows, f, dtype=torch.long)
        ctx = torch.empty(rows, ctx_len, cell.config["unet"]["context_dim"])
        z = torch.empty(decode_rows, h, w, 4)
        return {"unet": flops.count_flops(m.unet, x, ts, ctx, t["fps"]),
                "vae": flops.count_flops(m.decode, z)}


@torch.inference_mode()
def check(cell, frames, row, clean, states, heads, delivered, text_rows,
          control: bool = False):
    """{number: [values]} of the program against the float32 reference, and
    with `control`, also of the control: the reference in the type below the
    served one, put in the program's place (fed the same program states)."""
    dev = cell.device
    normal = common.SeededNormal(cell.seed, dev)
    with common.exact_float32():
        m = build(cell.config, common.seed_weights(cell))
        ref = stages(cell, m, frames, row, states, heads, normal)
        # the program's queue after the shift: slot j holds the new queue's slot j + 1
        program_side = {"clean": clean[0], "text_rows": text_rows,
                        "iterations": {i: states[i][1][:, :-1] for i in states},
                        "frames": {n: torch.as_tensor(delivered[n], device=dev)
                                   for n in ref["frames"]}}
        out = {"program": compare(program_side, ref, states), "cond_move": ref["cond_move"]}
        if control:
            ctl = stages(cell, make_control(m, cell.config), frames, row, states, heads, normal)
            ctl["text_rows"] = list(ctl["texts"].values())
            out["control"] = compare(ctl, ref, states)
    return out


def compare(side: dict, ref: dict, states: dict) -> dict:
    """Each number the error of what a network adds, relative to what it
    adds: the encoded clip beside the posterior's unit noise, the text
    contexts whole, the queue's update beside the same update with eps = 0,
    the frames whole."""
    values = {"encode": [common.rel_l2(side["clean"], ref["clean"],
                                       base=ref["posterior_noise"])],
              "text_context": common.text_context(side["text_rows"], ref["texts"]), "iteration": []}
    for i, ref_out in ref["iterations"].items():
        values["iteration"].append(common.rel_l2(side["iterations"][i], ref_out,
                                                 base=ref["without_eps"][i]))
    values["frames"] = [common.rel_l2(side["frames"][n], ref["frames"][n])
                        for n in sorted(ref["frames"])]
    return values


def stages(cell, m, frames, row, states, heads, normal) -> dict:
    """The reference's encoded clip, FIFO iterations before their shift (from
    the program's queue states) and frames (from the program's head latents)."""
    t, dev = cell.traffic, cell.device
    sf = cell.config["diffusion"]["scale_factor"]
    T0, h, w = frames.shape[0], t["height"] // 8, t["width"] // 8
    chunk = t["check"]["vae_rows"]
    noise = normal(("encode",), (T0, h, w, 4))
    clean = []
    for i in range(0, T0, chunk):
        mean, logvar = m.vae.moments(frames[i:i + chunk])
        clean.append(sf * rd.posterior_sample(mean, logvar, noise[i:i + chunk]))
    clean = torch.cat(clean)

    sch = rd.Schedule(t["video_length"] * t["num_partitions"], t["eta"],
                      cell.config["diffusion"], dev)
    queue = rd.Queue(sch, t["video_length"], t["num_partitions"], t["lookahead"])
    encode = lambda texts: m.clip(torch.as_tensor(rd.hash_tokens(texts), device=dev))
    texts = {text: encode([text])[0] for text in (row["prompt"], row["conditioned_prompt"], "")}
    ctx = torch.cat([texts[row["prompt"]], texts[row["conditioned_prompt"]]])[None]
    uc = torch.cat([texts[""]] * 2)[None]
    iterations, without_eps, moves = {}, {}, []
    for i in common.sample(cell.seed, "checked iterations", sorted(states),
                           t["check"]["iterations"]):
        new, new0 = fifo_iteration(cell, m, sch, queue, states[i][0], ctx, uc, normal, i,
                                   moves)
        iterations[i], without_eps[i] = new[:, 1:], new0[:, 1:]  # the slots that stay
    decoded = {}
    order = sorted(heads)
    for k in range(0, len(order), chunk):
        block = order[k:k + chunk]
        out = m.decode(torch.cat([heads[n] for n in block]))
        decoded.update({n: out[j] for j, n in enumerate(block)})
    return {"clean": clean, "texts": texts, "iterations": iterations, "without_eps": without_eps,
            "cond_move": moves, "posterior_noise": sf * noise, "frames": decoded}


def fifo_iteration(cell, m, sch, queue, x_in, ctx, uc, normal, i, moves=None):
    """The queue after iteration i, before its shift, from the queue before
    it: every window through the CFG U-Net, MoCA's step per window and the
    write-back of each window's second half; and the same with eps = 0 (the
    step is affine in eps, so the two differ by the U-Net's part)."""
    t = cell.traffic
    f, half, fps = queue.f, queue.f // 2, t["fps"]
    block = t["check"]["unet_rows"]
    wins = torch.cat([x_in[:, s:s + f] for s in queue.starts])
    ts = torch.as_tensor(np.stack([queue.timesteps[s:s + f] for s in queue.starts]),
                         device=x_in.device)

    def unet(x, tt, c):
        return torch.cat([m.unet(x[k:k + block], tt[k:k + block], c[k:k + block], fps)
                          for k in range(0, x.shape[0], block)])
    shape = (1,) + tuple(x_in.shape[2:])

    def written(eps):
        parts = [x_in[:, :half]]
        for r, s in enumerate(queue.starts):
            x_prev = rd.moca_window(
                sch, wins[r:r + 1], eps[r:r + 1], queue.indices[s:s + f],
                queue.timesteps[s:s + f], lambda j: normal(("fifo", i, "win", r, "frame", j), shape))
            parts.append(x_prev[:, half:])
        return torch.cat(parts, dim=1)
    eps = rd.cfg_eps(unet, wins, ts, ctx, uc, t["guidance_scale"], moves)
    return written(eps), written(torch.zeros_like(eps))
