"""Text-to-video clips, back to back, closed loop: one prompt a call as
`cli/inference.py` runs it (`--bs 1`), with a conditioning image per clip
where the traffic says `image` (`--mode i2v`: `get_image_embeds`, then
`T2VPipeline.__call__(prompt, image_tokens=...)`).

Set-up: the model from the seed's weights, the clips' images and prompts
from the seed, and one warm-up clip of `warmup_steps` DDIM steps at the
cell's shapes. The window opens after it and closes at the end of the first
clip that ends `--seconds` or more after the opening; each clip's frames are
copied to the host, as the CLI does before it writes them.

Check, after the window, against the float32 reference: each clip's image
tokens (the vision tower and the Resampler); its text contexts (the prompt
and the empty prompt); `check.steps` DDIM steps of
each clip, drawn by the seed, from the program's own latents (the CFG U-Net with the
reference's text and image context, and the step); and every frame of every
clip, decoded by the reference from the program's final latents.
"""

from __future__ import annotations

import time

import torch

from benchmark import common, flops, program, trace
from benchmark.reference import build, control as make_control, meta_model
from benchmark.reference import diffusion as rd


def clip_inputs(cell: common.Cell, c: int):
    """(image [1, H, W, 3] in [-1, 1] on the device or None, prompt) of clip c."""
    t = cell.traffic
    prompt = t["prompts"][common.sample(cell.seed, f"prompt {c}", range(len(t["prompts"])), 1)[0]]
    image = (common.uniform(cell.seed, f"image {c}", (1, t["height"], t["width"], 3), cell.device)
             if t["image"] else None)
    return image, prompt


def clip_normal(cell: common.Cell, c: int) -> common.SeededNormal:
    return common.SeededNormal(common.derived_seed(cell.seed, "clip", c), cell.device)


def run(cell: common.Cell) -> common.Outcome:
    from moca_tpu_torch.pipelines.t2v import T2VPipeline

    t, dev = cell.traffic, cell.device
    model = program.build_model(cell.config, common.seed_weights(cell))
    inputs = [clip_inputs(cell, c) for c in range(t["max_clips"])]
    build_pipe = lambda steps: T2VPipeline.build(
        model, program.tokenizer(), num_steps=steps, eta=t["eta"],
        use_scale=cell.config["diffusion"]["use_scale"], guidance_scale=t["guidance_scale"],
        fps=t["fps"])
    size = dict(height=t["height"], width=t["width"], frames=t["frames"])

    def clip(pipe, c):
        image, prompt = inputs[c]
        tokens = model.get_image_embeds(image) if image is not None else None
        video = pipe(prompt, normal=clip_normal(cell, c), image_tokens=tokens, **size)
        return tokens, video.cpu().numpy()

    clip(build_pipe(t["warmup_steps"]), 0)
    pipe = build_pipe(t["ddim_steps"])

    text_rows = {}  # clip -> every text context it encoded, a row each
    encode_tokens = model.encode_tokens

    def encoded(tokens):
        out = encode_tokens(tokens)
        text_rows.setdefault(current["clip"], []).extend(out.detach().float().clone())
        return out
    model.encode_tokens = encoded

    spans = trace.Spans(cell.trace)
    spans.wrap(model, "apply_unet", "unet")
    spans.wrap(model, "decode_single", "vae.decode")
    spans.wrap(model, "get_image_embeds", "image_embed")
    spans.wrap(model, "encode_tokens", "text_encode")
    steps = t["ddim_steps"]
    # the last step (index 0: a = a_prev, sigma = 0) leaves x as it is but for
    # rounding, so the checked step is one of the others
    picked = {c: common.sample(cell.seed, f"checked steps {c}", range(steps - 1),
                               t["check"]["steps"]) for c in range(t["max_clips"])}
    latents = {}  # (clip, state k) -> [1, T, h, w, 4]; state `steps` is the decode input
    current = {"clip": 0, "call": 0}
    unet, decode_latents = model.apply_unet, model.decode_latents

    def apply_unet(x, *args, **kwargs):
        k, c = current["call"], current["clip"]
        if k in picked[c] or k - 1 in picked[c]:
            latents[c, k] = x[:1]
        current["call"] += 1
        return unet(x, *args, **kwargs)

    def decode(z, *args, **kwargs):
        c = current["clip"]
        latents[c, steps] = z.reshape((1, t["frames"]) + tuple(z.shape[2:]))
        return decode_latents(z, *args, **kwargs)
    model.apply_unet, model.decode_latents = apply_unet, decode

    window = common.Window(cell.seconds)
    profiler = trace.Profiler() if cell.trace else None
    if profiler:
        profiler.start()
    program.reset_launches()
    window.open()
    tokens, videos = {}, {}
    for c in range(t["max_clips"]):
        current.update(clip=c, call=0)
        tokens[c], videos[c] = clip(pipe, c)
        if window.after(c + 1, time.perf_counter()):
            break
    else:
        raise RuntimeError("the window outlasted max_clips clips: raise max_clips")
    launched = program.launches()
    if profiler:
        profiler.stop()
    peak = common.peak_bytes(dev)
    del pipe, model, unet, decode_latents
    common.release(dev)

    view = None
    if profiler:
        view = profiler.view(launched, clip_flops(cell, window.units),
                             {"units": window.units, "decoded_frames": window.units * t["frames"]})
    checked = check(cell, tokens, text_rows, latents, videos, picked, control=cell.control)
    values = checked["program"]
    return common.Outcome(
        window=window, peak_bytes=peak, view=view,
        end_to_end={"s_per_clip": (window.per_unit, "s/clip")},
        readings=common.readings_of(values, cell.limits),
        failed=sum(v > cell.limits["frames"]["limit"] for v in values["frames"]),
        control=checked.get("control"),
        diagnostics={"values": values, "cond_move": checked["cond_move"],
                     "step_by_guided_eps": checked["step_by_guided_eps"]})


def clip_flops(cell: common.Cell, clips: int) -> dict:
    """Model FLOPs of `clips` clips: the text tower twice a clip (prompt and
    the empty prompt), the image towers once, the U-Net at 2 rows a step and
    the decode of every frame."""
    t, cfg = cell.traffic, cell.config
    h, w = t["height"] // 8, t["width"] // 8
    m = meta_model(cfg)
    ctx_len = rd.CONTEXT_LENGTH + (cfg["resampler"]["num_queries"] if t["image"] else 0)
    with torch.device("meta"):
        x = torch.empty(2, t["frames"], h, w, 4)
        ts = torch.zeros(2, t["frames"], dtype=torch.long)
        ctx = torch.empty(2, ctx_len, cfg["unet"]["context_dim"])
        out = {"unet": t["ddim_steps"] * flops.count_flops(m.unet, x, ts, ctx, t["fps"]),
               "text": 2 * flops.count_flops(
                   m.clip, torch.zeros(1, rd.CONTEXT_LENGTH, dtype=torch.long)),
               "vae": flops.count_flops(m.decode, torch.empty(t["frames"], h, w, 4))}
        if t["image"]:
            out["image"] = flops.count_flops(m.image_embeds,
                                             torch.empty(1, t["height"], t["width"], 3))
    return {k: v * clips for k, v in out.items()}


@torch.inference_mode()
def check(cell, tokens, text_rows, latents, videos, picked, control: bool = False):
    """{number: [values]} of the program against the float32 reference, and
    with `control`, also of the control (the reference in the type below the
    served one, fed the same program latents)."""
    dev = cell.device
    with common.exact_float32():
        m = build(cell.config, common.seed_weights(cell))
        ref = stages(cell, m, latents, videos, picked)
        program_side = {
            "tokens": tokens, "text_rows": text_rows,
            "frames": {c: torch.as_tensor(v, device=dev)
                                         for c, v in videos.items()},
            "steps": {(c, k): latents[c, k + 1] for c in videos for k in picked[c]}}
        out = {"program": compare(program_side, ref), "cond_move": ref["cond_move"],
               "step_by_guided_eps": [
                   common.rel_l2(program_side["steps"][key], ref["steps"][key],
                                 base=ref["without_eps"][key]) for key in sorted(ref["steps"])]}
        if control:
            ctl = stages(cell, make_control(m, cell.config), latents, videos, picked)
            ctl["text_rows"] = {c: list(texts.values()) for c, texts in ctl["texts"].items()}
            out["control"] = compare(ctl, ref)
    return out


def compare(side, ref) -> dict:
    """The image tokens, text contexts and frames whole; the step's error
    against the size of the two U-Net outputs that guidance combines, each
    taken through the step with its weight (s e_c and (s - 1) e_u; the step
    is affine in eps, and the same step with eps = 0 is the origin): the
    bf16 rounding of both outputs scales with these, while the guided eps
    they combine may be far smaller."""
    values = {"step": [], "frames": [], "text_context": []}
    if ref["tokens"]:
        values["image_tokens"] = [common.rel_l2(side["tokens"][c], ref["tokens"][c])
                                  for c in sorted(ref["tokens"])]
    for c in sorted(ref["texts"]):
        values["text_context"] += common.text_context(side["text_rows"].get(c, []),
                                                      ref["texts"][c])
    for key in sorted(ref["steps"]):
        err = torch.linalg.vector_norm(side["steps"][key].double() - ref["steps"][key].double())
        values["step"].append(float(err / ref["terms"][key]))
    for c in sorted(ref["frames"]):
        values["frames"] += [common.rel_l2(a, b) for a, b in zip(side["frames"][c],
                                                                  ref["frames"][c])]
    return values


def stages(cell, m, latents, videos, picked) -> dict:
    """The reference's image tokens, picked DDIM steps (from the program's
    latents) and decoded frames (from the program's final latents) of every
    clip of the window."""
    t, dev = cell.traffic, cell.device
    steps, fps = t["ddim_steps"], t["fps"]
    sch = rd.Schedule(steps, t["eta"], cell.config["diffusion"], dev)
    encode = lambda texts: m.clip(torch.as_tensor(rd.hash_tokens(texts), device=dev))
    uc_text = encode([""])
    out = {"tokens": {}, "texts": {}, "steps": {}, "without_eps": {}, "terms": {}, "frames": {},
           "cond_move": []}
    for c in sorted(videos):
        image, prompt = clip_inputs(cell, c)
        ctx, uc = encode([prompt]), uc_text
        out["texts"][c] = {prompt: ctx[0], "": uc[0]}
        if image is not None:
            out["tokens"][c] = m.image_embeds(image)
            ctx = torch.cat([ctx, out["tokens"][c]], dim=1)
            uc = torch.cat([uc, torch.zeros_like(out["tokens"][c])], dim=1)
        for k in picked[c]:
            index = steps - 1 - k
            x = latents[c, k]
            tt = torch.full((1, t["frames"]), int(sch.timesteps[index]), device=dev)
            s = t["guidance_scale"]
            e_c, e_u = rd.cfg_parts(lambda xx, ttt, cc: m.unet(xx, ttt, cc, fps), x, tt, ctx, uc,
                                    out["cond_move"])
            noise = clip_normal(cell, c)(("base", "step", k), tuple(x.shape))
            step = lambda eps: rd.ddim_step(sch, x, eps, index, noise).double()
            origin = step(torch.zeros_like(e_c))
            out["steps"][c, k] = step(e_u + s * (e_c - e_u))
            out["without_eps"][c, k] = origin
            out["terms"][c, k] = float(torch.linalg.vector_norm(step(s * e_c) - origin)
                                       + torch.linalg.vector_norm(step((s - 1) * e_u) - origin))
        final = latents[c, steps][0]
        chunk = t["check"]["vae_rows"]
        out["frames"][c] = torch.cat([m.decode(final[i:i + chunk])
                                      for i in range(0, final.shape[0], chunk)])
    return out
