"""DynamiCrafter image animation, clips back to back, closed loop: one
prompt and one image a call, as `cli/inference.py --mode i2v` runs a hybrid
configuration (`T2VPipeline.image_condition`, then `T2VPipeline.__call__`):
the image tokens of the image and of an all-zero image, the image's VAE
latent on every frame's input, 50 v-prediction DDIM steps on the zero-SNR
schedule with rescaled guidance, the 16-frame decode.

Set-up: the program's model built first on the meta device (a program
without the hybrid path fails there, at once), then the seed's weights, the
clips' images and prompts from the seed, and one warm-up clip of
`warmup_steps` steps at the cell's shapes. The window opens after it and
closes at the end of the first clip that ends `--seconds` or more after the
opening; each clip's frames are copied to the host.

Check, after the window, against the float32 reference
(`benchmark/reference/hybrid_i2v.py`), for every clip of the window: the
image tokens of the image and of the zero image; the concat input of every
U-Net row and frame against the reference's image latent; the text contexts;
two DDIM steps from the program's own latents, the first (t = 999, where
alpha_bar = 0) and one of the last steps from `check.late_from` on, drawn by
the seed (the guided and rescaled v of the reference's U-Net on the
reference's contexts, then the step); and every frame, decoded by the
reference from the program's final latents.
"""

from __future__ import annotations

import time

import torch

from benchmark import common, flops, program, trace
from benchmark.drivers.t2v_clip import clip_inputs, clip_normal
from benchmark.reference import control as make_control
from benchmark.reference import diffusion as rd
from benchmark.reference import hybrid_i2v as ref

# the Resampler the program builds, beside its widths from the towers
PROGRAM_RESAMPLER = dict(depth=4, dim_head=64, heads=12, num_queries=16, ff_mult=4)


def build_model(config: dict):
    """The program's model on the meta device."""
    from moca_tpu_torch.models.clip_text import CLIPTextConfig
    from moca_tpu_torch.models.clip_vision import CLIPVisionConfig
    from moca_tpu_torch.models.latent_diffusion import LatentVisualDiffusion
    from moca_tpu_torch.models.unet3d import UNetConfig
    from moca_tpu_torch.models.vae import VAEConfig

    r, v = config["resampler"], config["vision"]
    want = dict(PROGRAM_RESAMPLER, dim=v["output_dim"], embedding_dim=v["width"],
                output_dim=config["unet"]["context_dim"])
    if {k: r[k] for k in want} != want:
        raise ValueError(f"the program builds its Resampler with {want}")
    dc = program._dataclass
    with torch.device("meta"):
        model = LatentVisualDiffusion(
            dc(UNetConfig, config["unet"]), dc(VAEConfig, config["vae"]),
            dc(CLIPTextConfig, config["clip"]), dc(CLIPVisionConfig, v),
            finegrained=config["finegrained"], scale_factor=config["diffusion"]["scale_factor"],
            image_video_length=r["video_length"])
    return model.eval().requires_grad_(False)


def seed_weights(cell: common.Cell) -> dict:
    plan = common.weight_plan(*ref.layout(cell.config), cell.config)
    return common.make_weights(plan, cell.seed, cell.device)


def schedule_kwargs(cell: common.Cell) -> dict:
    """The schedule and sampler the configuration and the traffic give, as
    `cli/inference.py` passes them to `T2VPipeline.build`."""
    d, t = cell.config["diffusion"], cell.traffic
    if d["conditioning_key"] != "hybrid":
        raise ValueError("this driver runs the hybrid conditioning")
    return dict(num_steps=t["ddim_steps"], eta=t["eta"], use_scale=False,
                guidance_scale=t["guidance_scale"], fps=t["frame_stride"],
                uncond_type=d["uncond_type"], guidance_rescale=t["guidance_rescale"], hybrid=True,
                ddim_discretize=t["timestep_spacing"],
                rescale_betas_zero_snr=d["rescale_betas_zero_snr"],
                parameterization=d["parameterization"],
                dynamic_rescale=d["use_dynamic_rescale"], scale_b=d["base_scale"])


def run(cell: common.Cell) -> common.Outcome:
    from moca_tpu_torch.pipelines.t2v import T2VPipeline

    t, dev = cell.traffic, cell.device
    model = build_model(cell.config)
    model.load_state_dict(seed_weights(cell), strict=True, assign=True)
    inputs = [clip_inputs(cell, c) for c in range(t["max_clips"])]
    build_pipe = lambda steps: T2VPipeline.build(
        model, program.tokenizer(), **dict(schedule_kwargs(cell), num_steps=steps))
    size = dict(height=t["height"], width=t["width"], frames=t["frames"])

    def clip(pipe, c):
        image, prompt = inputs[c]
        normal = clip_normal(cell, c)
        cond = pipe.image_condition(image, normal)
        video = pipe(prompt, normal=normal, **cond, **size)
        return cond, video.cpu().numpy()

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
    picked = {c: [0] + common.sample(cell.seed, f"late step {c}",
                                     range(t["check"]["late_from"], steps), 1)
              for c in range(t["max_clips"])}
    latents = {}  # (clip, state k) -> [1, T, h, w, 4]; state `steps` is the decode input
    concats = {}  # clip -> the concat input of the first U-Net call, every row
    current = {"clip": 0, "call": 0}
    unet, decode_latents = model.apply_unet, model.decode_latents

    def apply_unet(x, *args, **kwargs):
        k, c = current["call"], current["clip"]
        if k in picked[c] or k - 1 in picked[c]:
            latents[c, k] = x[:1]
        if k == 0:
            concats[c] = kwargs.get("c_concat")
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
    conds, videos = {}, {}
    for c in range(t["max_clips"]):
        current.update(clip=c, call=0)
        conds[c], videos[c] = clip(pipe, c)
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
    checked = check(cell, conds, concats, text_rows, latents, videos, picked,
                    control=cell.control)
    values = checked["program"]
    return common.Outcome(
        window=window, peak_bytes=peak, view=view,
        end_to_end={"s_per_clip": (window.per_unit, "s/clip")},
        readings=common.readings_of(values, cell.limits),
        failed=sum(v > cell.limits["frames"]["limit"] for v in values["frames"]),
        control=checked.get("control"),
        diagnostics={"values": values, "cond_move": checked["cond_move"],
                     "step_by_guided_v": checked["step_by_guided_v"]})


def clip_flops(cell: common.Cell, clips: int) -> dict:
    """Model FLOPs of `clips` clips: the text tower twice a clip (the prompt
    and the empty prompt), the image towers twice (the image and the zero
    image), one VAE encode of the image, the U-Net at 2 rows a step with
    the concat input, and the decode of every frame."""
    t, cfg = cell.traffic, cell.config
    h, w = t["height"] // 8, t["width"] // 8
    m = ref.meta_model(cfg)
    r = cfg["resampler"]
    ctx_len = rd.CONTEXT_LENGTH + r["num_queries"] * r["video_length"]
    with torch.device("meta"):
        x = torch.empty(2, t["frames"], h, w, cfg["unet"]["in_channels"])
        ts = torch.zeros(2, t["frames"], dtype=torch.long)
        ctx = torch.empty(2, ctx_len, cfg["unet"]["context_dim"])
        image = torch.empty(1, t["height"], t["width"], 3)
        out = {"unet": t["ddim_steps"] * flops.count_flops(m.unet, x, ts, ctx, t["frame_stride"]),
               "text": 2 * flops.count_flops(
                   m.clip, torch.zeros(1, rd.CONTEXT_LENGTH, dtype=torch.long)),
               "vae": flops.count_flops(m.decode, torch.empty(t["frames"], h, w, 4))
               + flops.count_flops(m.vae.moments, image),
               "image": 2 * flops.count_flops(m.image_embeds, image)}
    return {k: v * clips for k, v in out.items()}


@torch.inference_mode()
def check(cell, conds, concats, text_rows, latents, videos, picked, control: bool = False):
    """{number: [values]} of the program against the float32 reference, and
    with `control`, also of the control (the reference in the type below the
    served one, fed the same program latents)."""
    dev = cell.device
    with common.exact_float32():
        m = ref.build(cell.config, seed_weights(cell))
        want = stages(cell, m, latents, videos, picked)
        program_side = {
            "tokens": {c: torch.cat([cond["image_tokens"], cond["uncond_image_tokens"]])
                       for c, cond in conds.items()},
            "concat": concats, "text_rows": text_rows,
            "frames": {c: torch.as_tensor(v, device=dev) for c, v in videos.items()},
            "steps": {(c, k): latents[c, k + 1] for c in videos for k in picked[c]}}
        out = {"program": compare(program_side, want), "cond_move": want["cond_move"],
               "step_by_guided_v": [
                   common.rel_l2(program_side["steps"][key], want["steps"][key],
                                 base=want["origin"][key]) for key in sorted(want["steps"])]}
        if control:
            ctl = stages(cell, make_control(m, cell.config), latents, videos, picked)
            ctl["text_rows"] = {c: list(texts.values()) for c, texts in ctl["texts"].items()}
            out["control"] = compare(ctl, want)
    return out


def compare(side, want) -> dict:
    """The image tokens, the concat input, the text contexts and the frames
    whole; a step's error against the size of the two U-Net outputs that
    guidance combines, each taken through the step with its weight (k s v_c
    and k (s - 1) v_u, k the guidance rescale's factor; the step is affine
    in v, and the same step with v = 0 is the origin): the bf16 rounding of
    both outputs scales with these, while the guided v they combine may be
    far smaller."""
    values = {"image_tokens": [], "concat_latent": [], "text_context": [], "step": [],
              "frames": []}
    for c in sorted(want["tokens"]):
        values["image_tokens"].append(common.rel_l2(side["tokens"][c], want["tokens"][c]))
        got = side["concat"][c]
        values["concat_latent"].append(
            common.rel_l2(got, want["concat"][c].expand_as(got)) if got is not None
            else float("inf"))
        values["text_context"] += common.text_context(side["text_rows"].get(c, []),
                                                      want["texts"][c])
    for key in sorted(want["steps"]):
        err = torch.linalg.vector_norm(side["steps"][key].double() - want["steps"][key])
        values["step"].append(float(err / want["terms"][key]))
    for c in sorted(want["frames"]):
        values["frames"] += [common.rel_l2(a, b) for a, b in zip(side["frames"][c],
                                                                  want["frames"][c])]
    return values


def stages(cell, m, latents, videos, picked) -> dict:
    """The reference's image tokens, image latent, text contexts, picked
    DDIM steps (from the program's latents) and decoded frames (from the
    program's final latents) of every clip of the window."""
    t, dev = cell.traffic, cell.device
    steps, s, phi = t["ddim_steps"], t["guidance_scale"], t["guidance_rescale"]
    sch = ref.Schedule(steps, t["eta"], cell.config["diffusion"], dev)
    encode = lambda texts: m.clip(torch.as_tensor(rd.hash_tokens(texts), device=dev))
    uc_text = encode([""])
    h, w = t["height"] // 8, t["width"] // 8
    out = {"tokens": {}, "concat": {}, "texts": {}, "steps": {}, "origin": {}, "terms": {},
           "frames": {}, "cond_move": []}
    for c in sorted(videos):
        image, prompt = clip_inputs(cell, c)
        normal = clip_normal(cell, c)
        tokens, uc_tokens = m.image_embeds(image), m.image_embeds(torch.zeros_like(image))
        out["tokens"][c] = torch.cat([tokens, uc_tokens])
        z = m.image_latent(image, normal(("image_latent",), (1, h, w, 4)))
        z = z[:, None].expand(1, t["frames"], h, w, 4)
        out["concat"][c] = z
        ctx = encode([prompt])
        out["texts"][c] = {prompt: ctx[0], "": uc_text[0]}
        ctx, uc = torch.cat([ctx, tokens], dim=1), torch.cat([uc_text, uc_tokens], dim=1)
        net = lambda xx, tt, cc: m.unet(torch.cat([xx, z.expand(xx.shape[0], -1, -1, -1, -1)],
                                                  dim=-1), tt, cc, t["frame_stride"])
        for k in picked[c]:
            index = steps - 1 - k
            x = latents[c, k].float()
            tt = torch.full((1, t["frames"]), int(sch.timesteps[index]), device=dev)
            v_c, v_u = rd.cfg_parts(net, x, tt, ctx, uc, out["cond_move"])
            noise = normal(("base", "step", k), tuple(x.shape))
            step = lambda v: ref.v_step(sch, x, v, index, noise).double()
            v, gain = ref.guided(v_c, v_u, s, phi)
            origin = step(torch.zeros_like(v))
            out["steps"][c, k], out["origin"][c, k] = step(v), origin
            out["terms"][c, k] = float(torch.linalg.vector_norm(step(gain * s * v_c) - origin)
                                       + torch.linalg.vector_norm(step(gain * (s - 1) * v_u)
                                                                  - origin))
        final = latents[c, steps][0]
        chunk = t["check"]["vae_rows"]
        out["frames"][c] = torch.cat([m.decode(final[i:i + chunk])
                                      for i in range(0, final.shape[0], chunk)])
    return out
