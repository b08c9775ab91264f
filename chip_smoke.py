"""GPU smoke of the PyTorch/CUDA port (moca_tpu_torch) on one NVIDIA card.

Phases, each failing loudly (non-zero exit, no result line):
  1. print the card's name and power limit, build the CUDA kernels from
     moca_tpu_torch/csrc with nvcc (sm_90a) and print the build time;
  2. hold each kernel to its plain PyTorch version at every shape the main
     path gives it (and K1 on adversarial softmax inputs), show that faults
     planted through the kernel's inputs fail that check, and time the
     kernel, the plain version and one PyTorch library call for the same work;
  3. check the port's U-Net with the kernels (bf16, GPU) against its plain
     path (fp32, CPU) on a small input;
  4. drive the main path once: MoCAVideoPipeline at the shipped
     VideoCrafter2 widths, random bf16 weights, 512x320, f=16, n=4 with
     lookahead, guidance 12, concept image, conditioned prompt and masks,
     with every kernel's launch count read just before and just after;
  5. time one FIFO U-Net forward, break its device time down by kernel
     category and read the device's idle share, from one torch.profiler trace.
Prints a JSON line of kernel measurements, then as the last line
{"ok": true, "device": {...}}.

Usage: python3 chip_smoke.py [new_video_length (default 4)]
"""

from __future__ import annotations

import itertools
import json
import math
import subprocess
import sys
import time

H100_BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM
H100_BYTES_PER_S = 3.35e12
# Largest relative L2 error of one output row (the 64-vector of one query and
# head) against the plain version. Kernel and plain version round the
# probabilities and the output to bf16 at different points, a few 2^-8
# relative; a kernel that leaves out the last kv tile or key, or halves the
# softmax scale, is off by far more, and every check plants those faults
# through the kernel's inputs to show that it fails them.
KERNEL_TOL = 2e-2
UNET_REL_TOL = 5e-2  # bf16 GPU forward vs fp32 CPU forward, relative to max |ref|


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_row_rel_err(out, ref, d=64):
    """max over rows of ||out - ref|| / ||ref||, rows being d-vectors."""
    out, ref = out.float().reshape(-1, d), ref.float().reshape(-1, d)
    ref_norm = ref.norm(dim=1)
    return ((out - ref).norm(dim=1) / ref_norm.clamp_min(1e-6 * ref_norm.max())).max().item()


def hold_to_plain(what, out, ref, faults=()):
    """Fail unless out is finite and within KERNEL_TOL of ref, and every
    planted fault is beyond it. Returns (row error, smallest fault error)."""
    import torch

    err = max_row_rel_err(out, ref)
    if not torch.isfinite(out.float()).all() or not err <= KERNEL_TOL:
        fail(f"{what}: finite={bool(torch.isfinite(out.float()).all())}, "
             f"row relative err {err} > {KERNEL_TOL}")
    fault_err = min((max_row_rel_err(f, ref) for f in faults), default=math.inf)
    if not fault_err > KERNEL_TOL:
        fail(f"{what}: a planted fault reads {fault_err} <= {KERNEL_TOL}; the check cannot "
             f"tell it from a sound kernel")
    return err, fault_err


def attention_bound_ms(q, k, v):
    """The least time of attention(q [B,Sq,H,D], k, v [B,Sk,H,D]) on the card:
    the larger of its bytes (each input read once, the output written once)
    over the memory rate and its QK^T + PV tensor-core operations
    (4*B*H*Sq*Sk*D) over the bf16 peak. Returns (ms, what bounds it)."""
    b, sq, h, d = q.shape
    flops = 4 * b * h * sq * k.shape[1] * d
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_build():
    from moca_tpu_torch.ops import flash_attention as fa

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    t0 = time.perf_counter()
    fa.build_kernels()
    for name in ("flash", "packed"):
        fa._lib(name)
    print(f"[build] kernels ready in {time.perf_counter() - t0:.1f} s "
          f"(nvcc: {json.dumps({k: round(v['seconds'], 1) for k, v in fa.build_log.items()})})",
          flush=True)
    for name, log in fa.build_log.items():
        for line in log["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}")


def _randn_bf16(shape, gen):
    import torch

    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


def _chunked(fn, q, k, v, chunk):
    import torch

    return torch.cat([fn(q[i:i + chunk], k[i:i + chunk], v[i:i + chunk])
                      for i in range(0, q.shape[0], chunk)])


def check_flash(b, sq, sk, h, gen, rows, reps=10):
    """K1 at q [b, sq, h, 64] over k, v [b, sk, h, 64] against attention_plain
    (batch-chunked: the plain fp32 logits at b=256, s=2560 would take 33.5 GB)."""
    import torch
    import torch.nn.functional as F
    from moca_tpu_torch.ops import flash_attention as fa

    q, k, v = (_randn_bf16((b, s, h, 64), gen) for s in (sq, sk, sk))
    chunk = max(1, (2 << 30) // (h * sq * sk * 4))
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    ref = _chunked(fa.attention_plain, q, k, v, chunk)
    cut = sk - 64  # planted faults: the last kv tile left out; the scale halved
    faults = (fa.flash_attention(q, k[:, :cut].contiguous(), v[:, :cut].contiguous()),
              fa.flash_attention(q * 0.5, k, v))
    rel, fault_rel = hold_to_plain(f"flash_attention [{b},{sq},{sk},{h},64]", out, ref, faults)
    del faults
    err = (out.float() - ref.float()).abs().max().item()
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v), reps)
    plain_ms = cuda_ms(lambda: _chunked(fa.attention_plain, q, k, v, chunk), 2, warmup=1)
    tr = lambda t: t.transpose(1, 2)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(tr(q), tr(k), tr(v)), reps)
    bms, by = attention_bound_ms(q, k, v)
    print(f"[K1 flash_attention B={b} Sq={sq} Sk={sk} H={h} D=64] row_rel_err {rel:.3e} "
          f"(tol {KERNEL_TOL}, planted faults >= {fault_rel:.3e}) max_abs_err {err:.3e} "
          f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms sdpa {lib_ms:.4f} ms "
          f"bound {bms:.4f} ms ({by})", flush=True)
    small = sq == sk and sq <= 640  # the reference's _small_attention route
    rows.append(dict(name=f"flash_attention B={b} Sq={sq} Sk={sk} H={h} D=64", route="cuda",
                     source="moca_tpu_torch/csrc/flash_attention.cu",
                     replaces=("moca_tpu/ops/flash_attention.py:298 (_fa_small_kernel)"
                               if small else
                               "moca_tpu/ops/flash_attention.py:765 (_fa_kernel)"),
                     shape=(b, sq, sk, h, 64), max_abs_err=err, max_row_rel_err=rel,
                     fault_row_rel_err=fault_rel, ms=ms, plain_ms=plain_ms,
                     bound_ms=bms, bound_by=by, library_ms=lib_ms))


def check_flash_adversarial(gen):
    """K1 on the softmax hazards of tests/test_flash_attention.py:212-228:
    finite output that matches the plain version."""
    from moca_tpu_torch.ops import flash_attention as fa

    b, h, d = 2, 2, 64
    for s, kind in itertools.product((256, 640), ("overflow", "underflow", "denom_overflow")):
        q, k, v = (_randn_bf16((b, s, h, d), gen) for _ in range(3))
        if kind == "overflow":
            q[0] = q[0].abs() + 40.0
            k[0] = k[0].abs() + 40.0
        elif kind == "denom_overflow":
            q.fill_(3.25)
            k.fill_(3.25)
            v = v * 1e-5
        else:
            q.fill_(-40.0)
            k.fill_(40.0)
        rel, _ = hold_to_plain(f"flash_attention adversarial {kind} S={s}",
                               fa.flash_attention(q, k, v), fa.attention_plain(q, k, v))
        print(f"[K1 adversarial {kind} S={s}] finite, row_rel_err {rel:.3e} "
              f"(tol {KERNEL_TOL})", flush=True)


def check_packed(n, s, c, gen, rows, reps=20):
    import torch.nn.functional as F
    from moca_tpu_torch.ops import flash_attention as fa

    heads = c // 64
    q, k, v = (_randn_bf16((n, s, c), gen) for _ in range(3))
    out = fa.packed_attention(q, k, v, heads)
    ref = fa.packed_attention_plain(q, k, v, heads)
    v_cut = v.clone()
    v_cut[:, -1] = 0  # planted faults: the last key left out of PV; the scale halved
    faults = (fa.packed_attention(q, k, v_cut, heads), fa.packed_attention(q * 0.5, k, v, heads))
    rel, fault_rel = hold_to_plain(f"packed_attention [{n},{s},{c}]", out, ref, faults)
    del faults, v_cut
    err = (out.float() - ref.float()).abs().max().item()
    ms = cuda_ms(lambda: fa.packed_attention(q, k, v, heads), reps)
    plain_ms = cuda_ms(lambda: fa.packed_attention_plain(q, k, v, heads), 3, warmup=1)
    split = lambda t: t.view(n, s, heads, 64)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        split(q).transpose(1, 2), split(k).transpose(1, 2), split(v).transpose(1, 2)), reps)
    bms, by = attention_bound_ms(split(q), split(k), split(v))
    print(f"[K2 packed_attention N={n} S={s} C={c}] row_rel_err {rel:.3e} (tol {KERNEL_TOL}, "
          f"planted faults >= {fault_rel:.3e}) max_abs_err {err:.3e} kernel {ms:.4f} ms plain {plain_ms:.4f} ms sdpa {lib_ms:.4f} ms "
          f"bound {bms:.4f} ms ({by})", flush=True)
    rows.append(dict(name=f"packed_attention N={n} S={s} C={c}", route="cuda",
                     source="moca_tpu_torch/csrc/packed_attention.cu",
                     replaces=("moca_tpu/ops/flash_attention.py:614 (_packed_slice_kernel)"
                               if c == 320 else
                               "moca_tpu/ops/flash_attention.py:559 (_packed_lane_kernel)"),
                     shape=(n, s, c), max_abs_err=err, max_row_rel_err=rel,
                     fault_row_rel_err=fault_rel, ms=ms, plain_ms=plain_ms,
                     bound_ms=bms, bound_by=by, library_ms=lib_ms))


def main_path_shapes(rows_fifo: int, rows_base: int, ctx_fifo: int, ctx_base: int,
                     lat=(40, 64), f=16):
    """(K1 [B,Sq,Sk,H,D] shapes, K2 [N,S,C] shapes) that the shipped U-Net
    gives the kernels at a window batch of `rows` x f frames and a text
    context of `ctx` tokens: spatial self-attention at ds 1, 2, 4; text
    cross-attention there too when the context reaches 128 tokens (the
    reference's flash threshold); temporal attention at every level, the
    8-head init attention and the middle block."""
    k1, k2 = [], []
    for rows, ctx in ((rows_fifo, ctx_fifo), (rows_base, ctx_base)):
        for lvl, ch in enumerate((320, 640, 1280)):
            hh, ww = lat[0] >> lvl, lat[1] >> lvl
            k1.append((rows * f, hh * ww, hh * ww, ch // 64, 64))
            if ctx >= 128:
                k1.append((rows * f, hh * ww, ctx, ch // 64, 64))
            k2.append((rows * hh * ww, f, ch))
        k2.append((rows * lat[0] * lat[1], f, 512))                  # init attention
        k2.append((rows * (lat[0] >> 3) * (lat[1] >> 3), f, 1280))   # middle block
    return k1, k2


def phase_kernels(rows_fifo: int, rows_base: int, ctx_fifo: int, ctx_base: int):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    k1, k2 = main_path_shapes(rows_fifo, rows_base, ctx_fifo, ctx_base)
    for b, sq, sk, h, _ in k1:
        check_flash(b, sq, sk, h, gen, rows)
    check_flash_adversarial(gen)
    for n, s, c in k2:
        check_packed(n, s, c, gen, rows)
    return rows


def phase_unet_reference():
    """The port's U-Net with the kernels (bf16, GPU) against its plain path
    (fp32, CPU) on one small input; S=256 spatial (K1) and S=16 temporal (K2)."""
    import numpy as np
    import torch
    from moca_tpu_torch.models.unet3d import UNet3D, UNetConfig
    from moca_tpu_torch.ops import flash_attention as fa

    cfg = UNetConfig(model_channels=64, num_head_channels=64, context_dim=64,
                     channel_mult=(1, 2), attention_resolutions=(1,), num_res_blocks=1,
                     temporal_length=16)
    torch.manual_seed(0)
    ref_model = UNet3D(cfg).eval()
    with torch.no_grad():
        for p in ref_model.parameters():
            p.copy_(torch.randn(p.shape) * 0.05)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((1, 16, 16, 16, 4)), dtype=torch.float32)
    ts = torch.as_tensor(rng.integers(0, 1000, (1, 16)))
    ctx = torch.as_tensor(rng.standard_normal((1, 77, 64)), dtype=torch.float32)
    with torch.inference_mode():
        ref = ref_model(x, ts, ctx, fps=10)
        gpu_model = ref_model.to("cuda", torch.bfloat16)
        fa.reset_launch_counts()
        out = gpu_model(x.cuda(), ts.cuda(), ctx.cuda(), fps=10).float().cpu()
    rel = ((out - ref).abs().max() / ref.abs().max()).item()
    if not math.isfinite(rel) or rel > UNET_REL_TOL:
        fail(f"U-Net GPU vs CPU reference: relative max err {rel} > {UNET_REL_TOL}")
    if not (fa.flash_attention.launches and fa.packed_attention.launches):
        fail("the reference-check U-Net did not reach both kernels")
    print(f"[unet reference] bf16 GPU (kernels) vs fp32 CPU (plain): relative max err "
          f"{rel:.3e} (tol {UNET_REL_TOL})", flush=True)


def phase_main_path(new_video_length: int, num_partitions: int):
    import numpy as np
    import torch
    from moca_tpu_torch.models.clip_text import CLIPTextConfig
    from moca_tpu_torch.models.latent_diffusion import init_random_model
    from moca_tpu_torch.models.tokenizer import HashTokenizer
    from moca_tpu_torch.models.unet3d import UNetConfig
    from moca_tpu_torch.models.vae import VAEConfig
    from moca_tpu_torch.ops import flash_attention as fa
    from moca_tpu_torch.pipelines.moca_video import MoCAVideoPipeline

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(1)
    model = init_random_model(UNetConfig(), VAEConfig(), CLIPTextConfig(), gen,
                              device="cuda", dtype=torch.bfloat16)
    print(f"[main] model built in {time.perf_counter() - t0:.1f} s, "
          f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params", flush=True)
    f = 16
    pipe = MoCAVideoPipeline(model, HashTokenizer(), video_length=f,
                             num_partitions=num_partitions,
                             new_video_length=new_video_length, guidance_scale=12.0)
    h, w = 40, 64
    masks = np.zeros((f, h, w), np.float32)
    masks[:, 10:30, 16:48] = 1.0
    cond = np.full((h, w, 4), 0.2, np.float32)

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    frames = pipe("a cat surfing", seed=321, cond_image=cond, conditioned_prompt="a dog",
                  gamma=0.5, height=320, width=512, masks=masks)
    total = time.perf_counter() - t0
    shapes = {"flash_attention": dict(fa.flash_attention.launches),
              "packed_attention": dict(fa.packed_attention.launches)}
    counts = {name: sum(by_shape.values()) for name, by_shape in shapes.items()}

    iters = new_video_length + pipe.num_inference_steps - f
    finite = all(np.isfinite(x).all() for x in frames)
    if len(frames) != iters or frames[0].shape != (320, 512, 3) or not finite:
        fail(f"main path: {len(frames)} frames (want {iters}), shape {frames[0].shape}, "
             f"finite={finite}")
    for name, n in counts.items():
        if n <= 0:
            fail(f"main path launched {name} no time")
    steady = pipe.timings["fifo_iteration"] + pipe.timings["decode"]
    print(f"[main] {len(frames)} frames {frames[0].shape}, all finite; total {total:.2f} s, "
          f"{total / len(frames):.3f} s/frame incl. base sample; FIFO+decode "
          f"{steady / iters:.3f} s/frame; stages "
          f"{json.dumps({k: round(v, 3) for k, v in pipe.timings.items()})}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB", flush=True)
    print(f"[main] launches {json.dumps(counts)}", flush=True)
    return shapes, model


_CATEGORIES = (  # kernel-name substrings -> category, first match wins
    ("flash_fwd", "K1 flash_attention"), ("packed_fwd", "K2 packed_attention"),
    ("fprop", "convolution"), ("conv", "convolution"), ("dgrad", "convolution"),
    ("gemm", "matmul"), ("nvjet", "matmul"), ("cutlass", "matmul"),
    ("softmax", "softmax"), ("reduce", "reduction"), ("norm", "reduction"),
    ("welford", "reduction"), ("cat", "copy"), ("copy", "copy"),
    ("elementwise", "elementwise"), ("vectorized", "elementwise"))


def phase_profile(model, rows: int, ctx_len: int, f: int = 16):
    """Where one FIFO U-Net forward spends device time: CUDA-event time of
    the call, then one torch.profiler trace (device activity only) summed by
    kernel category, with the device's idle share over the trace's device
    span (first kernel start to last kernel end)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((rows, f, 40, 64, 4), generator=gen, device="cuda")
    ts = torch.randint(0, 1000, (rows, f), generator=gen, device="cuda")
    ctx = torch.randn((rows, ctx_len, 1024), generator=gen, device="cuda")
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model.apply_unet(x, ts, ctx, 10), reps=3, warmup=1)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            model.apply_unet(x, ts, ctx, 10)
            torch.cuda.synchronize()
    print(f"[profile] U-Net forward at {rows} rows x {f} frames, context {ctx_len}: "
          f"{fwd_ms:.1f} ms (CUDA events, mean of 3)", flush=True)
    cuda = torch.autograd.DeviceType.CUDA
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == cuda and e.self_device_time_total > 0:
            kernels[e.key] = kernels.get(e.key, 0.0) + e.self_device_time_total / 1e3
    busy = sum(kernels.values())
    if not busy:
        print("[profile] the profiler recorded no device time", flush=True)
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == cuda)
    if spans:
        covered, reach = 0, spans[0][0]
        for start, end in spans:  # union of the device intervals
            covered += max(0, end - max(start, reach))
            reach = max(reach, end)
        span = reach - spans[0][0]
        print(f"[profile] traced forward: device busy {covered / 1e3:.2f} ms of a "
              f"{span / 1e3:.2f} ms device span, idle share {1 - covered / span:.4f} "
              f"(profiler on)", flush=True)
    else:
        print("[profile] idle share not measured: the trace holds no device intervals",
              flush=True)
    cats = {}
    for name, ms in kernels.items():
        low = name.lower()
        cat = next((c for key, c in _CATEGORIES if key in low), "other")
        cats[cat] = cats.get(cat, 0.0) + ms
    for cat, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {cat:22s} {ms:9.2f} ms  {100 * ms / busy:5.1f} %", flush=True)
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:12]:
        print(f"[profile]   top {ms:9.2f} ms  {name[:110]}", flush=True)


def main(argv):
    try:
        import torch
    except ImportError as exc:
        fail(f"torch is not importable: {exc}")
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    try:
        import moca_tpu_torch  # noqa: F401
    except ImportError as exc:
        fail(f"the port is not importable from here ({exc}); run from the repository root")

    new_video_length = int(argv[0]) if argv else 4
    num_partitions = 4
    rows_fifo = 2 * 2 * num_partitions  # windows x CFG rows
    t_start = time.perf_counter()

    phase_build()
    # text context: 77 prompt tokens, 154 with the conditioned prompt (FIFO)
    rows = phase_kernels(rows_fifo, rows_base=2, ctx_fifo=154, ctx_base=77)
    phase_unet_reference()
    shapes, model = phase_main_path(new_video_length, num_partitions)
    phase_profile(model, rows_fifo, ctx_len=154)

    for name, by_shape in shapes.items():
        checked = {r["shape"] for r in rows if r["name"].startswith(name)}
        unchecked = set(by_shape) - checked
        if unchecked:
            fail(f"main path gave {name} shapes not held to the plain version: {unchecked}")
    for r in rows:
        kernel = r["name"].split()[0]
        r["launches"] = shapes[kernel].get(r.pop("shape"), 0)
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
