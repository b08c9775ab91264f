"""GPU smoke of the PyTorch/CUDA port (moca_tpu_torch) on one NVIDIA card.

Phases, each failing loudly (non-zero exit, no result line):
  1. print the card's name and power limit, build the CUDA kernels from
     moca_tpu_torch/csrc with nvcc (sm_90a) and print the build time, each
     library's registers and spill, and K3's by instantiation (its fp32
     path and its bf16 path);
  2. hold each kernel to its plain PyTorch version at every shape the main
     path gives it, with and without the reference's attention switches
     (K1 also on adversarial softmax inputs; K2 also at full width at every
     kind of head width `_packed_tiny_kernel` takes, K2_WIDTH_ROWS, in bf16
     and fp32, at d = 32 and 128, and at every shape phase 3's
     num_head_channels=32 and 20 U-Nets and phase 5's num_head_channels=160
     forward give it; its rows carry the design the wrapper chose, `path`,
     and where both designs take the width, both times, `path_ms`; and the
     CUDA-event time of an empty launch, K2's launch floor), show that
     faults planted through the kernel's inputs fail that check, and time
     the kernel, the plain version and one PyTorch
     library call for the same work (for K3 multi_head_attention_forward with
     separate projection weights, beside the port's unfused route); K3 and K4
     also at shapes no run launches: K3 with a ragged last tile, below one
     tile, with its heads split over a cluster and a ragged last tile, and at
     C=512 for S=8/24/32 (its rows carry the path taken and the cluster
     size); K4 at a ragged Sk and on a long row. K1 and K4 are held to their
     plain versions and timed on each of their designs (mma.sync, wgmma with
     64- and 128-row kv tiles); their rows carry the design the library
     chose at that shape (`path`) and every design's time (`path_ms`). K1
     and K4 also run the adversarial softmax inputs on every design. The
     fp32 path of every kernel is held the same way to its plain version in
     full fp32 (FP32_KERNEL_TOL, the same planted faults) at the shapes the
     fp32 runs (phases 3, 5 and 14) give it, and timed beside its bf16 path
     on the same inputs, SDPA (K3: multi_head_attention_forward) in fp32 and
     a bound at the 3xTF32 ceiling of the tensor cores (K3's fp32 rows also
     with a ragged last tile; each K3 row prints its share of the bound and
     its path, head split or not);
  3. check the port's U-Net with the kernels (bf16, GPU) against its plain
     path (fp32, CPU) on a small input, three times: as it ships; with
     MOCA_TPU_FA_FUSED_QKV=1 MOCA_TPU_FA_ONEPASS=1 and a 154-token context
     (K3, K4); at num_head_channels=32 and 20 (K2 at d=32 and d=20, inner
     widths 60 and 120 at 64 and 128 channels; launch counts set to 0 just
     before and read just after); then the fp32 U-Net on the card
     (every kernel's fp32 path) against the same CPU forward, as it ships
     and with both switches (FP32_UNET_REL_TOL);
  4. drive the main path twice: MoCAVideoPipeline at the shipped
     VideoCrafter2 widths, random bf16 weights, 512x320, f=16, n=4 with
     lookahead, guidance 12, concept image, conditioned prompt and masks,
     first as it ships (K1, K2), then with both switches (K1, K3, K4), with
     every kernel's launch count set to 0 just before each run and read just
     after; every shape that a kernel received in these two runs or in the
     d=32 and d=20 U-Nets must have been held to its plain version in phase 2;
  5. time one FIFO U-Net forward with and without the switches, break each
     one's device time down by kernel category and read the device's idle
     share, from one torch.profiler trace each, and compare the two outputs;
     then one full-width fp32 forward (a copy of the model in fp32) at the
     golden clip's 8 FIFO rows, as shipped and with MOCA_TPU_FA_FUSED_QKV=1
     (K3's fp32 path at every temporal width), each timed and its launches
     counted over one forward, the two outputs within FP32_UNET_REL_TOL;
     last, one bf16 forward at the shipped widths but num_head_channels=160
     (16 rows, context 154): K2 at every temporal and init attention (2, 4
     and 8 heads of 160; the init attention's 8 at C=1280) and nothing else
     (the spatial attention plain, as XLA in the reference), timed, and held
     within SWITCHED_REL_TOL to the same forward with packed_attention
     swapped for its plain version by this script;
  6. DAVIS mode on the same model, as shipped: 72 frames [72, 320, 512, 3]
     in [-1, 1] and 72 masks (a moving 20 x 32 rectangle at 40 x 64) made
     from the seed with numpy, encoded on the card with `encode_frames`
     (one frame's moments, bf16 on the card, held to the fp32 encoder on
     the CPU), then MoCAVideoPipeline with the encoded latents, the masks
     and the frames as tail anchors;
  7. open vocab on the same model, as shipped: the host seconds until one
     FIFO iteration's launch returns beside its device seconds; then prompt
     mode with a CallbackMaskProvider whose detector thresholds the frame
     and sleeps 0.2 s an iteration (spread over the iteration's low-t
     frames), with `seg_async` and a snapshot every 16 iterations; its
     mask_provider and fifo_iteration stage seconds beside the same call
     without a provider, to show whether the provider's time hides;
  8. batch text-to-video through moca_tpu_torch.cli.inference.main on the
     same model: 4 prompts in a file, one --bs 4 round at 512x320, f=16,
     50 DDIM steps, eta 1, guidance 12, fps 28 (the CLI's defaults), mp4s
     under build/; then --bs 1 on prompts 0 and 1 with the same seed:
     prompt 0's clip held to the round's (BATCH_REL_TOL; the planted fault
     is prompt 1, which drew its own index's noise there, against the
     round's);
  9. the T2V variants at full width, B=1, 10 DDIM steps: cfg_ours with
     temporal guidance (and one forward with no_temporal_attn, which must
     launch no K2), uncond_type='zero_embed', FreeInit with 2 iterations;
     then DDPM at 128x128 through the CLI, on a DDPM_STEPS-step schedule
     (cut from 1000);
 10. MoCA with B=2 prompts at full width (32 U-Net rows an iteration), as
     many new frames as phase 4 (cut from 16), then prompt 0 alone at the
     same length and seed, held to
     stream 0 (BATCH_REL_TOL; the planted fault is stream 0 regrouped from
     the frame list with the wrong stride);
 11. the i2v model: phase 3's check on the U-Net with image cross-attention
     at 77 + 16 context tokens (the planted fault: the image tokens zeroed);
     then the full-width i2v model (the shipped U-Net with
     use_image_attention, ViT-H/14 and the finegrained Resampler, random
     weights from the seed; tower and Resampler fp32) through
     moca_tpu_torch.cli.inference.main --mode i2v: 2 prompts, 2 PNGs made
     with numpy, 512x320, f=16, guidance 12, 10 DDIM steps (cut from 50);
     the tower's pooled and token outputs and the image tokens [1, 16, 1024]
     on the card held to the fp32 CPU tower (VISION_REL_TOL);
 12. the evaluation sweep, moca_tpu_torch.cli.eval_sweep.main, on phase 4's
     model: a 2-row prompt CSV, concept PNGs and random tower checkpoints
     (OpenCLIP visual, {'alexnet', 'lpips'}, pytorch-i3d, the text tower
     with its last block and text_projection) written under build/; the
     CLIP text `embed`, AlexNet-LPIPS and I3D on the card held to fp32 on
     the CPU, FVD of a set against itself and a shifted set; MoCA at f=16,
     n=1 (16 steps, cut from the sweep's n=4), 16 new frames a row; the
     metrics JSON must have the JAX sweep's keys;
 13. the mesh (parallel/mesh.py) on the one card: (a) two spawned gloo ranks
     on cuda:0 (a FileStore under build/), each building phase 4's model,
     run phase 4's call on MoCAVideoPipeline(mesh=make_mesh((1, 2))), each
     computing 8 of the 16 U-Net rows; rank 0's frames are held to phase
     4's one-process run (MESH_REL_TOL), the ranks' frames must be
     identical, each rank's gathered U-Net (16 rows) and decode (8 latents)
     outputs on random rows are held to the whole calls (BATCH_REL_TOL; the
     planted fault: the two ranks' blocks swapped in the gather), and each rank's K1/K2 launches must be phase
     4's at half the rows; each rank's steady s an iteration, peak memory
     and the gather's ms are printed (two ranks share one card's SMs: no
     speedup is expected); (b) moca_tpu_torch.cli.main --mesh 1,1 in a child under
     torchrun's environment (env://, NCCL, one rank) at n=1, 2 new frames;
     (c) --mesh 1,2 without WORLD_SIZE=2 must raise the ValueError;
 14. the user scripts (moca_tpu_torch/cli/): (a) the acceptance
     certification, cli.acceptance.main, on a synthetic full-size
     checkpoint in the upstream layout (random fp32 weights from the seed,
     written under build/ and deleted after (b)) and a four-merge BPE table,
     fp32 by default, 512x320, f=16, n=ACCEPT_PARTITIONS with
     ACCEPT_NEW_FRAMES new frames (cut from 4 and 16), --skip_oracles, its
     own golden_frames.npz as the reference: exit 0 with convert,
     tokenizer, golden and ssim ok and the fp32 paths of K1 and K2
     launched; a planted fault (the golden frames rolled by W/4, or seeded
     noise where random weights leave them too flat for that to read) must
     fail `stage_ssim` on the same golden array; (b)
     cli.generate_condition_images.main on two CSV rows at its defaults
     (512x320, 50 steps, bf16): two RGBA PNGs of 512x320 that differ;
     (c) cli.v2i and cli.convert_gifs on phase 6's 72 frames written as an
     mp4 and a gif, held to io/video.py's reading frame for frame; (d)
     cli.verify_drive on the card.
Phase 6 also holds the host library's (io/fastio.py) conversions and
packing of the 72 frames to numpy and times both (io/video.py takes the
library's uint8 -> float only, the one it is faster at); phase 7's
run with the provider runs with MOCA_TPU_PROFILE=1 and must print the
pipeline's {"profile": ...} line with the JAX package's stage names.
Phase 2 also holds K1 and K2 (and K3/K4, as the switches would send them)
at every shape that phases 8-14 give them. Phases 4 and 6-14 set every
kernel's launch count to 0 just before each run and read it just after; every
shape a kernel received must have been held to its plain version in phase 2.
Every phase prints its seconds. Prints a JSON line of kernel measurements,
then as the last line {"ok": true, "device": {...}}.

Phase 2b holds the norms' kernels (GroupNorm(+SiLU) and LayerNorm,
csrc/norms.cu) to their plain versions at every shape one forward of the
shipped U-Net gives them at the stream's 16 rows and the clip's 2, and times
each beside its bytes bound, the plain version and F.group_norm /
F.layer_norm (`library_ms`, a yardstick only); `[norm summary]` sums them
over one U-Net call, and `[norm host]` gives each wrapper's host cost a call
beside its plain chain's and a PyTorch `x + 1`. The runs of phases 3-14 read
the norms' launch tallies beside K1-K4's, and phase 15 holds every norm shape
they gave that phase 2b did not; the norms' rows join the JSON line and the
launch-weighted summary.

Phase 2c does the same for the feed-forward's GEGLU (csrc/geglu.cu) at every
shape one U-Net call of each benchmark cell gives it (`GEGLU_CALLS`), timed
beside its bytes bound, the plain version and the library's own chain (F.gelu
on the gate's view, then the product); `[geglu summary]` sums them over one
U-Net call, and `[geglu host]` gives the wrapper's host cost a call. Its tally joins the runs' readings, and phase 15 holds its other
shapes too.

Phase 2d holds MoCA's window step over every FIFO window (csrc/moca_scan.cu)
to the per-window loop on the same card and noise (SCAN_TOL, the momentum
dropped as its planted fault) at the stream's shape and at two rows, and
times the launch beside its bytes bound, the plain loop and the scan's route
(the draws and the launch); `[moca summary]` gives the stream's iteration
and `[moca host]` the host's cost a call. From phase 2d on, every run's
`_launches` fails unless each FIFO step on a CUDA queue launched the scan
once and none ran the loop; `[moca scan tally]` at the end lists each
MoCA run's steps and launches (phase 13's ranks too), and phase 15 holds the
runs' other scan shapes.

Usage: python3 chip_smoke.py [new_video_length (default 4)]
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import math
import os
import re
import subprocess
import sys
import time

# the card's peaks (bf16 tensor cores, 3xTF32 for the fp32 paths, HBM3) and the
# kernel categories of a trace: the benchmark's own
from benchmark.flops import H100_BF16_FLOPS, H100_BYTES_PER_S, H100_FP32_FLOPS
from benchmark.trace import category
from moca_tpu_torch.ops import cuda_libs

# Largest relative L2 error of one output row (the 64-vector of one query and
# head) against the plain version. Kernel and plain version round the
# probabilities and the output to bf16 at different points, a few 2^-8
# relative; a kernel that leaves out the last kv tile or key, or halves the
# softmax scale, is off by far more, and every check plants those faults
# through the kernel's inputs to show that it fails them.
KERNEL_TOL = 2e-2
# The fp32 paths against their plain versions in full fp32 (TF32 off), the
# same row measure: both sum fp32 products in other orders (a few 1e-6
# relative at the main path's shapes); plain TF32 products would round each
# input to a 2^-11 (4.9e-4) unit, which the limit does not admit.
FP32_KERNEL_TOL = 1e-4
UNET_REL_TOL = 5e-2  # bf16 GPU forward vs fp32 CPU forward, relative to max |ref|
# The fp32 U-Net on the card (its kernels' fp32 paths; fp32 convolutions in
# TF32, torch.backends.cudnn.allow_tf32 as it stands, True; matmuls in full
# fp32, allow_tf32 False) against the fp32 CPU forward, same measure: it read
# 2.18e-4 as shipped and 2.28e-4 with both switches on an H100 80GB HBM3
# (PERF.md), the TF32 convolutions' rounding; the limit is ~9x that.
FP32_UNET_REL_TOL = 2e-3
SEED = 0
SEG_SLEEP_S = 0.2  # the stand-in detector's time per FIFO iteration
# The switched full-width forward against the default one on the same input,
# relative to max |default|: both are bf16 forwards of the same function whose
# attention rounds at different points (K3 adds the bias after rounding, K4
# rounds the scaled q); the same limit as the bf16-vs-fp32 check above.
SWITCHED_REL_TOL = 5e-2
SWITCHES = {"MOCA_TPU_FA_FUSED_QKV": "1", "MOCA_TPU_FA_ONEPASS": "1"}
FUSED_ONLY = {"MOCA_TPU_FA_FUSED_QKV": "1"}
# A batched run's clip against the single run of its prompt with the same
# noise, relative L2 over the clip: the bf16 products round differently at
# another batch size (cuBLAS picks its kernel by the row count), and the
# samplers carry that through every step (3.3e-3 for T2V --bs 4 against
# --bs 1, 3.1e-3 for MoCA B=2 against B=1 on an H100; the limit is 6x). With
# random weights another prompt's clip of the same batch reads the same
# against that run (the text moves a clip no more than the rounding does),
# so the planted faults are the ones the checks exist to catch: a clip drawn
# from another prompt index's noise (a wrong noise mapping) and a stream
# regrouped from the iteration-major frame list with the wrong stride.
# Another prompt's reading is printed beside them.
BATCH_REL_TOL = 2e-2
# Phase 13: rank 0's frames against phase 4's one-process run. The sound run
# differs by bf16 rounding at 8 U-Net rows against 16 (3.074e-3 on an H100
# 80GB HBM3, 700 W, the same in every run); the limit is 2.6x that. It has no
# planted fault of its own: random weights make the U-Net's output depend
# little on its row's input, so a whole run with the two ranks' U-Net blocks
# (windows 0-3 and 4-7, both CFG rows each) swapped read 3.784e-3 (PERF.md,
# PR 8). The gathers' order is held where it shows, on rows that all differ.
MESH_REL_TOL = 8e-3
# DDPM's schedule in phase 9, cut from the model's 1000 steps: at 128x128 a
# step is host-bound (74-103 ms, PERF.md section 5), and the script must end
# well inside its time limit.
DDPM_STEPS = 250
KERNEL_NAMES = ("flash_attention", "packed_attention", "fused_qkv_attention",
                "flash_attention_onepass")


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


@contextlib.contextmanager
def switches_on(switches=None):
    """The reference's attention switches (`SWITCHES` unless named), as its
    users set them."""
    switches = SWITCHES if switches is None else switches
    old = {k: os.environ.get(k) for k in switches}
    os.environ.update(switches)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def profile_env():
    """MOCA_TPU_PROFILE=1: the pipeline prints its {"profile": ...} line."""
    old = os.environ.get("MOCA_TPU_PROFILE")
    os.environ["MOCA_TPU_PROFILE"] = "1"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("MOCA_TPU_PROFILE")
        else:
            os.environ["MOCA_TPU_PROFILE"] = old


PROFILE_STAGES = {"fifo_iteration", "decode", "mask_provider"}  # moca_tpu's StepTimer stages


def check_profile_line(stdout: str):
    """Fails unless the run printed one {"profile": ...} line holding the JAX
    package's stage names, each with count, total_s, mean_s and min_s."""
    lines = [json.loads(line) for line in stdout.splitlines() if line.startswith('{"profile"')]
    stages = lines[0]["profile"] if len(lines) == 1 else {}
    if not PROFILE_STAGES <= set(stages) or any(
            set(v) != {"count", "total_s", "mean_s", "min_s"} for v in stages.values()):
        fail(f"MOCA_TPU_PROFILE=1: want one profile line with {sorted(PROFILE_STAGES)}, "
             f"got {stdout[-2000:]!r}")
    print(f"[profile line] {json.dumps(lines[0])}", flush=True)


def max_row_rel_err(out, ref, d=64):
    """max over rows of ||out - ref|| / ||ref||, rows being d-vectors."""
    out, ref = out.float().reshape(-1, d), ref.float().reshape(-1, d)
    ref_norm = ref.norm(dim=1)
    return ((out - ref).norm(dim=1) / ref_norm.clamp_min(1e-6 * ref_norm.max())).max().item()


def kernel_tol(dtype):
    import torch

    return FP32_KERNEL_TOL if dtype == torch.float32 else KERNEL_TOL


def hold_to_plain(what, out, ref, faults=(), d=64, tol=KERNEL_TOL):
    """Fail unless out is finite and within `tol` of ref, and every planted
    fault is beyond it (rows of d values). Returns (row error, smallest
    fault error)."""
    import torch

    err = max_row_rel_err(out, ref, d)
    if not torch.isfinite(out.float()).all() or not err <= tol:
        fail(f"{what}: finite={bool(torch.isfinite(out.float()).all())}, "
             f"row relative err {err} > {tol}")
    fault_err = min((max_row_rel_err(f, ref, d) for f in faults), default=math.inf)
    if not fault_err > tol:
        fail(f"{what}: a planted fault reads {fault_err} <= {tol}; the check cannot "
             f"tell it from a sound kernel")
    return err, fault_err


def peak_flops(dtype):
    """The peak of the fastest unit for a kernel path's products: the bf16
    tensor cores, or for the fp32 paths the tensor cores in 3xTF32 (the
    fastest unit that keeps fp32 accuracy), whatever the path runs on."""
    import torch

    return H100_FP32_FLOPS if dtype == torch.float32 else H100_BF16_FLOPS


def attention_bound_ms(q, k, v):
    """The least time of attention(q [B,Sq,H,D], k, v [B,Sk,H,D]) on the card:
    the larger of its bytes (each input read once, the output written once)
    over the memory rate and its QK^T + PV operations (4*B*H*Sq*Sk*D) over
    the peak of the unit the path uses (`peak_flops`). Returns (ms, what
    bounds it)."""
    b, sq, h, d = q.shape
    flops = 4 * b * h * sq * k.shape[1] * d
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
    t_ops, t_bytes = flops / peak_flops(q.dtype), nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def fused_qkv_bound_ms(n, s, c, dtype):
    """The least time of K3's function on the card: its four C x C
    projections and the S x S attention (8*N*S*C^2 + 4*N*S^2*C operations)
    over the peak of the unit the path uses, or x and o once, the four
    weights and the bias (2*N*S*C + 4*C^2 + C values) over the memory rate."""
    import torch

    flops = 8 * n * s * c * c + 4 * n * s * s * c
    nbytes = (2 * n * s * c + 4 * c * c + c) * (4 if dtype == torch.float32 else 2)
    t_ops, t_bytes = flops / peak_flops(dtype), nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


@contextlib.contextmanager
def full_fp32():
    """fp32 matmuls in full fp32 (no TF32) while a plain version runs."""
    import torch

    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def fp32_launches(by_shape) -> int:
    """Launches of a kernel's fp32 path in a {shape: n} tally."""
    return sum(n for sh, n in by_shape.items() if sh[-1] == "fp32")


def phase_build():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    t0 = time.perf_counter()
    cuda_libs.build_kernels()
    for name in cuda_libs.LIBRARIES:
        cuda_libs.load_library(name)
    nvcc_s = {k: round(v["seconds"], 1) for k, v in cuda_libs.build_log.items()}
    print(f"[build] kernels ready in {time.perf_counter() - t0:.1f} s "
          f"(nvcc: {json.dumps(nvcc_s)})", flush=True)
    for name, log in cuda_libs.build_log.items():
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log["ptxas"])]
        spills = [line.strip() for line in log["ptxas"].splitlines()
                  if "spill" in line and not line.strip().startswith("0 bytes stack frame, 0 bytes spill")]
        print(f"[ptxas {name}] {len(regs)} kernels, registers {min(regs, default=0)}-"
              f"{max(regs, default=0)}, spills: {spills or 'none'}", flush=True)
    if "fused" in cuda_libs.build_log:  # K3 by instantiation: its fp32 path and its bf16 path
        for kernel, regs, spill in ptxas_kernels(cuda_libs.build_log["fused"]["ptxas"]):
            print(f"[ptxas fused] {kernel}: {regs} registers, {spill}", flush=True)


def ptxas_kernels(log: str):
    """(kernel<template arguments>, registers, spill line) of each entry
    function in an `nvcc -Xptxas -v` log."""
    out, kernel, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel = _kernel_name(m.group(1))
        elif kernel and "bytes spill" in line:
            spill = line.strip()
        elif kernel and "Used" in line:
            out.append((kernel, int(re.search(r"Used (\d+) registers", line).group(1)), spill))
            kernel = None
    return out


def _kernel_name(sym: str) -> str:
    """ns::name<args> of a mangled kernel symbol with integer and bool
    template arguments (anonymous namespaces left out)."""
    if not sym.startswith("_ZN"):
        return sym
    i, parts = 3, []
    while i < len(sym) and sym[i].isdigit():
        j = i
        while sym[j].isdigit():
            j += 1
        parts.append(sym[j:j + int(sym[i:j])])
        i = j + int(sym[i:j])
    args = re.match(r"I((?:L[ib]\d+E)+)E", sym[i:])
    name = "::".join(part for part in parts if not part.startswith("_GLOBAL__N"))
    if not args:
        return name
    return name + "<" + ",".join(re.findall(r"L[ib](\d+)E", args.group(1))) + ">"


def _randn(shape, gen, dtype=None):
    """N(0, 1) on the card from `gen`, in `dtype` (bf16 by default)."""
    import torch

    return torch.randn(shape, generator=gen, device="cuda").to(dtype or torch.bfloat16)


def _fp32_tag(dtype):
    """The launch tally's shape suffix for `dtype`: ("fp32",) on the fp32
    path, else ()."""
    import torch

    return ("fp32",) if dtype == torch.float32 else ()


def _chunked(fn, q, k, v, chunk):
    import torch

    return torch.cat([fn(q[i:i + chunk], k[i:i + chunk], v[i:i + chunk])
                      for i in range(0, q.shape[0], chunk)])


def check_flash(b, sq, sk, h, gen, rows, reps=10, onepass=False, dtype=None):
    """K1 (or K4 with `onepass`) at q [b, sq, h, 64] over k, v [b, sk, h, 64]
    in `dtype` (bf16 by default) against its plain version (batch-chunked:
    the plain fp32 logits at b=256, s=2560 would take 33.5 GB; in full fp32
    for the fp32 path), on the design its library chooses and, held to the
    same check and timed beside it, on each of the others. The fp32 path
    has one design; its row also carries the bf16 path's time on the same
    inputs (`bf16_ms`)."""
    import torch
    import torch.nn.functional as F
    from moca_tpu_torch.ops import flash_attention as fa

    dtype = dtype or torch.bfloat16
    fp32 = dtype == torch.float32
    tol, tag = kernel_tol(dtype), _fp32_tag(dtype)
    kernel = fa.flash_attention_onepass if onepass else fa.flash_attention
    plain = fa.flash_attention_onepass_plain if onepass else fa.attention_plain
    lib_name = "onepass" if onepass else "flash"
    label = ("K4 flash_attention_onepass" if onepass else "K1 flash_attention") + " fp32" * fp32
    path = "fp32_tf32x3" if fp32 else fa.attention_path(lib_name, b, sq, sk, h, 64)
    q, k, v = (_randn((b, s, h, 64), gen, dtype) for s in (sq, sk, sk))
    chunk = max(1, (2 << 30) // (h * sq * sk * 4))
    out = kernel(q, k, v)
    torch.cuda.synchronize()
    with full_fp32():
        ref = _chunked(plain, q, k, v, chunk)
    cut = sk - 64  # planted faults: the last 64 kv rows left out; the scale halved
    faults = (kernel(q, k[:, :cut].contiguous(), v[:, :cut].contiguous()), kernel(q * 0.5, k, v))
    rel, fault_rel = hold_to_plain(f"{label} [{b},{sq},{sk},{h},64] ({path})", out, ref, faults,
                                   tol=tol)
    del faults
    err = (out.float() - ref.float()).abs().max().item()
    ms = cuda_ms(lambda: kernel(q, k, v), reps)
    path_ms, extra = {}, {}
    for other in () if fp32 else fa.ATTENTION_PATHS:  # every design, held to the same check
        run = lambda: fa._attention_call(kernel, lib_name, q, k, v, path=other)
        other_out = run()
        faults = (fa._attention_call(kernel, lib_name, q, k[:, :cut].contiguous(),
                                     v[:, :cut].contiguous(), path=other),
                  fa._attention_call(kernel, lib_name, q * 0.5, k, v, path=other))
        hold_to_plain(f"{label} [{b},{sq},{sk},{h},64] ({other})", other_out, ref, faults)
        del faults, other_out
        path_ms[other] = cuda_ms(run, reps)
    if fp32:
        qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
        extra["bf16_ms"] = cuda_ms(lambda: kernel(qb, kb, vb), reps)
        del qb, kb, vb
    with full_fp32():
        plain_ms = cuda_ms(lambda: _chunked(plain, q, k, v, chunk), 2, warmup=1)
        tr = lambda t: t.transpose(1, 2)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(tr(q), tr(k), tr(v)), reps)
    bms, by = attention_bound_ms(q, k, v)
    print(f"[{label} B={b} Sq={sq} Sk={sk} H={h} D=64 ({path})] row_rel_err {rel:.3e} "
          f"(tol {tol}, planted faults >= {fault_rel:.3e}) max_abs_err {err:.3e} "
          f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms sdpa {lib_ms:.4f} ms "
          f"bound {bms:.4f} ms ({by}); "
          + (f"bf16 path {extra['bf16_ms']:.4f} ms" if fp32 else
             f"designs {json.dumps({p_: round(t, 4) for p_, t in path_ms.items()})}"), flush=True)
    if fp32:
        source = "moca_tpu_torch/csrc/attention_f32.cuh"
    elif onepass:
        source = "moca_tpu_torch/csrc/flash_onepass.cu"
    else:
        source = "moca_tpu_torch/csrc/flash_attention.cu"
    small = not onepass and sq == sk and sq <= 640  # the reference's _small_attention route
    replaces = ("moca_tpu/ops/flash_attention.py:713 (_fa_onepass_kernel)" if onepass else
                "moca_tpu/ops/flash_attention.py:298 (_fa_small_kernel)" if small else
                "moca_tpu/ops/flash_attention.py:765 (_fa_kernel)")
    rows.append(dict(name=f"{kernel.__name__}{' fp32' * fp32} B={b} Sq={sq} Sk={sk} H={h} D=64",
                     route="cuda", source=source, replaces=replaces,
                     shape=(b, sq, sk, h, 64) + tag, max_abs_err=err, max_row_rel_err=rel,
                     fault_row_rel_err=fault_rel, ms=ms, plain_ms=plain_ms,
                     bound_ms=bms, bound_by=by, library_ms=lib_ms, path=path,
                     path_ms=path_ms, **extra))


def check_flash_adversarial(gen):
    """K1 and K4 on the softmax hazards of tests/test_flash_attention.py:212-228,
    on each of their designs: finite output that matches the plain version."""
    from moca_tpu_torch.ops import flash_attention as fa

    b, h, d = 2, 2, 64
    kernels = ((fa.flash_attention, "flash", fa.attention_plain),
               (fa.flash_attention_onepass, "onepass", fa.flash_attention_onepass_plain))
    for s, kind in itertools.product((256, 640), ("overflow", "underflow", "denom_overflow")):
        q, k, v = (_randn((b, s, h, d), gen) for _ in range(3))
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
        for kernel, lib_name, plain in kernels:
            ref = plain(q, k, v)
            rels = {path: hold_to_plain(f"{kernel.__name__} adversarial {kind} S={s} ({path})",
                                        fa._attention_call(kernel, lib_name, q, k, v, path=path),
                                        ref)[0]
                    for path in fa.ATTENTION_PATHS}
            print(f"[{kernel.__name__} adversarial {kind} S={s}] finite, row_rel_err "
                  f"{json.dumps({p_: float(f'{r:.3e}') for p_, r in rels.items()})} "
                  f"(tol {KERNEL_TOL})", flush=True)


def check_packed(n, s, c, gen, rows, reps=20, d=64, dtype=None):
    """K2 at [n, s, c] with heads of d in `dtype` (bf16 by default) against
    its plain version (in full fp32 for the fp32 path, whose row also carries
    the bf16 path's time on the same inputs), on the design the wrapper
    picks (`path`) and, where the other takes the width too, on that one,
    held to the same check and timed beside it (`path_ms`)."""
    import torch
    import torch.nn.functional as F
    from moca_tpu_torch.ops import flash_attention as fa

    dtype = dtype or torch.bfloat16
    fp32 = dtype == torch.float32
    tol, tag = kernel_tol(dtype), _fp32_tag(dtype)
    heads = c // d
    path = fa.packed_attention_path(d)
    label = f"packed_attention{' fp32' * fp32} [{n},{s},{c}] d={d}"
    q, k, v = (_randn((n, s, c), gen, dtype) for _ in range(3))
    out = fa.packed_attention(q, k, v, heads)
    with full_fp32():
        ref = fa.packed_attention_plain(q, k, v, heads)
    v_cut = v.clone()
    v_cut[:, -1] = 0  # planted faults: the last key left out of PV; the scale halved
    faults = (fa.packed_attention(q, k, v_cut, heads), fa.packed_attention(q * 0.5, k, v, heads))
    rel, fault_rel = hold_to_plain(f"{label} ({path})", out, ref, faults, d, tol=tol)
    del faults
    err = (out.float() - ref.float()).abs().max().item()
    ms = cuda_ms(lambda: fa.packed_attention(q, k, v, heads), reps)
    path_ms = {path: ms}
    for other in fa.PACKED_PATHS:  # the other design, where it takes d
        if other == path or (other == "head_tile" and not (d % 8 == 0 and d <= 128)):
            continue
        faults = (fa._packed_call(q, k, v_cut, heads, path=other),
                  fa._packed_call(q * 0.5, k, v, heads, path=other))
        hold_to_plain(f"{label} ({other})", fa._packed_call(q, k, v, heads, path=other),
                      ref, faults, d, tol=tol)
        del faults
        path_ms[other] = cuda_ms(lambda: fa._packed_call(q, k, v, heads, path=other), reps)
    del v_cut
    extra = {}
    if fp32:
        qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
        extra["bf16_ms"] = cuda_ms(lambda: fa.packed_attention(qb, kb, vb, heads), reps)
        del qb, kb, vb
    split = lambda t: t.view(n, s, heads, d)
    with full_fp32():
        plain_ms = cuda_ms(lambda: fa.packed_attention_plain(q, k, v, heads), 3, warmup=1)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            split(q).transpose(1, 2), split(k).transpose(1, 2), split(v).transpose(1, 2)), reps)
    bms, by = attention_bound_ms(split(q), split(k), split(v))
    print(f"[K2 packed_attention{' fp32' * fp32} N={n} S={s} C={c} d={d} ({path})] row_rel_err "
          f"{rel:.3e} (tol {tol}, planted faults >= {fault_rel:.3e}) max_abs_err {err:.3e} "
          f"kernel {ms:.4f} ms ({100 * bms / ms:.1f} % of bound) plain {plain_ms:.4f} ms sdpa "
          f"{lib_ms:.4f} ms bound {bms:.4f} ms ({by}); designs "
          f"{json.dumps({p_: round(t, 4) for p_, t in path_ms.items()})}"
          + (f"; bf16 path {extra['bf16_ms']:.4f} ms" if fp32 else ""), flush=True)
    if d != 64:
        replaces = "moca_tpu/ops/flash_attention.py:614 (_packed_tiny_kernel)"
    elif c == 320:
        replaces = "moca_tpu/ops/flash_attention.py:614 (_packed_slice_kernel)"
    else:
        replaces = "moca_tpu/ops/flash_attention.py:559 (_packed_lane_kernel)"
    rows.append(dict(name=f"packed_attention{' fp32' * fp32} N={n} S={s} C={c}"
                     + (f" d={d}" if d != 64 else ""),
                     route="cuda", source="moca_tpu_torch/csrc/"
                     + ("packed_span.cu" if path == "span" else "packed_attention.cu"),
                     replaces=replaces, shape=(n, s, c, heads) + tag,
                     max_abs_err=err, max_row_rel_err=rel,
                     fault_row_rel_err=fault_rel, ms=ms, plain_ms=plain_ms,
                     bound_ms=bms, bound_by=by, library_ms=lib_ms, path=path,
                     path_ms=path_ms, **extra))


def packed_launch_floor(gen):
    """The CUDA-event time of one launch, 200 back to back: an empty kernel
    through K2's library (its ctypes route), and K2 itself through
    `packed_attention` at one [1, 16, 64] row (the wrapper's checks added),
    the floor under K2's smallest rows."""
    import torch
    from moca_tpu_torch.ops import flash_attention as fa

    empty = cuda_libs.load_library("packed").moca_packed_empty
    stream = torch.cuda.current_stream().cuda_stream
    empty_ms = cuda_ms(lambda: empty(stream), 200, warmup=5)
    q = _randn((1, 16, 64), gen)
    k2_ms = cuda_ms(lambda: fa.packed_attention(q, q, q, 1), 200, warmup=5)
    print(f"[K2 launch floor] an empty kernel through the library: {1e3 * empty_ms:.2f} us a "
          f"launch; K2 through packed_attention at [1, 16, 64]: {1e3 * k2_ms:.2f} us a launch "
          f"(CUDA events over 200 launches)", flush=True)


def check_fused(n, s, c, gen, rows, reps=10, dtype=None):
    """K3 at x [n, s, c] in `dtype` (bf16 by default) with weights
    N(0, 1/C), so that q, k, v and the logits are O(1), against its plain
    version (in full fp32 for the fp32 path, whose row also carries the bf16
    path's time on the same inputs). Planted faults: Wq halved, and the last
    head's Wv rows zeroed."""
    import torch
    import torch.nn.functional as F
    from moca_tpu_torch.ops import flash_attention as fa

    dtype = dtype or torch.bfloat16
    fp32 = dtype == torch.float32
    tol, tag = kernel_tol(dtype), _fp32_tag(dtype)
    heads = c // 64
    x = _randn((n, s, c), gen, dtype)
    wq, wk, wv, wo = ((torch.randn((c, c), generator=gen, device="cuda") * c ** -0.5)
                      .to(dtype) for _ in range(4))
    bo = (torch.randn((c,), generator=gen, device="cuda") * 0.1).to(dtype)
    out = fa.fused_qkv_attention(x, wq, wk, wv, wo, bo, heads)
    torch.cuda.synchronize()
    with full_fp32():
        ref = fa.fused_qkv_attention_plain(x, wq, wk, wv, wo, bo, heads)
    wv_cut = wv.clone()
    wv_cut[-64:] = 0
    faults = (fa.fused_qkv_attention(x, wq * 0.5, wk, wv, wo, bo, heads),
              fa.fused_qkv_attention(x, wq, wk, wv_cut, wo, bo, heads))
    rel, fault_rel = hold_to_plain(f"fused_qkv_attention{' fp32' * fp32} [{n},{s},{c}]", out,
                                   ref, faults, tol=tol)
    del faults, wv_cut
    err = (out.float() - ref.float()).abs().max().item()
    ms = cuda_ms(lambda: fa.fused_qkv_attention(x, wq, wk, wv, wo, bo, heads), reps)
    extra = {}
    if fp32:
        xb, wb = x.bfloat16(), [w.bfloat16() for w in (wq, wk, wv, wo, bo)]
        extra["bf16_ms"] = cuda_ms(lambda: fa.fused_qkv_attention(xb, *wb, heads), reps)
        del xb, wb
    # the library call for K3's function (timed only, the port never calls
    # it): torch's multi-head attention on [S, N, C] with the separate q/k/v
    # projection weights, no input bias, and Wo, bo as its out projection
    xt = x.transpose(0, 1)
    library = lambda: F.multi_head_attention_forward(
        xt, xt, xt, c, heads, None, None, None, None, False, 0.0, wo, bo, training=False,
        need_weights=False, use_separate_proj_weight=True, q_proj_weight=wq,
        k_proj_weight=wk, v_proj_weight=wv)[0]
    with full_fp32():
        plain_ms = cuda_ms(lambda: fa.fused_qkv_attention_plain(x, wq, wk, wv, wo, bo, heads),
                           2, warmup=1)
        lib_rel = max_row_rel_err(library().transpose(0, 1), ref)
        lib_ms = cuda_ms(library, reps)
        # and the port's unfused route beside it: four cuBLAS linears around K2
        unfused_ms = cuda_ms(lambda: F.linear(fa.packed_attention(
            F.linear(x, wq), F.linear(x, wk), F.linear(x, wv), heads), wo, bo), reps)
    bms, by = fused_qkv_bound_ms(n, s, c, dtype)
    cl = fa.fused_qkv_head_split(n, s, c, dtype)  # the wrapper's cluster size
    path = ("tf32x3_" if fp32 else "") + ("head_split" if cl > 1 else "tiles")
    print(f"[K3 fused_qkv_attention{' fp32' * fp32} N={n} S={s} C={c} ({path}, cluster {cl})] "
          f"row_rel_err {rel:.3e} (tol {tol}, "
          f"planted faults >= {fault_rel:.3e}) max_abs_err {err:.3e} kernel {ms:.4f} ms "
          f"plain {plain_ms:.4f} ms library (multi_head_attention_forward, row_rel_err "
          f"{lib_rel:.3e} against the plain version) {lib_ms:.4f} ms unfused route (4 linears "
          f"+ K2) {unfused_ms:.4f} ms bound {bms:.4f} ms ({by}, {100 * bms / ms:.1f} % of it)"
          + (f"; bf16 path {extra['bf16_ms']:.4f} ms" if fp32 else ""), flush=True)
    rows.append(dict(name=f"fused_qkv_attention{' fp32' * fp32} N={n} S={s} C={c}",
                     route="cuda", source="moca_tpu_torch/csrc/fused_qkv_attention.cu",
                     replaces="moca_tpu/ops/flash_attention.py:524 (_fused_qkv_kernel)",
                     shape=(n, s, c) + tag, max_abs_err=err, max_row_rel_err=rel,
                     fault_row_rel_err=fault_rel, ms=ms, plain_ms=plain_ms,
                     bound_ms=bms, bound_by=by, library_ms=lib_ms,
                     library_row_rel_err=lib_rel, unfused_route_ms=unfused_ms,
                     path=path, cluster=cl, **extra))


# The norms (ops/norms.py, csrc/norms.cu) against their plain versions: the
# largest |kernel - plain| over the output relative to max |plain|; both round
# once to the input's type (bf16: at most one unit, 2^-8, apart). The limits
# of tests/test_torch_cuda.py's NORM_TOL, by the launch tally's type tag.
NORM_TOL = {"bf16": 1e-2, "fp16": 2e-3, "fp32": 1e-4}
# The (eps, act) pairs the port's networks give the norms: GroupNorm+SiLU at
# 1e-5 (the U-Net's ResBlocks), GroupNorm at 1e-6 (the U-Net's transformers,
# the VAE); LayerNorm at 1e-5.
NORM_SETTINGS = {"group_norm": ((1e-5, "silu"), (1e-6, None)), "layer_norm": ((1e-5, None),)}
NORM_REPLACES = {"group_norm": "none; stands beside moca_tpu/ops/norms.py (GroupNorm32)",
                 "layer_norm": "none; stands beside moca_tpu/models/unet3d.py (_LayerNorm32)"}


def norm_calls(unet, rows: int, lat=(40, 64), f: int = 16, ctx: int = 154):
    """One forward of `unet` at `rows` rows of f frames on an h x w latent:
    ({(kind, tally key): {(eps, act), ...}}, {kind: {tally key: calls}} as
    forward hooks on every GroupNorm32 and LayerNorm32 saw them,
    {kind: {tally key: launches}} as the wrappers' tallies read them, the
    calls whose input the wrapper had to copy first)."""
    import collections

    import torch
    from moca_tpu_torch.ops import norms as tn

    settings = collections.defaultdict(set)
    calls = {fn.__name__: collections.Counter() for fn in (tn.group_norm, tn.layer_norm)}
    copied = [0]

    def hook(mod, args):
        x = args[0]
        copied[0] += not x.is_contiguous()
        if isinstance(mod, tn.GroupNorm32):
            n, c = x.shape[0], x.shape[-1]
            kind, shape, act = "group_norm", (n, x.numel() // (n * c), c, mod.groups), mod.act
        else:
            kind, shape, act = "layer_norm", (x.numel() // x.shape[-1], x.shape[-1]), None
        key = cuda_libs.launch_key(shape, x.dtype)
        settings[kind, key].add((mod.eps, act))
        calls[kind][key] += 1

    handles = [m.register_forward_pre_hook(hook) for m in unet.modules()
               if isinstance(m, (tn.GroupNorm32, tn.LayerNorm32))]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = _randn((rows, f) + tuple(lat) + (4,), gen)
    reset_counts()
    with torch.inference_mode():
        unet(x, torch.full((rows, f), 500, device="cuda", dtype=torch.long),
             _randn((rows, ctx, 1024), gen), fps=16)
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    launched = {fn.__name__: dict(fn.launches) for fn in (tn.group_norm, tn.layer_norm)}
    return settings, {k: dict(v) for k, v in calls.items()}, launched, copied[0]


def check_norm(kind, key, settings, gen, rows, reps=10):
    """The norm `kind` at its launch tally's `key` ((N, M, C, groups) or
    (R, C), with the type's tag) against its plain version at every (eps,
    act) of `settings`, with a planted fault (weight and bias swapped); timed
    at the first setting beside the plain version and one PyTorch call for
    the same work (F.group_norm on the channels-last view, then F.silu;
    F.layer_norm), with its bytes bound (one read for the statistics, one
    read and one write to apply: 6 bytes an element in bf16; 4 for
    LayerNorm). Appends a row of the kernel measurements; returns (ms,
    bound_ms, plain_ms, library_ms)."""
    import torch
    import torch.nn.functional as F
    from moca_tpu_torch.ops import norms as tn

    tag = key[-1] if isinstance(key[-1], str) else "bf16"
    dims = key[:-1] if isinstance(key[-1], str) else key
    dtype = {"bf16": torch.bfloat16, "fp16": torch.float16, "fp32": torch.float32}[tag]
    tol = NORM_TOL[tag]
    shape = dims[:3] if kind == "group_norm" else dims
    c = shape[-1]
    x = (_randn(shape, gen, torch.float32) * 2 + 0.5).to(dtype)
    w = (1 + 0.3 * _randn((c,), gen, torch.float32)).to(dtype)
    b = (0.5 * _randn((c,), gen, torch.float32)).to(dtype)
    if kind == "group_norm":
        groups = dims[3]
        run = lambda w_, b_, eps, act: tn.group_norm(x, w_, b_, groups, eps, act)
        plain = lambda eps, act: tn.group_norm_plain(x, w, b, groups, eps, act)
        xl = x.reshape(shape[0], shape[1], 1, c).permute(0, 3, 1, 2)  # NCHW, channels-last
        lib = lambda eps, act: (F.silu if act else (lambda t: t))(F.group_norm(xl, groups, w, b,
                                                                               eps))
        passes, label = 3, f"N={shape[0]} M={shape[1]} C={c} groups={groups}"
    else:
        run = lambda w_, b_, eps, act: tn.layer_norm(x, w_, b_, eps)
        plain = lambda eps, act: tn.layer_norm_plain(x, w, b, eps)
        lib = lambda eps, act: F.layer_norm(x, (c,), w, b, eps)
        passes, label = 2, f"R={shape[0]} C={c}"
    rel = lambda o, ref: ((o.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
    err = fault = 0.0
    for eps, act in settings:
        ref = plain(eps, act)
        out = run(w, b, eps, act)
        if not torch.isfinite(out.float()).all():
            fail(f"{kind} {label} {tag} eps={eps} act={act}: output not finite")
        err = max(err, rel(out, ref))
        fault = max(fault, rel(run(b, w, eps, act), ref))
        del ref, out
    if not err <= tol < fault:
        fail(f"{kind} {label} {tag}: err {err} (tol {tol}), planted fault {fault}")
    eps, act = settings[0]
    ms = cuda_ms(lambda: run(w, b, eps, act), reps)
    plain_ms = cuda_ms(lambda: plain(eps, act), 3, warmup=1)
    lib_ms = cuda_ms(lambda: lib(eps, act), reps)
    bound = passes * x.numel() * x.element_size() / H100_BYTES_PER_S * 1e3
    print(f"[norm {kind} {tag} {label}] err {err:.3e} (tol {tol}, planted fault {fault:.3e}; "
          f"settings {list(settings)}) kernel {ms:.4f} ms ({100 * bound / ms:.1f} % of bound) "
          f"plain {plain_ms:.4f} ms library {lib_ms:.4f} ms bound {bound:.4f} ms (bytes)",
          flush=True)
    rows.append(dict(name=f"{kind}{'' if tag == 'bf16' else ' ' + tag} {label}", route="cuda",
                     source="moca_tpu_torch/csrc/norms.cu", replaces=NORM_REPLACES[kind],
                     shape=key, max_rel_err=err, fault_rel_err=fault, settings=list(settings),
                     ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
                     library_ms=lib_ms))
    return ms, bound, plain_ms, lib_ms


def norm_host_us(rounds=3, reps=2000):
    """Host microseconds a call of each norm wrapper and its plain chain,
    beside a PyTorch `x + 1`, all on one small bf16 input ([2, 64, 320],
    GroupNorm+SiLU at 32 groups; its [128, 320] rows for LayerNorm) so that
    the card waits for the host: the wall time of `reps` calls issued back to
    back, one sync after them; the median of `rounds` rounds in turn."""
    import statistics

    import torch
    from moca_tpu_torch.ops import norms as tn

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x, w, b = _randn((2, 64, 320), gen), _randn((320,), gen), _randn((320,), gen)
    r = x.reshape(128, 320)
    fns = {"group_norm": lambda: tn.group_norm(x, w, b, 32, 1e-6, "silu"),
           "group_norm_plain": lambda: tn.group_norm_plain(x, w, b, 32, 1e-6, "silu"),
           "layer_norm": lambda: tn.layer_norm(r, w, b, 1e-5),
           "layer_norm_plain": lambda: tn.layer_norm_plain(r, w, b, 1e-5),
           "add": lambda: x + 1}
    times = {name: [] for name in fns}
    with torch.inference_mode():
        for _ in range(rounds):
            for name, fn in fns.items():
                for _ in range(20):
                    fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) / reps * 1e6)
    us = {name: statistics.median(t) for name, t in times.items()}
    print(f"[norm host] us a call, median of {rounds} rounds of {reps} "
          f"{json.dumps({k: round(v, 2) for k, v in us.items()})}; against x + 1: "
          f"{json.dumps({k: round(v / us['add'], 2) for k, v in us.items() if k != 'add'})}",
          flush=True)
    reset_counts()
    return us


def phase_norms(rows):
    """The shipped U-Net (random bf16 weights) at the stream's 16 rows and the
    clip's 2 rows (16 frames, 40 x 64 latent): each norm shape of one forward
    held to its plain version at the settings its modules use and timed
    (`check_norm`, a row each); the sums over one U-Net call by kernel, each
    shape weighted by its launches, printed as `[norm summary]` (ms,
    bound_ms, plain_ms, library_ms), with the calls whose input was not
    contiguous; then the wrappers' host cost (`norm_host_us`)."""
    import torch
    from moca_tpu_torch.models.unet3d import UNet3D, UNetConfig

    with torch.device("cuda"):
        unet = UNet3D(UNetConfig()).to(torch.bfloat16).eval()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    summary = {}
    for n_rows in (16, 2):
        settings, calls, launched, copied = norm_calls(unet, n_rows)
        if launched != calls:
            fail(f"norms at {n_rows} rows: launches {launched}, module calls {calls}")
        by_kind = summary[f"rows{n_rows}"] = {"non_contiguous_inputs": copied}
        for (kind, key), seen in sorted(settings.items(), key=str):
            times = check_norm(kind, key, sorted(seen, key=lambda s: s[1] is None), gen, rows)
            total = by_kind.setdefault(kind, dict.fromkeys(
                ("calls", "ms", "bound_ms", "plain_ms", "library_ms"), 0.0))
            total["calls"] += calls[kind][key]
            for field, t in zip(("ms", "bound_ms", "plain_ms", "library_ms"), times):
                total[field] += calls[kind][key] * t
        for kind in launched:
            by_kind[kind]["bound_share"] = by_kind[kind]["bound_ms"] / by_kind[kind]["ms"]
    del unet
    torch.cuda.empty_cache()
    rounded = lambda t: {f: round(v, 4) for f, v in t.items()} if isinstance(t, dict) else t
    print(f"[norm summary, a U-Net call] "
          f"{json.dumps({k: {kind: rounded(t) for kind, t in by.items()} for k, by in summary.items()})}",
          flush=True)
    norm_host_us()
    return summary


def phase_norm_shapes(shapes, rows):
    """Every norm, GEGLU and MoCA scan shape the runs gave (by their launch
    tallies) that phases 2b-2d did not hold: each held to its plain version
    and timed (`check_norm` at NORM_SETTINGS, `check_geglu`,
    `check_moca_scan`; a row each), so that every shape these kernels
    received on every path has been held."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    held = {(r["name"].split()[0], r["shape"]) for r in rows}
    todo = sorted({(kind, key) for by_kernel in shapes.values()
                   for kind, by_shape in by_kernel.items()
                   if kind in NORM_SETTINGS or kind in ("geglu", "moca_scan")
                   for key in by_shape} - held, key=str)
    for kind, key in todo:
        if kind == "geglu":
            check_geglu(key, gen, rows, reps=5)
        elif kind == "moca_scan":
            check_moca_scan(key, gen, rows, reps=10)
        else:
            check_norm(kind, key, NORM_SETTINGS[kind], gen, rows, reps=5)
        torch.cuda.empty_cache()
    print(f"[norms, GEGLU and MoCA scan, the runs' other shapes] {len(todo)} shapes held to "
          f"their plain versions ({sum(k == 'group_norm' for k, _ in todo)} GroupNorm, "
          f"{sum(k == 'layer_norm' for k, _ in todo)} LayerNorm, "
          f"{sum(k == 'geglu' for k, _ in todo)} GEGLU, "
          f"{sum(k == 'moca_scan' for k, _ in todo)} MoCA scan)", flush=True)


# The feed-forward's GEGLU (ops/geglu.py, csrc/geglu.cu) against its plain
# version, the measure of the norms: the kernel rounds the product once, the
# plain version the gelu and then the product (bf16: at most one and a half
# units, 2^-8, apart); in fp32 both compute one expression. The limits of
# tests/test_torch_cuda.py's GEGLU_TOL, by the launch tally's type tag.
GEGLU_TOL = {"bf16": 1e-2, "fp16": 2e-3, "fp32": 1e-5}
GEGLU_REPLACES = "none; stands beside moca_tpu/models/unet3d.py (GEGLU)"
GEGLU_CHECK_ROWS = 1 << 16
# (rows, latent) of one U-Net call of each cell: the stream, the i2v clip,
# DynamiCrafter 1024
GEGLU_CALLS = {"vc2-fifo-davis": (16, (40, 64)), "vc1-i2v-clip": (2, (40, 64)),
               "dc1024-i2v-clip": (2, (72, 128))}


def check_geglu(key, gen, rows, reps=10):
    """GEGLU at its launch tally's `key` ((R, F), with the type's tag) against
    `geglu_plain`, with a planted fault (x and the gate swapped); timed beside
    the plain version and the library's own chain (`F.gelu` on the gate's
    chunk view, then the product: the ops the plain version runs, timed
    alone), with its bytes bound (one read of [R, 2F], one write of [R, F]:
    6 bytes an output column in bf16, 12 in fp32). Appends a row of the
    kernel measurements; returns (ms, bound_ms, plain_ms, library_ms). The
    runs' largest shapes hold 10 GB inputs beside the runs' models: the
    comparison goes `GEGLU_CHECK_ROWS` rows at a time, and the fault runs on
    the first of them."""
    import torch
    import torch.nn.functional as F
    from moca_tpu_torch.ops import geglu as tg

    tag = key[-1] if isinstance(key[-1], str) else "bf16"
    r, f = key[:2]
    dtype = {"bf16": torch.bfloat16, "fp16": torch.float16, "fp32": torch.float32}[tag]
    tol = GEGLU_TOL[tag]
    h = torch.empty((r, 2 * f), device="cuda", dtype=dtype).normal_(0.0, 2.5, generator=gen)

    def rel(o, ref):
        diff = top = 0.0
        for i in range(0, ref.shape[0], GEGLU_CHECK_ROWS):
            a, b = o[i:i + GEGLU_CHECK_ROWS].float(), ref[i:i + GEGLU_CHECK_ROWS].float()
            if not torch.isfinite(a).all():
                fail(f"geglu R={r} F={f} {tag}: output not finite")
            diff, top = max(diff, (a - b).abs().max().item()), max(top, b.abs().max().item())
        return diff / top

    ref = tg.geglu_plain(h)
    err = rel(tg.geglu(h), ref)
    x, gate = h[:GEGLU_CHECK_ROWS].chunk(2, dim=-1)
    fault = rel(tg.geglu(torch.cat([gate, x], dim=-1)), ref[:GEGLU_CHECK_ROWS])
    del ref
    x, gate = h.chunk(2, dim=-1)
    if not err <= tol < fault:
        fail(f"geglu R={r} F={f} {tag}: err {err} (tol {tol}), planted fault {fault}")
    ms = cuda_ms(lambda: tg.geglu(h), reps)
    plain_ms = cuda_ms(lambda: tg.geglu_plain(h), 3, warmup=1)
    lib_ms = cuda_ms(lambda: x * F.gelu(gate, approximate="tanh"), reps)
    bound = 3 * r * f * h.element_size() / H100_BYTES_PER_S * 1e3
    print(f"[geglu {tag} R={r} F={f}] err {err:.3e} (tol {tol}, planted fault {fault:.3e}) "
          f"kernel {ms:.4f} ms ({100 * bound / ms:.1f} % of bound) plain {plain_ms:.4f} ms "
          f"library {lib_ms:.4f} ms bound {bound:.4f} ms (bytes)", flush=True)
    rows.append(dict(name=f"geglu{'' if tag == 'bf16' else ' ' + tag} R={r} F={f}", route="cuda",
                     source="moca_tpu_torch/csrc/geglu.cu", replaces=GEGLU_REPLACES, shape=key,
                     max_rel_err=err, fault_rel_err=fault, ms=ms, plain_ms=plain_ms,
                     bound_ms=bound, bound_by="bytes", library_ms=lib_ms))
    return ms, bound, plain_ms, lib_ms


def geglu_host_us(rounds=3, reps=2000):
    """Host microseconds a call of `geglu` and of `geglu_plain` (chunk,
    F.gelu, the product), beside a PyTorch `x + 1`, on one small bf16 input
    ([128, 2 x 640]) so that the card waits for the host: the wall time of
    `reps` calls issued back to back, one sync after them; the median of
    `rounds` rounds in turn."""
    import statistics

    import torch
    from moca_tpu_torch.ops import geglu as tg

    h = _randn((128, 1280), torch.Generator(device="cuda").manual_seed(SEED))
    fns = {"geglu": lambda: tg.geglu(h), "geglu_plain": lambda: tg.geglu_plain(h),
           "add": lambda: h + 1}
    times = {name: [] for name in fns}
    with torch.inference_mode():
        for _ in range(rounds):
            for name, fn in fns.items():
                for _ in range(20):
                    fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) / reps * 1e6)
    us = {name: statistics.median(t) for name, t in times.items()}
    print(f"[geglu host] us a call, median of {rounds} rounds of {reps} "
          f"{json.dumps({k: round(v, 2) for k, v in us.items()})}", flush=True)
    reset_counts()
    return us


def phase_geglu(rows):
    """The shipped U-Net (random bf16 weights) at one call of each cell's
    shape (`GEGLU_CALLS`): the GEGLU shapes its tally gives, one launch a
    feed-forward (33 a call), each held to its plain version and timed
    (`check_geglu`, a row each); the sums over one U-Net call, each shape
    weighted by its launches, printed as `[geglu summary, a U-Net call]`
    (ms, bound_ms, plain_ms, library_ms); then the wrapper's host cost
    (`geglu_host_us`)."""
    import torch
    from moca_tpu_torch.models.unet3d import UNet3D, UNetConfig
    from moca_tpu_torch.ops import geglu as tg

    with torch.device("cuda"):
        unet = UNet3D(UNetConfig()).to(torch.bfloat16).eval()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    summary, held = {}, {}
    for cell, (n_rows, lat) in GEGLU_CALLS.items():
        x = _randn((n_rows, 16) + lat + (4,), gen)
        reset_counts()
        with torch.inference_mode():
            unet(x, torch.full((n_rows, 16), 500, device="cuda", dtype=torch.long),
                 _randn((n_rows, 154, 1024), gen), fps=16)
        torch.cuda.synchronize()
        launched = dict(tg.geglu.launches)
        if sum(launched.values()) != 33:
            fail(f"geglu at {cell}'s U-Net call: {launched}, not one launch a feed-forward (33)")
        total = summary[cell] = dict.fromkeys(("calls", "ms", "bound_ms", "plain_ms",
                                               "library_ms"), 0.0)
        for key, n in sorted(launched.items()):
            if key not in held:
                held[key] = check_geglu(key, gen, rows)
                torch.cuda.empty_cache()
            total["calls"] += n
            for field, t in zip(("ms", "bound_ms", "plain_ms", "library_ms"), held[key]):
                total[field] += n * t
        total["bound_share"] = total["bound_ms"] / total["ms"]
        del x
    del unet
    torch.cuda.empty_cache()
    print(f"[geglu summary, a U-Net call] "
          f"{json.dumps({k: {f: round(v, 4) for f, v in t.items()} for k, t in summary.items()})}",
          flush=True)
    geglu_host_us()
    return summary


# MoCA's window step over every FIFO window (ops/moca_scan.py,
# csrc/moca_scan.cu) against the per-window loop on the same card and noise:
# relative L2 of the new queue and of pred_x0. The kernel does the loop's
# float32 operations in its order, each rounded once, so it reads 0; the
# limit is tests/test_torch_cuda.py's SCAN_TOL. Planted fault: the momentum
# dropped (the kernel with `enable_momentum` off).
SCAN_TOL = 1e-5
SCAN_REPLACES = "none; stands beside moca_tpu/sampling/moca.py (moca_window_step)"
# the stream's tally key: 8 windows, one row, a queue of 72 slots, 16 frames of 40 x 64 x 4
SCAN_CELL = (8, 1, 72, 16, 40, 64, 4, "fp32")
# fifo_step calls and per-window loops on CUDA queues
# since the last `reset_counts` (counted once `count_moca_steps` ran), and each
# MoCA run's (fifo steps, scan launches) by its label
MOCA_CALLS = {"fifo_step": 0, "window_loop": 0}
MOCA_TALLY: dict = {}


def count_moca_steps():
    """Count the pipeline's fifo_step calls and the per-window loop's runs on
    CUDA queues in this process (MOCA_CALLS)."""
    from moca_tpu_torch.pipelines import moca_video
    from moca_tpu_torch.sampling import fifo

    step, loop = moca_video.fifo_step, fifo._moca_window_loop

    def counted_step(eps_fn, sch, plan, cfg, latents, *args, **kwargs):
        MOCA_CALLS["fifo_step"] += latents.is_cuda
        return step(eps_fn, sch, plan, cfg, latents, *args, **kwargs)

    def counted_loop(sch, plan, cfg, latents, *args, **kwargs):
        MOCA_CALLS["window_loop"] += latents.is_cuda
        return loop(sch, plan, cfg, latents, *args, **kwargs)

    moca_video.fifo_step, fifo._moca_window_loop = counted_step, counted_loop


def reset_counts():
    """Empty every kernel's launch tally and the MoCA step counts."""
    cuda_libs.reset_launch_counts()
    MOCA_CALLS.update(fifo_step=0, window_loop=0)


def _scan_inputs(key, gen, branch="davis"):
    """(schedule, plan, cfg, queue, eps, cond, masks) on the card at the scan's
    tally key (R, B, Q, f, h, w, C, "fp32"): lookahead where Q is not R * f;
    DAVIS masks (a box on every slot) and a concept image."""
    import torch
    from moca_tpu_torch.sampling import fifo, moca
    from moca_tpu_torch.schedule import make_schedule

    r, b, q, f = key[:4]
    hwc = tuple(key[4:7])
    lookahead = q != r * f
    n = r // 2 if lookahead else r
    sch = make_schedule(f * n, device="cuda")
    plan = fifo.make_fifo_plan(sch.ddim_timesteps_np, f, n, lookahead)
    cfg = moca.MoCAConfig(inject_into_queue=branch == "inject_into_queue")
    queue = torch.randn((b, q) + hwc, generator=gen, device="cuda")
    eps = torch.randn((r, b, f) + hwc, generator=gen, device="cuda")
    masks = torch.zeros((1, q) + hwc[:2] + (1,), device="cuda")
    masks[:, :, hwc[0] // 4: 3 * hwc[0] // 4, hwc[1] // 4: 3 * hwc[1] // 4] = 1.0
    cond = torch.rand(hwc, generator=gen, device="cuda")
    return sch, plan, cfg, queue, eps, cond, masks


def check_moca_scan(key, gen, rows, reps=50):
    """The scan at its tally `key` against the per-window loop on the same
    noise, in DAVIS mode with pred_x0 and with injection into the queue, and
    the planted fault (momentum dropped); timed (the launch alone, noise and
    tables built) beside the plain loop (its draws, ~30 ops a frame and the
    write-back's concatenation) and the scan's route (the draws and the
    launch), with its bytes bound (one read of each queue slot, of every
    window's eps and of the noise, one write of each queue slot: the cell's
    path, no pred_x0; the windows' overlapping reads of a slot count once).
    Appends a row (no library time: no one PyTorch call computes the step);
    returns (ms, bound_ms, plain_ms, route_ms)."""
    import dataclasses

    import torch
    from moca_tpu_torch.ops import moca_scan as tms
    from moca_tpu_torch.sampling import fifo
    from moca_tpu_torch.sampling.ddim import GeneratorNormal

    def err(a, b):
        return ((a.double() - b.double()).norm() / b.double().norm()).item()

    errs = []
    for branch in ("davis", "inject_into_queue"):
        sch, plan, cfg, queue, eps, cond, masks = _scan_inputs(key, gen, branch)
        windows = fifo._gather_windows(queue, plan)
        with torch.inference_mode():
            want = fifo._moca_window_loop(sch, plan, cfg, queue, windows, eps,
                                          GeneratorNormal(SEED, "cuda"), ("i",), cond, masks,
                                          True, 0.5, True)
            got = fifo._moca_scan_step(sch, plan, cfg, queue, eps, GeneratorNormal(SEED, "cuda"),
                                       ("i",), cond, masks, True, True)
            errs += [err(got[0], want[0]), err(got[1], want[1])]
            if branch == "davis":
                dropped = fifo._moca_scan_step(
                    sch, plan, dataclasses.replace(cfg, enable_momentum=False), queue, eps,
                    GeneratorNormal(SEED, "cuda"), ("i",), cond, masks, True, False)
                fault = err(dropped[0], want[0])
    worst = max(errs)
    r, b, q, f = key[:4]
    if not worst <= SCAN_TOL < fault:
        fail(f"moca_scan {key}: err {worst} (tol {SCAN_TOL}), planted fault {fault}")
    # the cell's path: DAVIS masks, injection off the queue, no pred_x0
    sch, plan, cfg, queue, eps, cond, masks = _scan_inputs(key, gen)
    windows = fifo._gather_windows(queue, plan)
    normal = GeneratorNormal(SEED, "cuda")
    table, slots = fifo.scan_tables(sch, plan, cfg, True, True, queue.device)
    noise = fifo.draw_window_noise(normal, ("i",), plan, queue.shape[2:], queue.device)
    with torch.inference_mode():
        ms = cuda_ms(lambda: tms.moca_scan(queue, eps, noise, table, slots, beta=cfg.beta,
                                           dir_weight=cfg.dir_weight), reps)
        plain_ms = cuda_ms(lambda: fifo._moca_window_loop(
            sch, plan, cfg, queue, windows, eps, normal, ("i",), cond, masks, True, 0.5, False),
            3, warmup=1)
        route_ms = cuda_ms(lambda: fifo._moca_scan_step(
            sch, plan, cfg, queue, eps, normal, ("i",), cond, masks, True, False), 10)
    frame = queue[0, 0].numel()
    bound = (2 * b * q + r * f * (b + 1)) * frame * 4 / H100_BYTES_PER_S * 1e3
    print(f"[moca_scan R={r} B={b} Q={q} f={f} {tuple(key[4:7])}] err {worst:.3e} (tol "
          f"{SCAN_TOL}, planted fault {fault:.3e}) kernel {ms:.4f} ms ({100 * bound / ms:.1f} % "
          f"of bound) plain loop {plain_ms:.4f} ms, scan route (draws and launch) "
          f"{route_ms:.4f} ms, bound {bound:.4f} ms (bytes)", flush=True)
    rows.append(dict(name=f"moca_scan fp32 R={r} B={b} Q={q} f={f} hwc={key[4:7]}",
                     route="cuda", source="moca_tpu_torch/csrc/moca_scan.cu",
                     replaces=SCAN_REPLACES, shape=tuple(key), max_rel_err=worst,
                     fault_rel_err=fault, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                     bound_by="bytes", library_ms=None, route_ms=route_ms))
    return ms, bound, plain_ms, route_ms


def moca_scan_host_us(rounds=3, reps=500):
    """Host microseconds a call of the wrapper `moca_scan` (tables and noise
    built) and of the whole scan route (`_moca_scan_step`: 128 draws and the
    launch) at the stream's shape, beside a PyTorch `x + 1`: the wall time of
    `reps` calls back to back, one sync after them; the median of `rounds`."""
    import statistics

    import torch
    from moca_tpu_torch.ops import moca_scan as tms
    from moca_tpu_torch.sampling import fifo
    from moca_tpu_torch.sampling.ddim import GeneratorNormal

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    sch, plan, cfg, queue, eps, cond, masks = _scan_inputs(SCAN_CELL, gen)
    normal = GeneratorNormal(SEED, "cuda")
    table, slots = fifo.scan_tables(sch, plan, cfg, True, True, queue.device)
    noise = fifo.draw_window_noise(normal, ("i",), plan, queue.shape[2:], queue.device)
    fns = {"moca_scan": lambda: tms.moca_scan(queue, eps, noise, table, slots, beta=cfg.beta,
                                              dir_weight=cfg.dir_weight),
           "scan_route": lambda: fifo._moca_scan_step(sch, plan, cfg, queue, eps, normal, ("i",),
                                                      cond, masks, True, False),
           "add": lambda: queue + 1}
    times = {name: [] for name in fns}
    with torch.inference_mode():
        for _ in range(rounds):
            for name, fn in fns.items():
                n = reps // 20 if name == "scan_route" else reps
                for _ in range(5):
                    fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) / n * 1e6)
    us = {name: statistics.median(t) for name, t in times.items()}
    print(f"[moca host] us a call, median of {rounds} rounds "
          f"{json.dumps({k: round(v, 2) for k, v in us.items()})}", flush=True)
    reset_counts()
    return us


def phase_moca_scan(rows):
    """The scan at the stream's shape (SCAN_CELL) and at two rows: held to the
    loop and timed (`check_moca_scan`, a row each); `[moca summary]` gives the
    stream's iteration (the kernel's ms, the plain loop's, the scan route's,
    the bytes bound) and the host's us a call (`moca_scan_host_us`)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    two_rows = (SCAN_CELL[0], 2) + SCAN_CELL[2:]
    ms, bound, plain_ms, route_ms = check_moca_scan(SCAN_CELL, gen, rows)
    check_moca_scan(two_rows, gen, rows)
    host = moca_scan_host_us()
    summary = dict(kernel_ms=ms, plain_loop_ms=plain_ms, scan_route_ms=route_ms, bound_ms=bound,
                   bound_share=bound / ms)
    summary = {k: round(v, 4) for k, v in summary.items()}
    summary["host_us"] = {k: round(v, 2) for k, v in host.items()}
    print(f"[moca summary, an iteration of the stream] {json.dumps(summary)}", flush=True)


def unet_shapes(rows: int, ctx: int, lat=(40, 64), f=16):
    """(K1 [B,Sq,Sk,H,D] shapes, K2 [N,S,C] shapes) that the shipped U-Net
    gives the kernels at a batch of `rows` x f frames on an h x w latent and
    a text context of `ctx` tokens: spatial self-attention at ds 1, 2, 4
    where it has at least 128 tokens, and text cross-attention there when
    the context has too (the reference's flash threshold; smaller ones take
    the plain path); temporal attention at every level, the 8-head init
    attention and the middle block."""
    k1, k2 = [], []
    for lvl, ch in enumerate((320, 640, 1280)):
        hh, ww = lat[0] >> lvl, lat[1] >> lvl
        if hh * ww >= 128:
            k1.append((rows * f, hh * ww, hh * ww, ch // 64, 64))
            if ctx >= 128:
                k1.append((rows * f, hh * ww, ctx, ch // 64, 64))
        k2.append((rows * hh * ww, f, ch))
    k2.append((rows * lat[0] * lat[1], f, 512))                  # init attention
    k2.append((rows * (lat[0] >> 3) * (lat[1] >> 3), f, 1280))   # middle block
    return k1, k2


def main_path_shapes(rows_fifo: int, rows_base: int, ctx_fifo: int, ctx_base: int):
    """unet_shapes of the main path's FIFO batch and of its base sample."""
    k1, k2 = [], []
    for rows, ctx in ((rows_fifo, ctx_fifo), (rows_base, ctx_base)):
        a, b = unet_shapes(rows, ctx)
        k1 += a
        k2 += b
    return k1, k2


# The U-Net batches phases 8-12 add, as (rows, context tokens that reach the
# text cross-attention, latent h x w): T2V --bs 4 (4 prompts x CFG),
# temporal guidance's cond-only calls (B=1), DDPM at 128x128 (B=1 x CFG),
# MoCA at B=2 (8 windows x CFG x 2 prompts with the 154-token concept
# context; its base sample, 2 prompts x CFG), the i2v clip (B=1 x CFG; its
# context is 77 text and 16 image tokens, and the image tokens go to the
# plain path at Sk=16), the sweep's MoCA at n=1 (2 windows x CFG with
# the concept context; phase 13's CLI run too), and one of phase 13's two
# ranks (8 of the main path's 16 FIFO rows; its base sample, 1 of 2 rows).
SLICE_RUNS = ((8, 77, (40, 64)), (1, 77, (40, 64)), (2, 77, (16, 16)), (32, 154, (40, 64)),
              (4, 77, (40, 64)), (2, 77, (40, 64)), (4, 154, (40, 64)), (8, 154, (40, 64)))


def slice_shapes(known_k1, known_k2):
    """(K1, K2) shapes of SLICE_RUNS that the main path's do not hold."""
    k1, k2 = [], []
    for rows, ctx, lat in SLICE_RUNS:
        a, b = unet_shapes(rows, ctx, lat)
        k1 += [sh for sh in a if sh not in known_k1 and sh not in k1]
        k2 += [sh for sh in b if sh not in known_k2 and sh not in k2]
    return k1, k2


def switched_shapes(k1, k2):
    """(K3 [N,S,C] shapes, K4 [B,Sq,Sk,H,D] shapes) that the same U-Net gives
    the kernels with both switches on: every temporal attention goes to K3
    (all its widths have d = 64 and pass the gate), and every K1 shape that
    the reference sends to its one-pass kernel goes to K4."""
    from moca_tpu_torch.ops.attention import onepass_full_kv

    k4 = [sh for sh in k1 if not (sh[1] == sh[2] and sh[1] <= 640) and onepass_full_kv(sh[1], sh[2])]
    return list(k2), k4


# phase 3's U-Net: one row of 16 frames on a 16 x 16 latent
UNET_REF_CFG = dict(model_channels=64, num_head_channels=64, context_dim=64,
                    channel_mult=(1, 2), attention_resolutions=(1,), num_res_blocks=1,
                    temporal_length=16)


def unet_reference_packed_shapes(head_ch: int, lat: int = 16, f: int = 16):
    """K2 [N, S, C, heads] shapes of phase 3's U-Net at num_head_channels
    `head_ch`: the 8-head init attention (C = 8 * head_ch) and the temporal
    attention at ds 1 (64 channels) and in the middle block (ds 2, 128
    channels), whose C is the inner width heads * head_ch (60 and 120 at
    head_ch = 20)."""
    mc = UNET_REF_CFG["model_channels"]
    n0, n1 = lat * lat, (lat // 2) ** 2
    h0, h1 = mc // head_ch, 2 * mc // head_ch
    return [(n0, f, 8 * head_ch, 8), (n0, f, h0 * head_ch, h0), (n1, f, h1 * head_ch, h1)]


# the head width of phase 5's full-width forward at another num_head_channels
HEAD160 = 160


def head160_packed_shapes(rows: int, lat=(40, 64), f: int = 16):
    """K2 [N, S, C, heads] shapes of the shipped U-Net at num_head_channels=160
    on `rows` x f frames: the temporal attention at ds 1, 2, 4 (2, 4 and 8
    heads of 160), the 8-head init attention (C = 1280) and the middle block
    (8 heads)."""
    shapes = [(rows * (lat[0] >> lvl) * (lat[1] >> lvl), f, ch, ch // HEAD160)
              for lvl, ch in enumerate((320, 640, 1280))]
    shapes.append((rows * lat[0] * lat[1], f, 8 * HEAD160, 8))
    shapes.append((rows * (lat[0] >> 3) * (lat[1] >> 3), f, 1280, 1280 // HEAD160))
    return shapes


# K2 at full width at every kind of head width the reference's
# `_packed_tiny_kernel` takes, as (N, S, C, d), in bf16 and in fp32: d = 20,
# odd C (d = 33), C % 8 == 4 (d = 100), d = 160 at each temporal width, one
# head of the whole C (d = 320, 1280), S = 8 and 24, and d = 8 (both designs)
K2_WIDTH_ROWS = ((40960, 16, 320, 20), (40960, 16, 297, 33), (40960, 16, 300, 100),
                 (40960, 16, 320, 160), (40960, 16, 320, 320), (10240, 16, 640, 160),
                 (2560, 16, 1280, 160), (1280, 32, 1280, 160), (2560, 16, 1280, 1280),
                 (40960, 8, 297, 33), (40960, 24, 297, 33), (40960, 16, 320, 8))


def phase_kernels(rows_fifo: int, rows_base: int, ctx_fifo: int, ctx_base: int):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    k1, k2 = main_path_shapes(rows_fifo, rows_base, ctx_fifo, ctx_base)
    new_k1, new_k2 = slice_shapes(k1, k2)
    k1, k2 = k1 + new_k1, k2 + new_k2
    k3, k4 = switched_shapes(k1, k2)
    for b, sq, sk, h, _ in k1:
        check_flash(b, sq, sk, h, gen, rows)
    check_flash_adversarial(gen)
    for n, s, c in k2:
        check_packed(n, s, c, gen, rows)
    packed_launch_floor(gen)
    # K2 at other head widths: the full-width rows, every shape phase 3's
    # num_head_channels=32 and 20 U-Nets give it, and phase 5's
    # num_head_channels=160 forward's
    seen = {(n, s, c, c // 64) for n, s, c in k2}
    other = [(n, s, c, c // d) for n, s, c, d in K2_WIDTH_ROWS]
    other += [(n, 16, c, c // d) for n, c, d in ((rows_fifo * 2560, 320, 32),
                                                 (rows_fifo * 640, 640, 128))]
    other += unet_reference_packed_shapes(32) + unet_reference_packed_shapes(20)
    other += head160_packed_shapes(rows_fifo)
    for n, s, c, heads in other:
        if (n, s, c, heads) not in seen:
            seen.add((n, s, c, heads))
            check_packed(n, s, c, gen, rows, d=c // heads)
    for n, s, c, d in K2_WIDTH_ROWS:
        check_packed(n, s, c, gen, rows, reps=5, d=d, dtype=torch.float32)
    for n, s, c in k3:
        check_fused(n, s, c, gen, rows)
    for b, sq, sk, h, _ in k4:
        check_flash(b, sq, sk, h, gen, rows, onepass=True)
    # K3 and K4 at shapes no run of the path launches: K3 with a ragged last
    # tile (5.25 tiles), below one tile, with its heads split over a cluster
    # and a partial last tile, and at C = 512 for S = 8, 24, 32; K4 at a
    # ragged Sk and on a long row (the route sends such rows at small Sq)
    check_fused(21, 16, 320, gen, rows)
    check_fused(3, 16, 320, gen, rows)
    check_fused(33, 16, 1280, gen, rows)
    for s_, n_ in ((8, 4096), (24, 1024), (32, 1024)):
        check_fused(n_, s_, 512, gen, rows)
    check_flash(4, 2560, 3000, 5, gen, rows, onepass=True)
    check_flash(1, 128, 8192, 5, gen, rows, onepass=True)
    # phase 14's condition images: one frame a row, 2 CFG rows, 77 tokens
    for b, sq, sk, h, _ in unet_shapes(2, 77, f=1)[0]:
        if (b, sq, sk, h, 64) not in k1:
            check_flash(b, sq, sk, h, gen, rows)
    # the fp32 paths at the shapes of the fp32 runs, each timed beside its
    # bf16 path on the same inputs
    f32 = torch.float32
    fk1, fk2, fk3, fk4 = fp32_shapes()
    for b, sq, sk, h, _ in fk1:
        check_flash(b, sq, sk, h, gen, rows, reps=3, dtype=f32)
    for n, s, c, heads in fk2:
        check_packed(n, s, c, gen, rows, reps=5, d=c // heads, dtype=f32)
    for n, s, c in fk3:
        check_fused(n, s, c, gen, rows, reps=3, dtype=f32)
    for b, sq, sk, h, _ in fk4:
        check_flash(b, sq, sk, h, gen, rows, reps=3, onepass=True, dtype=f32)
    return rows


# Phase 14's acceptance golden clip, fp32 at 512x320, f=16: n and the new
# frames cut from the CLI's 4 and 16, so that the script stays inside its
# time limit. The cut clip (20 FIFO iterations at 8 U-Net rows, a 32-step
# base sample) takes ~51 s on an H100 (PERF.md section 5); the CLI's (64
# iterations at 16 rows, 64 base steps) has ~6x its FIFO work.
ACCEPT_PARTITIONS = 2
ACCEPT_NEW_FRAMES = 4


def fp32_shapes():
    """(K1 [B,Sq,Sk,H,D], K2 [N,S,C,heads], K3 [N,S,C], K4 [B,Sq,Sk,H,D])
    shapes of the fp32 runs: phase 14's golden clip (2 * 2n FIFO rows with
    the 154-token concept context, 2 base rows with 77); phase 3's small
    U-Net as shipped (context 77) and with both switches (context 154:
    K4 takes its cross-attention, K3 the temporal attention at d = 64 where
    C is 320 or a multiple of 128); phase 5's full-width fp32 forwards at
    the golden clip's FIFO rows (K3 at every temporal width); one K3 row with
    a ragged last tile; and one K4 row at the golden clip's widths, for its
    time."""
    k1, k2 = main_path_shapes(4 * ACCEPT_PARTITIONS, 2, 154, 77)
    k1 = k1 + [(16, 256, 256, 1, 64)]
    ref_k2 = unet_reference_packed_shapes(64)
    # dict.fromkeys: the FIFO batch's middle block and the base sample's
    # ds-4 level give K2 one shape at these rows; each shape is one row
    k2 = list(dict.fromkeys([(n, s, c, c // 64) for n, s, c in k2] + ref_k2))
    k3 = [(n, s, c) for n, s, c, heads in ref_k2
          if c // heads == 64 and (c == 320 or c % 128 == 0)]
    # phase 5's fp32 forward with MOCA_TPU_FA_FUSED_QKV=1: every temporal
    # attention of the golden clip's FIFO batch (C = 320 at N = 20480 among
    # them), and a ragged last tile
    k3 += [sh for sh in unet_shapes(4 * ACCEPT_PARTITIONS, 154)[1] if sh not in k3]
    k3.append((21, 16, 320))
    k4 = [(16, 256, 154, 1, 64), (4 * ACCEPT_PARTITIONS * 16, 2560, 2560, 5, 64)]
    return k1, k2, k3, k4


def rel_max(out, ref) -> float:
    """max |out - ref| / max |ref| (tensors on one device)."""
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def reference_unet(ctx_len, **cfg_kw):
    """Phase 3's small U-Net (fp32, CPU) with weights N(0, 0.05^2) from seed
    0, and one input: x [1, 16, 16, 16, 4], timesteps [1, 16], a context of
    `ctx_len` tokens of width 64."""
    import numpy as np
    import torch
    from moca_tpu_torch.models.unet3d import UNet3D, UNetConfig

    cfg = UNetConfig(**{**UNET_REF_CFG, **cfg_kw})
    torch.manual_seed(0)
    ref_model = UNet3D(cfg).eval()
    with torch.no_grad():
        for p in ref_model.parameters():
            p.copy_(torch.randn(p.shape) * 0.05)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((1, 16, 16, 16, 4)), dtype=torch.float32)
    ts = torch.as_tensor(rng.integers(0, 1000, (1, 16)))
    ctx = torch.as_tensor(rng.standard_normal((1, ctx_len, 64)), dtype=torch.float32)
    return ref_model, x, ts, ctx


def check_unet_reference(label, ctx_len, switched, expect, dtype=None, **cfg_kw):
    """The port's U-Net with the kernels (`dtype` on the GPU, bf16 by
    default) against its plain path (fp32, CPU) on one small input (S=256
    spatial, S=16 temporal); fails unless every kernel named in `expect`
    launched (its fp32 path, in fp32). Returns the GPU forward's launches,
    {kernel: {shape: n}}."""
    import torch

    dtype = dtype or torch.bfloat16
    fp32 = dtype == torch.float32
    tol = FP32_UNET_REL_TOL if fp32 else UNET_REL_TOL
    ref_model, x, ts, ctx = reference_unet(ctx_len, **cfg_kw)
    with torch.inference_mode():
        ref = ref_model(x, ts, ctx, fps=10)
        gpu_model = ref_model.to("cuda", dtype)
        reset_counts()
        with switches_on() if switched else contextlib.nullcontext():
            out = gpu_model(x.cuda(), ts.cuda(), ctx.cuda(), fps=10).float().cpu()
    rel = ((out - ref).abs().max() / ref.abs().max()).item()
    if not math.isfinite(rel) or rel > tol:
        fail(f"U-Net {label} GPU vs CPU reference: relative max err {rel} > {tol}")
    launched = {fn.__name__: dict(fn.launches) for fn in cuda_libs.TALLIED}
    missing = [name for name in expect
               if not (fp32_launches(launched[name]) if fp32 else launched[name])]
    if missing:
        fail(f"the reference-check U-Net ({label}) did not reach {missing}")
    print(f"[unet reference, {label}] {'fp32' if fp32 else 'bf16'} GPU (kernels) vs fp32 CPU "
          f"(plain): relative max err {rel:.3e} (tol {tol}; TF32 matmuls "
          f"{torch.backends.cuda.matmul.allow_tf32}, convolutions "
          f"{torch.backends.cudnn.allow_tf32}); launches "
          f"{json.dumps({k: {str(s): n for s, n in v.items()} for k, v in launched.items() if v})}",
          flush=True)
    return launched


def phase_unet_reference():
    """The U-Net checks; returns {run: launches} of the runs whose shapes
    phase 2 holds: num_head_channels=32 and 20 (K2 at head widths other than
    64; at 20 the inner widths 60 and 120 differ from the channels, 64 and
    128, and the heads start at unaligned channels) and the fp32 forwards
    (every kernel's fp32 path)."""
    import torch

    check_unet_reference("as shipped, context 77", 77, False,
                         ("flash_attention", "packed_attention"))
    check_unet_reference("both switches, context 154", 154, True,
                         ("flash_attention", "fused_qkv_attention", "flash_attention_onepass"))
    runs = {f"unet_d{head_ch}": check_unet_reference(
        f"num_head_channels={head_ch}", 77, False, ("packed_attention",),
        num_head_channels=head_ch) for head_ch in (32, 20)}
    runs["unet_fp32"] = check_unet_reference(
        "fp32, as shipped, context 77", 77, False, ("flash_attention", "packed_attention"),
        dtype=torch.float32)
    runs["unet_fp32_switched"] = check_unet_reference(
        "fp32, both switches, context 154", 154, True,
        ("flash_attention", "fused_qkv_attention", "flash_attention_onepass"),
        dtype=torch.float32)
    return runs


def full_width_model():
    """The shipped VideoCrafter2 widths, random bf16 weights on the card from
    a CUDA generator seeded 1: the same model in every process that builds it."""
    import torch
    from moca_tpu_torch.models.clip_text import CLIPTextConfig
    from moca_tpu_torch.models.latent_diffusion import init_random_model
    from moca_tpu_torch.models.unet3d import UNetConfig
    from moca_tpu_torch.models.vae import VAEConfig

    gen = torch.Generator(device="cuda").manual_seed(1)
    return init_random_model(UNetConfig(), VAEConfig(), CLIPTextConfig(), gen,
                             device="cuda", dtype=torch.bfloat16)


def main_path_call():
    """The main path's call: the prompt, concept image, conditioned prompt,
    gamma and masks (a 20 x 32 rectangle on every frame) at 512x320."""
    import numpy as np

    masks = np.zeros((16, 40, 64), np.float32)
    masks[:, 10:30, 16:48] = 1.0
    return dict(prompt="a cat surfing", seed=321, cond_image=np.full((40, 64, 4), 0.2, np.float32),
                conditioned_prompt="a dog", gamma=0.5, height=320, width=512, masks=masks)


def phase_main_path(new_video_length: int, num_partitions: int):
    """Build the full-width model and drive the main path twice: as shipped,
    then with both switches. Returns ({run: {kernel: {shape: launches}}},
    model, the as-shipped run's frames)."""
    import torch
    from moca_tpu_torch.models.tokenizer import HashTokenizer
    from moca_tpu_torch.pipelines.moca_video import MoCAVideoPipeline

    t0 = time.perf_counter()
    model = full_width_model()
    print(f"[main] model built in {time.perf_counter() - t0:.1f} s, "
          f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params", flush=True)
    f = 16
    shapes, frames_out = {}, {}
    for run, expect in (("default", ("flash_attention", "packed_attention")),
                        ("switched", ("flash_attention", "fused_qkv_attention",
                                      "flash_attention_onepass"))):
        pipe = MoCAVideoPipeline(model, HashTokenizer(), video_length=f,
                                 num_partitions=num_partitions,
                                 new_video_length=new_video_length, guidance_scale=12.0)
        torch.cuda.reset_peak_memory_stats()
        with switches_on() if run == "switched" else contextlib.nullcontext():
            reset_counts()
            t0 = time.perf_counter()
            frames = pipe(**main_path_call())
            total = time.perf_counter() - t0
            shapes[run] = _launches(f"main {run}", expect)
        frames_out[run] = frames
        iters = new_video_length + pipe.num_inference_steps - f
        _check_frames(f"main path ({run})", frames, iters)
        steady = pipe.timings["fifo_iteration"] + pipe.timings["decode"]
        print(f"[main {run}] {len(frames)} frames {frames[0].shape}, all finite; total "
              f"{total:.2f} s, {total / len(frames):.3f} s/frame incl. base sample; FIFO+decode "
              f"{steady / iters:.3f} s/frame; stages "
              f"{json.dumps({k: round(v, 3) for k, v in pipe.timings.items()})}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB", flush=True)
    return shapes, model, frames_out["default"]


def _check_frames(label, frames, iters):
    import numpy as np

    finite = all(np.isfinite(x).all() for x in frames)
    if len(frames) != iters or frames[0].shape != (320, 512, 3) or not finite:
        fail(f"{label}: {len(frames)} frames (want {iters}), shape {frames[0].shape}, "
             f"finite={finite}")


def _launches(label, expect):
    """{kernel: {shape: n}} since the last reset; fails unless every kernel
    in `expect` launched, and unless every FIFO step on a CUDA queue
    launched the MoCA scan once and none ran the per-window loop."""
    launched = {fn.__name__: dict(fn.launches) for fn in cuda_libs.TALLIED}
    counts = {name: sum(by_shape.values()) for name, by_shape in launched.items()}
    for name in expect:
        if counts[name] <= 0:
            fail(f"{label} launched {name} no time")
    steps, loops = MOCA_CALLS["fifo_step"], MOCA_CALLS["window_loop"]
    if counts.get("moca_scan", 0) != steps or loops:
        fail(f"{label}: {steps} FIFO steps on CUDA queues launched the MoCA scan "
             f"{counts.get('moca_scan', 0)} times and ran the per-window loop {loops} times "
             f"(want one launch a step and no loop)")
    if steps:
        MOCA_TALLY[label] = {"fifo_steps": steps, "scan_launches": counts["moca_scan"]}
    print(f"[{label}] launches {json.dumps(counts)}", flush=True)
    return launched


def davis_inputs(n=72, hw=(40, 64)):
    """n frames [n, 8h, 8w, 3] uniform in [-1, 1], n masks [n, h, w] (a
    20 x 32 rectangle moving one latent pixel a frame) and a concept image
    [h, w, 4], from SEED."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    h, w = hw
    frames = rng.uniform(-1.0, 1.0, (n, 8 * h, 8 * w, 3)).astype(np.float32)
    masks = np.zeros((n, h, w), np.float32)
    for t in range(n):
        x0 = t % (w - 32)
        masks[t, 10:30, x0:x0 + 32] = 1.0
    cond = rng.uniform(0.0, 1.0, (h, w, 4)).astype(np.float32)
    return frames, masks, cond


# uint8 -> float: the host library computes x * (2/255) - 1, numpy's path
# (x / 255 - 0.5) * 2; the two differ by one float32 rounding (2^-23 at
# |x| <= 1). float -> uint8 and the packing are exact.
U8_ULP = 2.0 ** -23


def host_ms(fn, reps: int = 5) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def hold_fastio(frames):
    """The host library's (io/fastio.py, built from native/fastio.cpp)
    conversions and packing of the 72 DAVIS frames, held to numpy and timed
    against it, and io/video.py's uint8 -> float taking the library."""
    import numpy as np
    from moca_tpu_torch.io import fastio, video

    t0 = time.perf_counter()
    if not fastio.available():
        fail("io/fastio.py: the host library did not build or load")
    build_s = time.perf_counter() - t0
    np_u8 = lambda: [((np.clip(f, -1.0, 1.0) + 1.0) * 127.5).astype(np.uint8) for f in frames]
    u8 = [fastio.float_to_uint8(f) for f in frames]
    ref_u8 = np_u8()
    clip = fastio.pack_frames(u8)
    np_float = lambda: (clip.astype(np.float32) / 255.0 - 0.5) * 2.0
    calls = []
    library = fastio.uint8_to_float
    fastio.uint8_to_float = lambda x: calls.append(1) or library(x)
    back = video.uint8_to_tensor(clip)
    fastio.uint8_to_float = library
    if not calls:
        fail("io/video.py: uint8_to_tensor did not take the host library")
    errs = dict(
        float_to_uint8=int(max(np.abs(a.astype(np.int16) - b).max() for a, b in zip(u8, ref_u8))),
        pack_frames=int(np.abs(clip.astype(np.int16) - np.stack(ref_u8)).max()),
        uint8_to_float=float(np.abs(back - np_float()).max()))
    if errs["float_to_uint8"] or errs["pack_frames"] or not errs["uint8_to_float"] <= U8_ULP:
        fail(f"io/fastio.py against numpy on the 72 DAVIS frames: {errs} (want 0, 0, <= {U8_ULP})")
    ms = {
        "float_to_uint8": (host_ms(lambda: [fastio.float_to_uint8(f) for f in frames]),
                           host_ms(np_u8)),
        "pack_frames": (host_ms(lambda: fastio.pack_frames(u8)), host_ms(lambda: np.stack(u8))),
        "uint8_to_float": (host_ms(lambda: fastio.uint8_to_float(clip)), host_ms(np_float)),
    }
    print(f"[davis fastio] library built and loaded in {build_s:.2f} s; the 72 frames "
          f"[72, 320, 512, 3] against numpy: max err {json.dumps(errs)} (float_to_uint8 and "
          f"pack_frames exact, uint8_to_float within {U8_ULP:.3g}; io/video.py's "
          f"uint8_to_tensor took the library); host ms, library / numpy: "
          f"{json.dumps({k: [round(a, 2), round(b, 2)] for k, (a, b) in ms.items()})}",
          flush=True)


def phase_davis(model, new_video_length: int, num_partitions: int):
    """DAVIS mode at full width. Returns {kernel: {shape: launches}}."""
    import copy

    import torch
    from moca_tpu_torch.models.tokenizer import HashTokenizer
    from moca_tpu_torch.pipelines.moca_video import MoCAVideoPipeline
    from moca_tpu_torch.sampling.ddim import GeneratorNormal

    frames, masks, cond = davis_inputs()
    hold_fastio(frames)
    torch.cuda.reset_peak_memory_stats()
    normal = GeneratorNormal(SEED, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clean = model.encode_frames(frames[None], normal)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    enc_peak = torch.cuda.max_memory_allocated() / 2**30
    if clean.shape != (1, 72, 40, 64, 4) or not torch.isfinite(clean).all():
        fail(f"DAVIS encode: shape {tuple(clean.shape)}, "
             f"finite={bool(torch.isfinite(clean).all())}")
    # one frame's moments: the bf16 encoder on the card against fp32 on the CPU
    cpu_vae = copy.deepcopy(model.vae).to("cpu", torch.float32)
    x = torch.from_numpy(frames[-1:])
    with torch.inference_mode():
        ref = cpu_vae.encode_moments(x)
        out = model.vae.encode_moments(x.cuda())
    del cpu_vae
    errs = {}
    for name, o, r in zip(("mean", "logvar"), out, ref):
        errs[name] = ((o.float().cpu() - r).abs().max() / r.abs().max()).item()
        if not math.isfinite(errs[name]) or errs[name] > UNET_REL_TOL:
            fail(f"DAVIS encoder {name}: bf16 GPU vs fp32 CPU relative max err {errs[name]} "
                 f"> {UNET_REL_TOL}")
    print(f"[davis] encoded 72 frames [72, 320, 512, 3] on the card in {encode_s:.2f} s "
          f"(peak memory {enc_peak:.1f} GiB); frame 71's moments, bf16 GPU vs fp32 CPU: "
          f"relative max err mean {errs['mean']:.3e}, logvar {errs['logvar']:.3e} "
          f"(tol {UNET_REL_TOL})", flush=True)

    pipe = MoCAVideoPipeline(model, HashTokenizer(), video_length=16,
                             num_partitions=num_partitions,
                             new_video_length=new_video_length, guidance_scale=12.0)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    video = pipe("object bear cat.", normal=normal, cond_image=cond, gamma=0.5, height=320,
                 width=512, clean_latents=clean, masks=masks, davis_frames=frames)
    total = time.perf_counter() - t0
    launched = _launches("davis", ("flash_attention", "packed_attention"))
    iters = new_video_length + pipe.num_inference_steps - 16
    _check_frames("DAVIS mode", video, iters)
    steady = (pipe.timings["fifo_iteration"] + pipe.timings["decode"]) / iters
    print(f"[davis] {len(video)} frames {video[0].shape}, all finite; total {total:.2f} s; "
          f"steady (FIFO+decode) {steady:.3f} s/frame; stages "
          f"{json.dumps({k: round(v, 3) for k, v in pipe.timings.items()})}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB", flush=True)
    return launched


def launch_vs_device(pipe):
    """(host seconds until one FIFO iteration's launch returns, its device
    seconds) for the as-shipped prompt call: the host has time to spare for
    a provider only if the launch returns early."""
    import torch
    from moca_tpu_torch.sampling.ddim import GeneratorNormal
    from moca_tpu_torch.sampling.fifo import prepare_queue

    normal = GeneratorNormal(SEED, "cuda")
    with torch.inference_mode():
        ctx = torch.cat([pipe.base.encode_prompts([p]) for p in ("a cat surfing", "a dog")], 1)
        uc = torch.cat([pipe.base.uncond_context(1)] * 2, 1)
        queue = prepare_queue(pipe.sch, pipe.plan, torch.zeros((1, 16, 40, 64, 4), device="cuda"),
                              normal)
        for i in range(2):  # the second is timed
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0 = time.perf_counter()
            start.record()
            queue, _, _ = pipe._fifo_iteration(queue, ctx, uc, None, None, False, 0.5, normal, i)
            host_s = time.perf_counter() - t0
            end.record()
            torch.cuda.synchronize()
    return host_s, start.elapsed_time(end) / 1e3


def phase_open_vocab(model, new_video_length: int, num_partitions: int):
    """Open vocab at full width with a stand-in detector, after the same
    call without a provider, whose steady s/frame it is held against.
    Returns {kernel: {shape: launches}} of the run with the provider."""
    import shutil

    import numpy as np
    import torch
    from moca_tpu_torch.io.segmentation import CallbackMaskProvider
    from moca_tpu_torch.models.tokenizer import HashTokenizer
    from moca_tpu_torch.pipelines.moca_video import MoCAVideoPipeline

    pipe = MoCAVideoPipeline(model, HashTokenizer(), video_length=16,
                             num_partitions=num_partitions,
                             new_video_length=new_video_length, guidance_scale=12.0,
                             checkpoint_every=16, seg_async=True)
    per_frame = SEG_SLEEP_S / pipe._num_low_t_slots()
    calls = []

    def detect(frame, target):  # threshold, then the detector's latency
        calls.append(1)
        mask = (frame[:, :, 0] > 127).astype(np.float32)
        time.sleep(per_frame)
        return mask if mask.any() else None

    host_s, device_s = launch_vs_device(pipe)
    print(f"[open_vocab] one FIFO iteration's launch returns to the host after {host_s:.3f} s "
          f"of its {device_s:.3f} s on the device", flush=True)
    latents_dir = os.path.join("build", "smoke_open_vocab")
    shutil.rmtree(latents_dir, ignore_errors=True)
    cond = np.full((40, 64, 4), 0.2, np.float32)
    call = dict(seed=SEED, cond_image=cond, conditioned_prompt="a dog", gamma=0.5, height=320,
                width=512, latents_dir=latents_dir)
    iters = new_video_length + pipe.num_inference_steps - 16
    # the same call without a provider (it writes the base-latent cache the next one reads)
    _check_frames("open-vocab baseline", pipe("a cat surfing", **call), iters)
    baseline = (pipe.timings["fifo_iteration"] + pipe.timings["decode"]) / iters
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with profile_env(), contextlib.redirect_stdout(out):
        video = pipe("a cat surfing", **call, mask_provider=CallbackMaskProvider(detect),
                     target="cat")
    total = time.perf_counter() - t0
    check_profile_line(out.getvalue())
    shutil.rmtree(latents_dir, ignore_errors=True)
    launched = _launches("open_vocab", ("flash_attention", "packed_attention"))
    _check_frames("open-vocab mode", video, iters)
    if len(calls) != iters * pipe._num_low_t_slots():
        fail(f"open vocab: {len(calls)} detector calls, want {iters * pipe._num_low_t_slots()}")
    t = pipe.timings
    steady = (t["fifo_iteration"] + t["decode"]) / iters
    print(f"[open_vocab] {len(video)} frames, all finite; {len(calls)} detector calls "
          f"({pipe._num_low_t_slots()} low-t slots an iteration, {SEG_SLEEP_S} s an iteration); "
          f"total {total:.2f} s; mask_provider {t['mask_provider']:.3f} s "
          f"({t['mask_provider'] / iters:.3f} s/iteration, the provider's own time on its "
          f"worker thread), fifo_iteration {t['fifo_iteration']:.3f} s, decode "
          f"{t['decode']:.3f} s; steady (FIFO+decode) {steady:.3f} s/frame against "
          f"{baseline:.3f} in the same call without a provider: "
          f"{steady - baseline:+.3f} s/frame exposed; stages "
          f"{json.dumps({k: round(v, 3) for k, v in t.items()})}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB", flush=True)
    return launched


T2V_PROMPTS = ("a cat surfing", "a dog skating on a ramp", "a red fox in the snow",
               "a boat on a lake at dawn")


def rel_l2(a, b) -> float:
    """||a - b|| / ||b|| over whole clips (numpy arrays)."""
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def hold_batch_to_single(what, batched, single, fault, fault_what, limit, other_prompt):
    """Fail unless the batched run's clip is within `limit` (relative L2) of
    the single run's and the planted fault's reading is beyond it; prints
    another prompt's clip of the batch against the single run beside them."""
    err, fault_err = rel_l2(batched, single), rel_l2(fault[0], fault[1])
    print(f"[{what}] relative L2 {err:.3e} (limit {limit}); planted fault ({fault_what}) "
          f"{fault_err:.3e}; the batch's prompt 1 against the same run "
          f"{rel_l2(other_prompt, single):.3e}", flush=True)
    if not err <= limit:
        fail(f"{what}: relative L2 {err} > {limit}")
    if not fault_err > limit:
        fail(f"{what}: the planted fault reads {fault_err} <= {limit}; the check cannot tell "
             f"it from a sound run")


@contextlib.contextmanager
def captured_videos():
    """The sample videos the batch CLI hands to save_video_grid, by file
    name; the files are still written."""
    from moca_tpu_torch.cli import inference

    written, real = {}, inference.save_video_grid

    def capture(samples, path, fps=10):
        written[os.path.basename(path)] = samples
        real(samples, path, fps=fps)

    inference.save_video_grid = capture
    try:
        yield written
    finally:
        inference.save_video_grid = real


def run_batch_cli(pipe, argv, prompts, savedir, names=None):
    """moca_tpu_torch.cli.inference.main on a prompt file of `prompts` with
    `pipe` in place of the checkpoint's; returns ({mp4 name: [n_samples]
    [T] frames}, seconds). `names`: the mp4s it must write (by default one
    a prompt, named after it)."""
    import shutil

    from moca_tpu_torch.cli import inference

    shutil.rmtree(savedir, ignore_errors=True)
    os.makedirs(savedir)
    prompt_file = os.path.join(savedir, "prompts.txt")
    with open(prompt_file, "w") as f:
        f.write("\n".join(prompts) + "\n")
    args = inference.build_parser().parse_args(
        ["--ckpt_path", "random-weights", "--prompt_file", prompt_file, "--savedir", savedir,
         "--seed", str(SEED)] + list(argv))
    with captured_videos() as written:
        t0 = time.perf_counter()
        inference.main(args, pipe=pipe)
        seconds = time.perf_counter() - t0
    for name in names or [prompt[:100].replace("/", "_") + ".mp4" for prompt in prompts]:
        path = os.path.join(savedir, name)
        if name not in written or not os.path.getsize(path):
            fail(f"batch CLI {argv}: no video {path}")
    return written, seconds


def _check_clip(label, video, shape):
    import numpy as np

    clip = np.stack(video)
    if clip.shape != shape or not np.isfinite(clip).all():
        fail(f"{label}: clip {clip.shape} (want {shape}), finite={np.isfinite(clip).all()}")
    return clip


def phase_t2v_batch(model):
    """Batch text-to-video through the CLI on the full-width model: four
    prompts in one --bs 4 round (8 CFG rows x 16 frames), 50 DDIM steps,
    eta 1, guidance 12, fps 28 (the CLI's defaults); then prompts 0 and 1
    with --bs 1 and the same seed, prompt 0's clip held to the round's.
    Returns {run: {kernel: {shape: launches}}}."""
    import torch
    from moca_tpu_torch.models.tokenizer import HashTokenizer
    from moca_tpu_torch.pipelines.t2v import T2VPipeline

    pipe = T2VPipeline.build(model, HashTokenizer(), num_steps=50, eta=1.0,
                             guidance_scale=12.0, fps=28)
    root = os.path.join("build", "smoke_t2v")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    written, seconds = run_batch_cli(pipe, ["--bs", "4"], T2V_PROMPTS, os.path.join(root, "bs4"))
    launched = {"t2v_bs4": _launches("t2v bs4", ("flash_attention", "packed_attention"))}
    stages, peak = dict(pipe.timings), torch.cuda.max_memory_allocated() / 2**30
    clips = [_check_clip(f"t2v bs4 {p}", written[p + ".mp4"][0], (16, 320, 512, 3))
             for p in T2V_PROMPTS]
    call = sum(stages.values())
    print(f"[t2v bs4] 4 prompts, one round: {len(clips)} clips [16, 320, 512, 3], all finite; "
          f"the batched call {call:.2f} s ({call / 4:.2f} s a prompt), the CLI with its mp4s "
          f"{seconds:.2f} s ({seconds / 4:.2f} s a prompt); stages "
          f"{json.dumps({k: round(v, 3) for k, v in stages.items()})}; peak memory "
          f"{peak:.1f} GiB", flush=True)
    reset_counts()
    single, seconds1 = run_batch_cli(pipe, ["--bs", "1"], T2V_PROMPTS[:2],
                                     os.path.join(root, "bs1"))
    launched["t2v_bs1"] = _launches("t2v bs1", ("flash_attention", "packed_attention"))
    clip1 = [_check_clip(f"t2v bs1 {p}", single[p + ".mp4"][0], (16, 320, 512, 3))
             for p in T2V_PROMPTS[:2]]
    print(f"[t2v bs1] prompts 0 and 1, one a call: {seconds1:.2f} s; the last call's stages "
          f"{json.dumps({k: round(v, 3) for k, v in pipe.timings.items()})}", flush=True)
    # prompt 1 of the round drew prompt 0's noise, its --bs 1 run its own index's
    hold_batch_to_single("t2v bs4 prompt 0 vs bs1", clips[0], clip1[0], (clips[1], clip1[1]),
                         "prompt 1 of the round against its --bs 1 run, other noise",
                         BATCH_REL_TOL, clips[1])
    return launched


def phase_t2v_variants(model):
    """At full width, B=1, 10 DDIM steps: cfg_ours with temporal guidance
    (three U-Net calls a step; one forward with no_temporal_attn is shown to
    launch no K2), uncond_type='zero_embed', FreeInit with 2 iterations;
    then DDPM at 128x128 through the CLI with --ddim_steps 0, on a
    DDPM_STEPS-step schedule.
    Returns {run: {kernel: {shape: launches}}}."""
    import torch
    from moca_tpu_torch.models.tokenizer import HashTokenizer
    from moca_tpu_torch.pipelines.t2v import T2VPipeline

    tok = HashTokenizer()
    size = dict(height=320, width=512, frames=16)
    prompt = T2V_PROMPTS[0]
    launched = {}
    runs = (("cfg_ours_temporal", dict(uc_type="cfg_ours", temporal_cfg_scale=2.0), {}),
            ("zero_embed", dict(uncond_type="zero_embed"), {}),
            ("freeinit", {}, dict(iterations=2)))
    for run, build, call in runs:
        pipe = T2VPipeline.build(model, tok, num_steps=10, guidance_scale=12.0, fps=28, **build)
        reset_counts()
        t0 = time.perf_counter()
        if run == "freeinit":
            video = pipe.sample_with_freeinit(prompt, seed=SEED, **size, **call)
        else:
            video = pipe(prompt, seed=SEED, **size)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched[run] = _launches(f"t2v {run}", ("flash_attention", "packed_attention"))
        _check_clip(f"t2v {run}", video.float().cpu().numpy(), (16, 320, 512, 3))
        print(f"[t2v {run}] 10 DDIM steps, [16, 320, 512, 3], all finite: {seconds:.2f} s; "
              f"stages {json.dumps({k: round(v, 3) for k, v in pipe.timings.items()})}",
              flush=True)
        if run == "cfg_ours_temporal":  # the image branch skips every temporal transformer
            gen = torch.Generator(device="cuda").manual_seed(3)
            x = torch.randn((1, 16, 40, 64, 4), generator=gen, device="cuda")
            ctx = pipe.encode_prompts([prompt])
            reset_counts()
            with torch.inference_mode():
                model.apply_unet(x, torch.full((1, 16), 500, device="cuda"), ctx, 28,
                                 no_temporal_attn=True)
            counts = {fn.__name__: sum(fn.launches.values()) for fn in cuda_libs.TALLIED}
            if counts["packed_attention"] or not counts["flash_attention"]:
                fail(f"a forward with no_temporal_attn launched {counts}")
            print(f"[t2v no_temporal_attn] one forward launches {json.dumps(counts)}", flush=True)
    pipe = T2VPipeline.build(model, tok, num_steps=0, guidance_scale=12.0, fps=28,
                             num_timesteps=DDPM_STEPS)
    reset_counts()
    written, seconds = run_batch_cli(pipe, ["--ddim_steps", "0", "--height", "128",
                                            "--width", "128"], T2V_PROMPTS[:1],
                                     os.path.join("build", "smoke_t2v", "ddpm"))
    launched["t2v_ddpm"] = _launches("t2v ddpm", ("flash_attention", "packed_attention"))
    _check_clip("t2v ddpm", written[prompt + ".mp4"][0], (16, 128, 128, 3))
    print(f"[t2v ddpm] {DDPM_STEPS} DDPM steps at 128x128 through the CLI, [16, 128, 128, 3], "
          f"all finite: {seconds:.2f} s; stages "
          f"{json.dumps({k: round(v, 3) for k, v in pipe.timings.items()})}", flush=True)
    return launched


def phase_moca_batched(model, num_partitions: int, new_video_length: int):
    """MoCA with B=2 prompts at full width (32 U-Net rows an iteration), the
    concept image and conditioned prompt of phase 4, then prompt 0 alone at
    the same length and seed, held to stream 0. Returns {run: launches}."""
    import numpy as np
    import torch
    from moca_tpu_torch.models.tokenizer import HashTokenizer
    from moca_tpu_torch.pipelines.moca_video import MoCAVideoPipeline

    pipe = MoCAVideoPipeline(model, HashTokenizer(), video_length=16,
                             num_partitions=num_partitions,
                             new_video_length=new_video_length, guidance_scale=12.0)
    call = dict(seed=SEED, cond_image=np.full((40, 64, 4), 0.2, np.float32),
                conditioned_prompt="a dog", gamma=0.5, height=320, width=512)
    prompts = [T2V_PROMPTS[0], T2V_PROMPTS[2]]
    iters = new_video_length + pipe.num_inference_steps - 16
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    streams = pipe(prompts, **call)
    total = time.perf_counter() - t0
    launched = {"moca_b2": _launches("moca B=2", ("flash_attention", "packed_attention"))}
    t, peak = dict(pipe.timings), torch.cuda.max_memory_allocated() / 2**30
    for b, frames in enumerate(streams):
        _check_frames(f"MoCA B=2 stream {b}", frames, iters)
    steady = (t["fifo_iteration"] + t["decode"]) / iters
    print(f"[moca B=2] 2 streams x {iters} frames, all finite; total {total:.2f} s; steady "
          f"(FIFO+decode) {steady:.3f} s an iteration for the two streams "
          f"({steady / 2:.3f} s a frame); stages "
          f"{json.dumps({k: round(v, 3) for k, v in t.items()})}; peak memory {peak:.1f} GiB",
          flush=True)
    reset_counts()
    single = pipe(prompts[0], **call)
    launched["moca_b1"] = _launches("moca B=1", ("flash_attention", "packed_attention"))
    _check_frames("MoCA B=1", single, iters)
    t1 = pipe.timings
    print(f"[moca B=1] prompt 0 alone: steady {(t1['fifo_iteration'] + t1['decode']) / iters:.3f}"
          f" s a frame; stages {json.dumps({k: round(v, 3) for k, v in t1.items()})}",
          flush=True)
    # the regroup with the wrong stride: stream 0 read as the first frames of
    # the iteration-major list, both streams' frames interleaved
    flat = [frame for pair in zip(*streams) for frame in pair]
    hold_batch_to_single("moca B=2 stream 0 vs B=1", np.stack(streams[0]), np.stack(single),
                         (np.stack(flat[:iters]), np.stack(single)),
                         "stream 0 regrouped with stride 1", BATCH_REL_TOL,
                         np.stack(streams[1]))
    return launched


# --- phase 11: i2v ---------------------------------------------------------

I2V_IP_STD = 0.2  # to_k_ip / to_v_ip draw in the i2v U-Net check (see check_unet_i2v)
# The fp32 vision tower and projector on the card against the same on the
# CPU, relative to the largest value: both fp32, summed in another order
# (1.0e-6 observed on an H100); a dropped layer or a wrong resize is off by
# far more.
VISION_REL_TOL = 1e-4
# The fp32 metric towers (AlexNet, I3D) on the card against the CPU: 1.0e-5
# and 1.8e-4 observed on an H100, the convolutions summed in another order.
# The text tower runs in bf16 on the card and is held to UNET_REL_TOL.
METRIC_REL_TOL = 2e-3


def check_unet_i2v():
    """Phase 3's check on the i2v U-Net (use_image_attention) at a context of
    77 text and 16 image tokens: the bf16 forward with the kernels on the
    card against the fp32 plain path on the CPU. With phase 3's N(0, 0.05^2)
    weights the image tokens move the output by about 3 % of its largest
    value, inside UNET_REL_TOL, so a forward that dropped them would pass;
    to_k_ip / to_v_ip are drawn at I2V_IP_STD instead, the image branch then
    moves the output past the limit, and the planted fault (the image
    tokens zeroed on the card) must fail."""
    import torch

    ref_model, x, ts, ctx = reference_unet(77 + 16, use_image_attention=True)
    zeroed = ctx.clone()
    zeroed[:, 77:] = 0
    with torch.inference_mode():
        as_drawn = rel_max(ref_model(x, ts, zeroed, fps=10), ref_model(x, ts, ctx, fps=10))
    with torch.no_grad():
        for name, p in ref_model.named_parameters():
            if "_ip." in name:
                p.mul_(I2V_IP_STD / 0.05)
    with torch.inference_mode():
        ref = ref_model(x, ts, ctx, fps=10)
        change = rel_max(ref_model(x, ts, zeroed, fps=10), ref)
        gpu_model = ref_model.to("cuda", torch.bfloat16)
        reset_counts()
        out = gpu_model(x.cuda(), ts.cuda(), ctx.cuda(), fps=10).float().cpu()
        _launches("unet reference, i2v", ("flash_attention", "packed_attention"))
        fault = gpu_model(x.cuda(), ts.cuda(), zeroed.cuda(), fps=10).float().cpu()
    rel, fault_rel = rel_max(out, ref), rel_max(fault, ref)
    print(f"[unet reference, i2v] image tokens zeroed move the fp32 output by {as_drawn:.3e} "
          f"with to_k_ip/to_v_ip ~ N(0, 0.05^2), {change:.3e} at N(0, {I2V_IP_STD}^2); bf16 GPU "
          f"(kernels) vs fp32 CPU (plain): relative max err {rel:.3e} (tol {UNET_REL_TOL}); "
          f"planted fault (image tokens zeroed on the card) {fault_rel:.3e}", flush=True)
    if not math.isfinite(rel) or rel > UNET_REL_TOL:
        fail(f"i2v U-Net GPU vs CPU reference: relative max err {rel} > {UNET_REL_TOL}")
    if not fault_rel > UNET_REL_TOL:
        fail(f"i2v U-Net: the planted fault reads {fault_rel} <= {UNET_REL_TOL}")


def write_pngs(root, n, hw, seed):
    """n RGB PNGs of uniform noise from `seed`, {root}/fifo/{i}.png, through
    the port's PNG writer (utils/visualization.py); returns their paths."""
    import numpy as np
    from moca_tpu_torch.utils.visualization import VisualizationSink

    rng = np.random.default_rng(seed)
    sink = VisualizationSink(root)
    for i in range(n):
        sink.frame(i, rng.integers(0, 256, hw + (3,), dtype=np.uint8))
    return [os.path.join(root, "fifo", f"{i}.png") for i in range(n)]


def hold_vision_tower(model, img):
    """The vision tower's pooled and token outputs and the image tokens
    (tower + Resampler), fp32 on the card, against the fp32 CPU copies on
    one image; returns {output: relative max error}."""
    import copy

    import torch

    cpu_vision = copy.deepcopy(model.vision).to("cpu")
    cpu_proj = copy.deepcopy(model.image_proj).to("cpu")
    errs = {}
    with torch.inference_mode():
        for output in ("pooled", "tokens"):
            errs[output] = rel_max(model.vision(img, output=output).cpu(),
                                   cpu_vision(img, output=output))
        errs["image_tokens"] = rel_max(model.get_image_embeds(img).cpu(),
                                       cpu_proj(cpu_vision(img, output="tokens")))
    del cpu_vision, cpu_proj
    bad = {k: v for k, v in errs.items() if not v <= VISION_REL_TOL}
    if bad:
        fail(f"i2v vision tower on the card vs the CPU: {bad} > {VISION_REL_TOL}")
    return errs


def phase_i2v():
    """The i2v model at full width through the batch CLI's --mode i2v: the
    U-Net of configs/inference_t2v_512_v2.0.yaml with use_image_attention,
    the ViT-H/14 tower and the finegrained Resampler, random weights from
    the seed (U-Net, VAE, text tower bf16; tower and Resampler fp32); two
    prompts with two PNGs, 512x320, f=16, guidance 12, 10 DDIM steps.
    Returns {run: {kernel: {shape: launches}}}."""
    import shutil

    import torch
    from moca_tpu_torch.io.video import load_image_batch
    from moca_tpu_torch.models.clip_text import CLIPTextConfig
    from moca_tpu_torch.models.clip_vision import CLIPVisionConfig
    from moca_tpu_torch.models.latent_diffusion import init_random_visual_model
    from moca_tpu_torch.models.tokenizer import HashTokenizer
    from moca_tpu_torch.models.unet3d import UNetConfig
    from moca_tpu_torch.models.vae import VAEConfig
    from moca_tpu_torch.pipelines.t2v import T2VPipeline

    check_unet_i2v()
    launched = {}
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(4)
    model = init_random_visual_model(UNetConfig(use_image_attention=True), VAEConfig(),
                                     CLIPTextConfig(), CLIPVisionConfig(), gen, device="cuda",
                                     dtype=torch.bfloat16, finegrained=True)
    count = lambda m: sum(p.numel() for p in m.parameters()) / 1e6
    print(f"[i2v] model built in {time.perf_counter() - t0:.1f} s: U-Net {count(model.unet):.1f} M "
          f"(bf16), vision tower {count(model.vision):.1f} M and Resampler "
          f"{count(model.image_proj):.1f} M (fp32)", flush=True)
    root = os.path.join("build", "smoke_i2v")
    shutil.rmtree(root, ignore_errors=True)
    # two conditioning images, 0.png and 1.png in prompt order, and a stray
    # file the CLI's extension filter must skip
    paths = write_pngs(root, 2, (480, 640), SEED)
    cond_dir = os.path.dirname(paths[0])
    with open(os.path.join(cond_dir, "notes.txt"), "w") as f:
        f.write("not an image")
    img = torch.as_tensor(load_image_batch(paths[:1], (320, 512))[..., :3], device="cuda")
    errs = hold_vision_tower(model, img)
    with torch.inference_mode():
        tokens = model.get_image_embeds(img)
        feats = model.vision(img, output="tokens")
        tower_ms = cuda_ms(lambda: model.vision(img, output="tokens"), 5)
        proj_ms = cuda_ms(lambda: model.image_proj(feats), 10)
    if tuple(tokens.shape) != (1, 16, 1024) or not torch.isfinite(tokens).all():
        fail(f"i2v image tokens: shape {tuple(tokens.shape)}, "
             f"finite={bool(torch.isfinite(tokens).all())}")
    print(f"[i2v] image tokens {list(tokens.shape)}, finite; fp32 card vs fp32 CPU, relative max "
          f"err {json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})} (tol "
          f"{VISION_REL_TOL}); vision tower {tower_ms:.2f} ms, Resampler {proj_ms:.3f} ms an image "
          f"(CUDA events)", flush=True)
    pipe = T2VPipeline.build(model, HashTokenizer(), num_steps=10, guidance_scale=12.0, fps=28)
    names = [f"{i}.mp4" for i in range(len(paths))]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    written, seconds = run_batch_cli(
        pipe, ["--mode", "i2v", "--cond_input", cond_dir, "--ddim_steps", "10"],
        T2V_PROMPTS[:2], os.path.join(root, "out"), names)
    launched["i2v"] = _launches("i2v", ("flash_attention", "packed_attention"))
    if sorted(written) != names:
        fail(f"i2v CLI wrote {sorted(written)}, want {names}")
    for name in names:
        _check_clip(f"i2v {name}", written[name][0], (16, 320, 512, 3))
    print(f"[i2v] {len(names)} clips [16, 320, 512, 3] named after the images, all finite; "
          f"{seconds / len(names):.2f} s a clip through the CLI (10 DDIM steps, mp4 included); "
          f"the last call's stages {json.dumps({k: round(v, 3) for k, v in pipe.timings.items()})}"
          f"; peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB", flush=True)
    return launched


# --- phase 12: the evaluation sweep -------------------------------------------

SWEEP_ROW_KEYS = {"prompt", "temporal_consistency", "frame_ssim_adjacent",
                  "frame_psnr_adjacent", "sim_src_src", "sim_src_tgt", "sim_out_src",
                  "sim_out_tgt", "cass", "rel_cass", "lpips_i", "lpips_t"}
SWEEP_TOP_KEYS = {"_cass_convention", "_fvd_edited_vs_source"}  # scripts/eval_sweep.py:206-213


def i3d_state_dict(seed):
    """A pytorch-i3d InceptionI3d(400) state dict from `seed`: convolutions
    N(0, 1/fan_in), BatchNorm scales and variances U(0.5, 1.5), shifts and
    means N(0, 0.1^2); the logits unit with a bias."""
    import numpy as np
    import torch
    from moca_tpu_torch.eval.i3d import _INCEPTION_CFG

    rng = np.random.default_rng(seed)
    sd = {}
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))

    def unit(prefix, cin, cout, k=(1, 1, 1), bn=True):
        sd[f"{prefix}.conv3d.weight"] = t(rng.standard_normal((cout, cin) + k)
                                          / np.sqrt(cin * np.prod(k)))
        if bn:
            sd[f"{prefix}.bn.weight"] = t(rng.uniform(0.5, 1.5, cout))
            sd[f"{prefix}.bn.bias"] = t(0.1 * rng.standard_normal(cout))
            sd[f"{prefix}.bn.running_mean"] = t(0.1 * rng.standard_normal(cout))
            sd[f"{prefix}.bn.running_var"] = t(rng.uniform(0.5, 1.5, cout))
        else:
            sd[f"{prefix}.conv3d.bias"] = t(0.1 * rng.standard_normal(cout))

    unit("Conv3d_1a_7x7", 3, 64, (7, 7, 7))
    unit("Conv3d_2b_1x1", 64, 64)
    unit("Conv3d_2c_3x3", 64, 192, (3, 3, 3))
    cin = 192
    for name, (b0, b1a, b1b, b2a, b2b, b3b) in _INCEPTION_CFG.items():
        unit(f"{name}.b0", cin, b0)
        unit(f"{name}.b1a", cin, b1a)
        unit(f"{name}.b1b", b1a, b1b, (3, 3, 3))
        unit(f"{name}.b2a", cin, b2a)
        unit(f"{name}.b2b", b2a, b2b, (3, 3, 3))
        unit(f"{name}.b3b", cin, b3b)
        cin = b0 + b1b + b2b + b3b
    unit("logits", cin, 400, bn=False)
    return sd


def lpips_state_dicts(seed):
    """torchvision AlexNet features and LPIPS lin weights from `seed`."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    alex = {}
    for i, (o, c, k) in {0: (64, 3, 11), 3: (192, 64, 5), 6: (384, 192, 3), 8: (256, 384, 3),
                         10: (256, 256, 3)}.items():
        alex[f"features.{i}.weight"] = t(rng.standard_normal((o, c, k, k)) / np.sqrt(c * k * k))
        alex[f"features.{i}.bias"] = t(0.1 * rng.standard_normal(o))
    lins = {f"lin{i}.model.1.weight": t(np.abs(rng.standard_normal((1, ch, 1, 1))))
            for i, ch in enumerate([64, 192, 384, 256, 256])}
    return alex, lins


def write_sweep_inputs(model, root):
    """The sweep's inputs under `root`: a 2-row prompt CSV with its concept
    PNGs, and its three tower checkpoints in the layouts it reads: the
    OpenCLIP ViT-H/14 visual state dict (prefix '', fp32, random from the
    seed), {'alexnet', 'lpips'} and pytorch-i3d's names; and the text tower
    the CASS prompts go through (phase 4's, with a last block and
    text_projection from the seed) under cond_stage_model.model."""
    import torch
    from moca_tpu_torch.models.clip_vision import CLIPVisionConfig, CLIPVisionEncoder

    os.makedirs(root)
    rows = ["prompt,conditioned_object,conditioned_image_path,conditioned_prompt,gamma"]
    pngs = write_pngs(os.path.join(root, "concepts"), 2, (256, 256), SEED + 1)
    for path, prompt, concept in zip(pngs, (T2V_PROMPTS[0], T2V_PROMPTS[2]), ("dog", "cat")):
        rows.append(f"{prompt},{concept},{path},a {concept},0.5")
    with open(os.path.join(root, "prompts.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")
    gen = torch.Generator(device="cuda").manual_seed(5)
    with torch.device("cuda"):
        vision = CLIPVisionEncoder(CLIPVisionConfig())
    with torch.no_grad():
        for p in vision.parameters():
            p.copy_(torch.randn(p.shape, generator=gen, device="cuda") * 0.02)
    paths = {name: os.path.join(root, f"{name}.pt") for name in ("visual", "text", "lpips", "i3d")}
    torch.save({k: v.cpu() for k, v in vision.state_dict().items()}, paths["visual"])
    del vision
    layers = model.clip_cfg.layers
    text = {f"cond_stage_model.model.{k}": v.cpu() for k, v in model.clip.state_dict().items()}
    last = f"transformer.resblocks.{layers - 2}."
    for k, v in list(text.items()):  # the block conditioning stops before, drawn anew
        if last in k:
            text[k.replace(last, f"transformer.resblocks.{layers - 1}.")] = (
                torch.randn(v.shape, generator=gen, device="cuda") * 0.02).to(v.dtype).cpu()
    text["cond_stage_model.model.text_projection"] = (
        torch.randn((model.clip_cfg.width,) * 2, generator=gen, device="cuda") * 0.02).cpu()
    torch.save({"state_dict": text}, paths["text"])
    alex, lins = lpips_state_dicts(SEED)
    torch.save({"alexnet": alex, "lpips": lins}, paths["lpips"])
    torch.save(i3d_state_dict(SEED), paths["i3d"])
    return paths


def hold_metric_towers(model, paths):
    """Each metric tower on the card against its fp32 CPU version: the CLIP
    text `embed` of the two prompts (bf16 on the card), AlexNet-LPIPS on two
    320x512 frames, I3D logits on a 16-frame 224x224 clip; FVD of a set
    against itself (~0) and against a shifted set (> 0). Prints each
    tower's time on the card."""
    import numpy as np
    import torch
    from moca_tpu_torch.eval.fvd import fvd
    from moca_tpu_torch.eval.i3d import (
        convert_i3d_weights, i3d_feature_fn, i3d_logits, i3d_preprocess, params_to)
    from moca_tpu_torch.eval.metrics import convert_lpips_weights, lpips
    from moca_tpu_torch.io.checkpoint import load_text_tower
    from moca_tpu_torch.models.tokenizer import HashTokenizer

    rng = np.random.default_rng(SEED)
    errs, ms = {}, {}
    tokens = torch.as_tensor(HashTokenizer()([T2V_PROMPTS[0], "a dog"]), dtype=torch.long)
    with torch.inference_mode():
        card = load_text_tower(paths["text"], model.clip_cfg, "cuda", torch.bfloat16)
        cpu = load_text_tower(paths["text"], model.clip_cfg, "cpu", torch.float32)
        tok = tokens.cuda()
        errs["clip_text_embed"] = rel_max(card(tok, output="embed").cpu(),
                                          cpu(tokens, output="embed"))
        ms["clip_text_embed (2 prompts)"] = cuda_ms(lambda: card(tok, output="embed"), 10)
        del card, cpu
        blob = torch.load(paths["lpips"])
        net, lins = convert_lpips_weights(blob["alexnet"], blob["lpips"])
        frames = [rng.uniform(-1, 1, (1, 320, 512, 3)).astype(np.float32) for _ in range(2)]
        ref = lpips(frames[0], frames[1], net, lins)
        gpu_net = net.to("cuda")
        a, b = (torch.as_tensor(f, device="cuda") for f in frames)
        errs["lpips"] = rel_max(lpips(a, b, gpu_net, lins).cpu(), ref)
        ms["lpips (1 frame pair)"] = cuda_ms(lambda: lpips(a, b, gpu_net, lins), 10)
        params = convert_i3d_weights(torch.load(paths["i3d"]))
        clip = rng.uniform(0, 1, (1, 16, 224, 224, 3)).astype(np.float32)
        ref = i3d_logits(params, i3d_preprocess(clip))
        gpu_params = params_to(params, "cuda")
        x = i3d_preprocess(torch.as_tensor(clip, device="cuda"))
        errs["i3d_logits"] = rel_max(i3d_logits(gpu_params, x).cpu(), ref)
        ms["i3d (1 clip)"] = cuda_ms(lambda: i3d_logits(gpu_params, x), 5)
    tol = {"clip_text_embed": UNET_REL_TOL}
    bad = {k: v for k, v in errs.items() if not v <= tol.get(k, METRIC_REL_TOL)}
    if bad:
        fail(f"metric towers on the card vs fp32 on the CPU: {bad}")
    feature_fn = i3d_feature_fn(params, "cuda")
    videos = rng.uniform(0, 1, (4, 16, 224, 224, 3)).astype(np.float32)
    same = fvd(videos, videos, feature_fn, batch_size=2)
    shifted = fvd(videos, np.clip(videos + 0.25, 0, 1), feature_fn, batch_size=2)
    if not (shifted > 0 and abs(same) <= 1e-6 * shifted):
        fail(f"FVD: a set against itself {same}, against a shifted set {shifted}")
    print(f"[eval towers] card vs fp32 CPU, relative max err "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})} (tol: text "
          f"{UNET_REL_TOL} in bf16, the rest {METRIC_REL_TOL}); FVD of 4 clips against "
          f"themselves {same:.3e}, against the clips +0.25 {shifted:.4g}; times on the card "
          f"{json.dumps({k: round(v, 3) for k, v in ms.items()})} ms", flush=True)


def phase_eval_sweep(model):
    """moca_tpu_torch.cli.eval_sweep.main on phase 4's model: 2 prompt rows,
    the three metric towers from random checkpoints under build/, MoCA at
    f=16, n=1 (16 steps, the sweep's own n=4 cut), 16 new frames, each
    source clip from the base-latent cache. Returns {run: launches}."""
    import shutil

    import torch
    from moca_tpu_torch.cli import eval_sweep
    from moca_tpu_torch.models.tokenizer import HashTokenizer
    from moca_tpu_torch.pipelines.moca_video import MoCAVideoPipeline

    root = os.path.join("build", "smoke_eval")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    paths = write_sweep_inputs(model, root)
    print(f"[eval] inputs and tower checkpoints written in {time.perf_counter() - t0:.1f} s "
          f"({json.dumps({k: round(os.path.getsize(p) / 2**20, 1) for k, p in paths.items()})}"
          f" MiB)", flush=True)
    hold_metric_towers(model, paths)
    pipe = MoCAVideoPipeline(model, HashTokenizer(), video_length=16, num_partitions=1,
                             new_video_length=16, guidance_scale=12.0, eta=1.0, fps=10)
    out = os.path.join(root, "out")
    args = eval_sweep.build_parser().parse_args([
        "--ckpt_path", paths["text"], "--prompt_file", os.path.join(root, "prompts.csv"),
        "--out_dir", out, "--new_video_length", "16", "--seed", str(SEED),
        "--clip_vision_ckpt", paths["visual"], "--lpips_ckpt", paths["lpips"],
        "--i3d_ckpt", paths["i3d"]])
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    summary = eval_sweep.main(args, pipe=pipe)
    seconds = time.perf_counter() - t0
    launched = {"eval_sweep": _launches("eval sweep", ("flash_attention", "packed_attention"))}
    with open(os.path.join(out, "metrics_rank0.json")) as f:
        metrics = json.load(f)
    rows = {k: v for k, v in metrics.items() if not k.startswith("_")}
    top = set(metrics) - set(rows)
    values = [v for row in rows.values() for k, v in row.items() if k != "prompt"]
    fvd_value = metrics.get("_fvd_edited_vs_source")
    if (summary["videos"] != 2 or sorted(rows) != ["0", "1"] or top != SWEEP_TOP_KEYS
            or any(set(r) != SWEEP_ROW_KEYS for r in rows.values())
            or not all(math.isfinite(v) for v in values + [fvd_value or math.nan])):
        fail(f"eval sweep: summary {summary}, metrics {json.dumps(metrics)[:2000]}")
    for name in ("000.mp4", "001.mp4"):
        if not os.path.getsize(os.path.join(out, name)):
            fail(f"eval sweep wrote no {name}")
    print(f"[eval] the sweep: 2 videos in {seconds:.2f} s ({seconds / 2:.2f} s a video, "
          f"towers and checkpoint loads included); metrics_rank0.json has the JAX sweep's keys "
          f"(rows {sorted(SWEEP_ROW_KEYS)}, top {sorted(top)}); FVD(edited, source) "
          f"{fvd_value:.4g}; row 0 "
          f"{json.dumps({k: v for k, v in rows['0'].items() if k != 'prompt'})}; the last "
          f"call's stages {json.dumps({k: round(v, 3) for k, v in pipe.timings.items()})}; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB", flush=True)
    return launched


# --- phase 13: the mesh on one card --------------------------------------------

MESH_RANKS = 2
MESH_JOIN_S = 400  # each child's join timeout, seconds
MESH_DIR = os.path.join("build", "smoke_mesh")


def _halved(launched):
    """{kernel: {shape: n}} with each shape's leading rows halved: what one
    of two ranks launches where one process launched `launched`."""
    return {k: {(sh[0] // MESH_RANKS,) + tuple(sh[1:]): n for sh, n in by.items()}
            for k, by in launched.items() if by}


def swapped_gather(gather):
    """The planted fault: `gather` (parallel/mesh.py's gather_rows) with the
    two ranks' blocks swapped."""

    def swapped(mesh, block, n):
        return gather(mesh, block, mesh.size() * block.shape[0]).roll(-block.shape[0], 0)[:n]

    return swapped


def hold_gathers(pm, mesh, model):
    """The gathered output of the FIFO batch's U-Net call (16 rows, the
    154-token context) and of the head decode (8 latents), split over the
    ranks, against the whole call in this rank, on rows that all differ;
    then the same with the planted fault (`swapped_gather`). Returns
    {call: [relative L2, the fault's]}."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((16, 16, 40, 64, 4), generator=gen, device="cuda")
    ts = torch.randint(0, 1000, (16, 16), generator=gen, device="cuda")
    ctx = torch.randn((16, 154, 1024), generator=gen, device="cuda")
    heads = torch.randn((8, 40, 64, 4), generator=gen, device="cuda")
    calls = {
        "unet": (lambda: pm.make_sharded_unet_apply(model.apply_unet, mesh)(x, ts, ctx, 16),
                 lambda: model.apply_unet(x, ts, ctx, 16)),
        "decode": (lambda: pm.map_tiled_rows(model.decode_single, mesh, heads),
                   lambda: model.decode_single(heads)),
    }
    rel = lambda a, b: float((a.float() - b.float()).norm() / b.float().norm())
    out = {}
    with torch.inference_mode():
        for name, (sharded, whole) in calls.items():
            ref, got = whole(), sharded()
            gather, pm.gather_rows = pm.gather_rows, swapped_gather(pm.gather_rows)
            try:
                bad = sharded()
            finally:
                pm.gather_rows = gather
            out[name] = [rel(got, ref), rel(bad, ref)]
    return out


def _mesh_rank(rank, new_video_length, num_partitions):
    """One of phase 13's gloo ranks on cuda:0: the main path's call on a
    (1, 2) mesh, the gather alone, then the gathers' order
    (`hold_gathers`). Writes rank{r}.npz."""
    import hashlib

    import numpy as np
    import torch
    import torch.distributed as dist
    from moca_tpu_torch.models.tokenizer import HashTokenizer
    from moca_tpu_torch.parallel import mesh as pm
    from moca_tpu_torch.pipelines.moca_video import MoCAVideoPipeline

    store = os.path.abspath(os.path.join(MESH_DIR, "store"))
    torch.cuda.set_device(0)  # both ranks on the one card
    pm.initialize_distributed(f"file://{store}", MESH_RANKS, rank, backend="gloo")
    mesh = pm.make_mesh((1, MESH_RANKS))
    model = full_width_model()
    pipe = MoCAVideoPipeline(model, HashTokenizer(), video_length=16,
                             num_partitions=num_partitions, new_video_length=new_video_length,
                             guidance_scale=12.0, mesh=mesh)
    call = dict(main_path_call(), latents_dir=os.path.join(MESH_DIR, "latents"))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    dist.barrier()
    t0 = time.perf_counter()
    frames = np.stack(pipe(**call))
    total = time.perf_counter() - t0
    launched = {fn.__name__: {json.dumps(sh): n for sh, n in fn.launches.items()}
                for fn in cuda_libs.TALLIED}
    peak = torch.cuda.max_memory_allocated() / 2**30
    stages = dict(pipe.timings)

    block = torch.randn((8, 16, 40, 64, 4), device="cuda").to(torch.bfloat16)
    for _ in range(2):
        pm.gather_rows(mesh, block, 16)
    dist.barrier()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(10):
        pm.gather_rows(mesh, block, 16)
    torch.cuda.synchronize()
    gather_ms = (time.perf_counter() - t1) / 10 * 1e3
    gathers = hold_gathers(pm, mesh, model)
    dist.destroy_process_group()
    out = dict(digest=hashlib.sha256(frames.tobytes()).hexdigest(),
               stats=json.dumps(dict(total_s=total, stages=stages, peak_gib=peak,
                                     gather_ms=gather_ms, launched=launched, gathers=gathers)))
    if rank == 0:
        out["frames"] = frames
    np.savez(os.path.join(MESH_DIR, f"rank{rank}.npz"), **out)


def _mesh_cli(port, num_partitions):
    """Phase 13 (b): cli.main with --mesh 1,1 as torchrun starts one process
    (its environment, env://), so on NCCL; the pipeline on the full-width
    model. Writes cli.json."""
    os.environ.update(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    import torch.distributed as dist

    import moca_tpu_torch.cli.main as cli
    from moca_tpu_torch.models.tokenizer import HashTokenizer
    from moca_tpu_torch.pipelines.moca_video import MoCAVideoPipeline

    root = os.path.abspath(os.path.join(MESH_DIR, "cli"))
    concept = write_pngs(os.path.join(root, "concept"), 1, (64, 64), SEED)[0]
    prompts = os.path.join(root, "prompts.csv")
    with open(prompts, "w") as f:
        f.write("prompt,conditioned_object,conditioned_image_path,conditioned_prompt,gamma\n"
                f"a cat surfing,cat,{concept},a dog,0.5\n")
    seen = {}

    def load(args):
        mesh = cli.parse_mesh(args)
        seen.update(backend=dist.get_backend(), mesh=str(mesh), world=dist.get_world_size())
        return MoCAVideoPipeline(full_width_model(), HashTokenizer(),
                                 video_length=args.video_length,
                                 num_partitions=args.num_partitions,
                                 new_video_length=args.new_video_length,
                                 guidance_scale=args.unconditional_guidance_scale, mesh=mesh)

    cli.load_pipeline = load
    os.chdir(root)
    reset_counts()
    t0 = time.perf_counter()
    cli.main(cli.build_parser().parse_args([
        "--prompt_file", prompts, "--output_dir", "out", "--mesh", "1,1", "-n",
        str(num_partitions), "-l", "2", "--no_save_frames"]))
    seen.update(seconds=time.perf_counter() - t0, group_after=dist.is_initialized(),
                launched={fn.__name__: {json.dumps(sh): n for sh, n in fn.launches.items()}
                          for fn in cuda_libs.TALLIED},
                video=os.path.exists(os.path.join(
                    root, "out", os.path.splitext(os.path.basename(concept))[0],
                    "a cat surfing.mp4")))
    with open(os.path.join(root, "cli.json"), "w") as f:
        json.dump(seen, f)


def _run_children(label, targets):
    """Start every (target, args) in a spawned process, join each within
    MESH_JOIN_S; fails if one hangs, dies or exits non-zero."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=t, args=a) for t, a in targets]
    for p in procs:
        p.start()
    deadline = time.monotonic() + MESH_JOIN_S
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    hung = [i for i, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if hung or any(codes):
        fail(f"{label}: children hung {hung}, exit codes {codes}")


def _decoded_launches(launched):
    return {k: {tuple(json.loads(sh)): n for sh, n in by.items()} for k, by in launched.items()}


def phase_mesh(main_frames, main_launches, new_video_length: int, num_partitions: int):
    """(a) the main path's call on two gloo ranks sharing cuda:0, each with its
    own model (8 of the 16 U-Net rows a rank), rank 0's frames held to phase
    4's one-process run (MESH_REL_TOL), every rank's frames the same, K1/K2
    launches half phase 4's rows at phase 4's counts, each rank's gathered
    U-Net and decode outputs held to the whole calls (BATCH_REL_TOL; the
    planted fault: the two ranks' blocks swapped in the gather); (b) one NCCL rank through cli.main --mesh 1,1 at n=1; (c)
    cli.main --mesh 1,2 without WORLD_SIZE=2 raising the ValueError.
    Returns {run: launches}."""
    import shutil
    import socket

    import numpy as np
    import torch

    import moca_tpu_torch.cli.main as cli

    shutil.rmtree(MESH_DIR, ignore_errors=True)
    os.makedirs(MESH_DIR)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _run_children("phase 13 (a), two gloo ranks", [
        (_mesh_rank, (r, new_video_length, num_partitions)) for r in range(MESH_RANKS)])
    wall = time.perf_counter() - t0
    outs = [dict(np.load(os.path.join(MESH_DIR, f"rank{r}.npz"))) for r in range(MESH_RANKS)]
    stats = [json.loads(str(o["stats"])) for o in outs]
    if len({str(o["digest"]) for o in outs}) != 1:
        fail("phase 13: the two ranks returned different frames")
    frames, ref = outs[0]["frames"], np.stack(main_frames)
    iters = new_video_length + 16 * num_partitions - 16
    _check_frames("phase 13 rank 0", list(frames), iters)
    err = rel_l2(frames, ref)
    if not err <= MESH_REL_TOL:
        fail(f"phase 13: rank 0's frames against the one-process run: relative L2 {err} "
             f"(limit {MESH_REL_TOL})")
    for r, st in enumerate(stats):
        for name, (g_err, g_fault) in st["gathers"].items():
            if not g_err <= BATCH_REL_TOL < g_fault:
                fail(f"phase 13 rank {r}: the {name} call's gathered output against the whole "
                     f"call: relative L2 {g_err}, the planted block swap {g_fault} (limit "
                     f"{BATCH_REL_TOL})")
    shapes = {}
    expect = {k: v for k, v in _halved(main_launches).items()
              if k in ("flash_attention", "packed_attention")}
    for r, st in enumerate(stats):
        launched = _decoded_launches(st["launched"])
        got = {k: v for k, v in launched.items() if v and k in KERNEL_NAMES}
        if got != expect:
            fail(f"phase 13 rank {r}: launches {got} != half of phase 4's rows {expect}")
        if launched.get("moca_scan") != main_launches.get("moca_scan"):
            fail(f"phase 13 rank {r}: MoCA scan launches {launched.get('moca_scan')} != phase "
                 f"4's {main_launches.get('moca_scan')} (every rank runs the whole loop)")
        MOCA_TALLY[f"mesh rank {r}"] = {"scan_launches": sum(launched["moca_scan"].values())}
        shapes[f"mesh_rank{r}"] = launched
        t = st["stages"]
        print(f"[mesh rank {r}] {iters} iterations; steady (FIFO+decode) "
              f"{(t['fifo_iteration'] + t['decode']) / iters:.3f} s an iteration; whole call "
              f"{st['total_s']:.2f} s; stages {json.dumps({k: round(v, 3) for k, v in t.items()})}"
              f"; peak memory {st['peak_gib']:.1f} GiB; gather of 8 of 16 U-Net rows "
              f"[8, 16, 40, 64, 4] bf16 over gloo {st['gather_ms']:.2f} ms; launches K1 "
              f"{sum(launched['flash_attention'].values())}, K2 "
              f"{sum(launched['packed_attention'].values())} (half of phase 4's rows, its "
              f"counts); gathered against the whole call, relative L2 (the planted block "
              f"swap): {'; '.join(f'{k} {a:.3e} ({b:.3e})' for k, (a, b) in st['gathers'].items())}"
              f" (limit {BATCH_REL_TOL})", flush=True)
    print(f"[mesh] two gloo ranks on one card: {wall:.1f} s for both processes; rank 0's "
          f"{len(frames)} frames against phase 4's one-process run: relative L2 {err:.3e} "
          f"(limit {MESH_REL_TOL}); both ranks' frames identical", flush=True)

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    _run_children("phase 13 (b), one NCCL rank through the CLI", [(_mesh_cli, (port, 1))])
    with open(os.path.join(MESH_DIR, "cli", "cli.json")) as f:
        seen = json.load(f)
    if seen["backend"] != "nccl" or seen["world"] != 1 or seen["group_after"] or not seen["video"]:
        fail(f"phase 13 (b): {seen}")
    shapes["mesh_cli"] = _decoded_launches(seen.pop("launched"))
    print(f"[mesh cli] --mesh 1,1 under torchrun's environment: {json.dumps(seen)}", flush=True)

    os.environ.pop("WORLD_SIZE", None)
    try:
        cli.main(cli.build_parser().parse_args(["--mesh", "1,2"]))
    except ValueError as exc:
        print(f"[mesh cli] --mesh 1,2 without WORLD_SIZE=2 refused: {exc}", flush=True)
    else:
        fail("phase 13 (c): --mesh 1,2 without WORLD_SIZE=2 was not refused")
    return shapes


# --- phase 14: the user scripts ----------------------------------------------

SHIPPED_YAML = "configs/inference_t2v_512_v2.0.yaml"
SCRIPTS_DIR = "build/smoke_scripts"
# a BPE merge table of four merges: the acceptance's tokenizer stage loads
# it (no known-answer ids: it is not the 49408-entry CLIP table)
TINY_BPE = "version\nc a\nca t</w>\nd o\ndo g</w>\n"
TOWER_PREFIXES = (("unet", "model.diffusion_model."), ("vae", "first_stage_model."),
                  ("clip", "cond_stage_model.model."))


def write_upstream_checkpoint(path, seed):
    """The shipped widths (SHIPPED_YAML) with random fp32 weights N(0, 0.02^2)
    from a CUDA generator seeded `seed`, saved as the upstream model.ckpt
    is laid out: {"state_dict": ...} with each tower under its prefix.
    Returns the file's bytes."""
    import torch
    from moca_tpu_torch.config import load_model_config
    from moca_tpu_torch.models.latent_diffusion import init_random_model

    cfg = load_model_config(SHIPPED_YAML)
    model = init_random_model(cfg.unet, cfg.vae, cfg.clip,
                              torch.Generator(device="cuda").manual_seed(seed), device="cuda",
                              dtype=torch.float32)
    sd = {prefix + k: v.cpu() for tower, prefix in TOWER_PREFIXES
          for k, v in getattr(model, tower).state_dict().items()}
    del model
    torch.save({"state_dict": sd}, path)
    return os.path.getsize(path)


def run_acceptance(ckpt, bpe):
    """moca_tpu_torch.cli.acceptance.main on the checkpoint, fp32 by default,
    at 512x320, f=16, n=ACCEPT_PARTITIONS, ACCEPT_NEW_FRAMES new frames,
    --skip_oracles, with the run's own golden_frames.npz as the reference:
    exit 0 with convert, tokenizer, golden and ssim ok, and the fp32 paths
    of K1 and K2 launched. Then the planted fault: the golden frames rolled
    by W/4 along the width, through `stage_ssim` on the same golden array,
    must fail the gate. Returns the run's launches."""
    import numpy as np
    import torch
    from moca_tpu_torch.cli import acceptance

    out, art = os.path.join(SCRIPTS_DIR, "verdict.json"), os.path.join(SCRIPTS_DIR, "accept")
    golden_npz = os.path.join(art, "golden_frames.npz")
    argv = ["--ckpt", ckpt, "--bpe", bpe, "--config", SHIPPED_YAML, "--out", out,
            "--artifacts", art, "--num_partitions", str(ACCEPT_PARTITIONS),
            "--new_video_length", str(ACCEPT_NEW_FRAMES), "--skip_oracles",
            "--reference_frames", golden_npz]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    code = acceptance.main(argv)
    total = time.perf_counter() - t0
    launched = _launches("acceptance", ("flash_attention", "packed_attention"))
    with open(out) as f:
        report = json.load(f)
    st = report["stages"]
    bad = [k for k in ("convert", "tokenizer", "golden", "ssim") if st[k]["ok"] is not True]
    if code != 0 or bad or st["oracles"].get("skipped") != "--skip_oracles":
        fail(f"phase 14 (a): acceptance exit {code}, stages not ok {bad}: {json.dumps(report)}")
    k1, k2 = (fp32_launches(launched[n]) for n in ("flash_attention", "packed_attention"))
    if not (k1 and k2):
        fail(f"phase 14 (a): the fp32 golden clip launched K1's fp32 path {k1} and K2's {k2} "
             f"times")
    print(f"[acceptance] exit 0 in {total:.1f} s: convert {st['convert']['ckpt_keys']} keys, "
          f"towers {st['convert']['unet_params']} / {st['convert']['vae_params']} / "
          f"{st['convert']['clip_params']} params; tokenizer vocab {st['tokenizer']['vocab_size']}; "
          f"golden {st['golden']['frames']} frames in {st['golden']['seconds']} s "
          f"(fp32, n={ACCEPT_PARTITIONS}, {ACCEPT_NEW_FRAMES} new frames); ssim min "
          f"{st['ssim']['ssim_per_frame_min']} (gate {st['ssim']['threshold']}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; fp32 launches K1 {k1}, K2 {k2}",
          flush=True)

    golden = np.load(golden_npz)["frames"]
    args = acceptance.build_parser().parse_args(argv)
    args.reference_frames = os.path.join(SCRIPTS_DIR, "fault.npz")
    read = None
    for kind, ref in (
            ("the golden frames rolled by W/4 along the width",
             lambda: np.roll(golden, golden.shape[2] // 4, axis=2)),
            ("seeded noise N(0, 0.5^2) added to the golden frames",
             lambda: np.clip(golden + np.random.default_rng(SEED).normal(
                 0.0, 0.5, golden.shape).astype(np.float32), -1.0, 1.0))):
        if read is not None:
            print(f"[acceptance] the previous fault read SSIM {read['ssim_per_frame_min']} >= "
                  f"{read['threshold']}: random weights make the frames too flat; planting "
                  f"{kind} instead", flush=True)
        np.savez(args.reference_frames, frames=ref())
        fault = {"stages": {}}
        acceptance.stage_ssim(args, fault, golden)
        read = fault["stages"]["ssim"]
        if read["ok"] is False:
            print(f"[acceptance] planted fault ({kind}): SSIM min {read['ssim_per_frame_min']} "
                  f"< {read['threshold']}, the gate fails it", flush=True)
            return launched
    fail(f"phase 14 (a): no planted fault fails the SSIM gate: {read}")


PNG_RGBA = 6  # the IHDR colour type of 8-bit RGBA


def png_header(path):
    """(width, height, colour type) from a PNG's IHDR chunk."""
    import struct

    with open(path, "rb") as f:
        head = f.read(26)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        fail(f"{path} is not a PNG")
    return struct.unpack(">II", head[16:24]) + (head[25],)


def run_condition_images(ckpt, bpe):
    """moca_tpu_torch.cli.generate_condition_images.main at its defaults
    (512x320, 50 DDIM steps, bf16, the checkpoint loaded by cli.main's
    loader) on a CSV of two rows whose images are missing: two RGBA PNGs of
    512x320 that differ and are not flat. Returns the run's launches."""
    import numpy as np
    from moca_tpu_torch.cli import generate_condition_images
    from moca_tpu_torch.io.video import load_image_batch

    csv, assets = os.path.join(SCRIPTS_DIR, "prompts.csv"), os.path.join(SCRIPTS_DIR, "assets")
    with open(csv, "w") as f:
        f.write("prompt,conditioned_object,conditioned_image_path,conditioned_prompt,gamma\n"
                f"a red fox,cat,{assets}/cat.png,a cat,0.4\n"
                f"a blue bird,dog,{assets}/dog.png,a dog,0.6\n")
    reset_counts()
    t0 = time.perf_counter()
    written = generate_condition_images.main(
        ["--ckpt_path", ckpt, "--config", SHIPPED_YAML, "--prompts_file", csv,
         "--assets_dir", assets, "--bpe_path", bpe])
    total = time.perf_counter() - t0
    launched = _launches("condition images", ("flash_attention",))
    headers = [png_header(p) for p in written]
    arrs = load_image_batch(written, (320, 512)) if len(written) == 2 else None
    if (headers != [(512, 320, PNG_RGBA)] * 2 or np.array_equal(arrs[0], arrs[1])
            or any(a[..., :3].std() == 0 for a in arrs)):
        fail(f"phase 14 (b): want two RGBA 512x320 images that differ and are not flat, got "
             f"(width, height, PNG colour type) {headers}")
    print(f"[condition images] 2 RGBA 512x320 PNGs (bf16, 50 steps) in {total:.1f} s with the "
          f"checkpoint's load, {total / 2:.2f} s an image; mean |difference| "
          f"{127.5 * np.abs(arrs[0] - arrs[1]).mean():.2f} levels", flush=True)
    return launched


def run_video_scripts():
    """moca_tpu_torch.cli.v2i and cli.convert_gifs on phase 6's 72 frames,
    written as an mp4 and a gif: v2i's PNGs equal io/video.py's reading of
    the mp4 frame for frame (every frame, and every 2nd with --frame_rate
    2); convert_gifs' mp4 equals io/video.py's save_video of the gif's
    frames, read back."""
    import numpy as np
    from moca_tpu_torch.cli import convert_gifs, v2i
    from moca_tpu_torch.cli.acceptance import load_reference_frames
    from moca_tpu_torch.io.video import (load_gif_frames, load_video_frames, save_video,
                                         tensor_to_uint8, uint8_to_tensor)

    frames = list(davis_inputs()[0])
    mp4 = os.path.join(SCRIPTS_DIR, "clip.mp4")
    gif = os.path.join(SCRIPTS_DIR, "gifs", "clip.gif")
    save_video(frames, mp4, fps=10)
    save_video(frames, gif, fps=10)
    ref = load_video_frames(mp4)
    for stride in (1, 2):
        t0 = time.perf_counter()
        paths = v2i.main(["--video_path", mp4, "--output_dir",
                          os.path.join(SCRIPTS_DIR, f"frames_{stride}"),
                          "--frame_rate", str(stride), "--image_format", "png"])
        ms = (time.perf_counter() - t0) * 1e3
        want = uint8_to_tensor(tensor_to_uint8(ref[::stride]))
        got = load_reference_frames(os.path.dirname(paths[0])) if paths else None
        if len(paths) != len(want) or not np.array_equal(got, want):
            fail(f"phase 14 (c): v2i --frame_rate {stride} wrote {len(paths)} frames, want "
                 f"{len(want)} equal to io/video.py's")
        print(f"[v2i] --frame_rate {stride}: {len(paths)} PNGs equal to io/video.py's frames, "
              f"{ms:.1f} ms host", flush=True)
    t0 = time.perf_counter()
    outs = convert_gifs.main([os.path.dirname(gif)])
    ms = (time.perf_counter() - t0) * 1e3
    direct = os.path.join(SCRIPTS_DIR, "gif_direct.mp4")
    save_video(load_gif_frames(gif), direct, fps=10)
    if len(outs) != 1:
        fail(f"phase 14 (c): convert_gifs wrote {outs}, want one mp4")
    got, want = load_video_frames(outs[0]), load_video_frames(direct)
    if got.shape != (72, 320, 512, 3) or not np.array_equal(got, want):
        fail(f"phase 14 (c): convert_gifs' mp4 {got.shape} is not io/video.py's mp4 of the gif")
    print(f"[convert_gifs] 1 gif -> {outs[0]}, 72 frames equal to io/video.py's mp4 of the "
          f"gif's frames, {ms:.1f} ms host", flush=True)


def phase_user_scripts():
    """(a) the acceptance certification and (b) the condition images on a
    synthetic full-size checkpoint written under build/ and deleted after
    them; (c) v2i and convert_gifs; (d) the verification drive on the card.
    Returns {run: launches}."""
    import gzip
    import shutil
    from moca_tpu_torch.cli import verify_drive

    shutil.rmtree(SCRIPTS_DIR, ignore_errors=True)
    os.makedirs(SCRIPTS_DIR)
    ckpt, bpe = os.path.join(SCRIPTS_DIR, "model.ckpt"), os.path.join(SCRIPTS_DIR, "bpe.txt.gz")
    with gzip.open(bpe, "wt", encoding="utf-8") as f:
        f.write(TINY_BPE)
    t0 = time.perf_counter()
    nbytes = write_upstream_checkpoint(ckpt, seed=3)
    print(f"[scripts] synthetic upstream checkpoint, {nbytes / 1e9:.2f} GB fp32, written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    try:
        launched = {"acceptance": run_acceptance(ckpt, bpe),
                    "condition_images": run_condition_images(ckpt, bpe)}
    finally:
        os.remove(ckpt)
    run_video_scripts()
    t0 = time.perf_counter()
    drive = verify_drive.main(["--out_dir", os.path.join(SCRIPTS_DIR, "verify")])
    print(f"[verify drive] on the card: {len(drive['frames'])} frames, mp4 and gif written, "
          f"cached rerun identical, {time.perf_counter() - t0:.1f} s", flush=True)
    return launched


def phase_profile(model, rows: int, ctx_len: int, rows_fp32: int, f: int = 16):
    """Where one FIFO U-Net forward spends device time, as shipped and with
    both switches: CUDA-event time of the call, then one torch.profiler trace
    (device activity only) summed by kernel category, with the device's idle
    share over the trace's device span (first kernel start to last kernel
    end). Then the two forwards' outputs on the same input are compared.
    Last, `fp32_forwards` at `rows_fp32` rows; returns their launches."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((rows, f, 40, 64, 4), generator=gen, device="cuda")
    ts = torch.randint(0, 1000, (rows, f), generator=gen, device="cuda")
    ctx = torch.randn((rows, ctx_len, 1024), generator=gen, device="cuda")
    out = {}
    for run in ("default", "switched"):
        with switches_on() if run == "switched" else contextlib.nullcontext():
            out[run] = profile_forward(model, x, ts, ctx, run)
    ref = out["default"].float()
    rel = ((out["switched"].float() - ref).abs().max() / ref.abs().max()).item()
    if not math.isfinite(rel) or rel > SWITCHED_REL_TOL:
        fail(f"switched U-Net forward vs default: relative max err {rel} > {SWITCHED_REL_TOL}")
    print(f"[profile] switched forward vs default forward, same input: relative max err "
          f"{rel:.3e} (tol {SWITCHED_REL_TOL})", flush=True)
    del out, ref
    launched = fp32_forwards(model, rows_fp32, ctx_len)
    launched.update(head160_forward(rows, ctx_len))
    return launched


@contextlib.contextmanager
def unet_packed_swapped(fn):
    """The U-Net's `packed_attention` replaced by `fn`, a patch of this
    script's (the package has no such switch)."""
    from moca_tpu_torch.models import unet3d

    kernel = unet3d.packed_attention
    unet3d.packed_attention = fn
    try:
        yield kernel
    finally:
        unet3d.packed_attention = kernel


def packed_held_to_plain(kernel, errors, first):
    """`kernel` (K2's wrapper) that also computes the plain version on the
    same inputs and records the worst-row error of each call in `errors`,
    and the first call's inputs in `first`."""
    from moca_tpu_torch.ops import flash_attention as fa

    def held(q, k, v, heads):
        out = kernel(q, k, v, heads)
        errors.append(max_row_rel_err(out, fa.packed_attention_plain(q, k, v, heads),
                                      q.shape[-1] // heads))
        if not first:
            first.extend((q, k, v, heads))
        return out
    return held


def head160_forward(rows: int, ctx_len: int, f: int = 16):
    """One bf16 U-Net forward at the shipped widths but num_head_channels=160
    on `rows` x f frames at 40 x 64: the temporal attention's 2, 4 and 8
    heads of 160 and the init attention's 8 (C = 1280) on K2, the spatial
    attention on the plain path (d = 160 is no K1 width; XLA in the
    reference). Random weights from a CUDA generator seeded 4: N(0, 0.02^2),
    but the temporal attentions' to_q, to_k, to_v and out projection at unit
    gain (std fan_in^-1/2) and the LayerNorms before them at their default
    (1, 0), so that their logits are O(1) and their output moves the
    forward. Its launches counted over one forward (K2 once at every
    temporal and init attention, no other kernel), then timed (CUDA events,
    mean of 3 after that forward), every K2 call of that forward held to
    its plain version on the same inputs (KERNEL_TOL; two planted faults on
    the first call, its last key left out and its scale halved, must read
    above it), and the forward held within SWITCHED_REL_TOL to the same
    forward with `packed_attention` swapped for its plain version; the
    forward with K2's output zeroed must read above SWITCHED_REL_TOL, so that
    this comparison can see a kernel fault. Returns {run: launches}."""
    import torch
    from moca_tpu_torch.models.unet3d import (BasicTransformerBlock, CrossAttention,
                                              TemporalTransformer, UNet3D, UNetConfig)
    from moca_tpu_torch.ops import flash_attention as fa

    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(4)
    with torch.device("cuda"):
        unet = UNet3D(UNetConfig(num_head_channels=HEAD160))
    unet.to(torch.bfloat16).eval().requires_grad_(False)
    temporal = [m for tt in unet.modules() if isinstance(tt, TemporalTransformer)
                for m in tt.modules() if isinstance(m, CrossAttention)]
    unit_gain = {id(lin.weight) for m in temporal
                 for lin in (m.to_q, m.to_k, m.to_v, m.to_out[0])}
    with torch.no_grad():
        for p in unet.parameters():
            std = p[0].numel() ** -0.5 if id(p) in unit_gain else 0.02
            p.copy_(torch.randn(p.shape, generator=gen, device="cuda") * std)
        for block in unet.modules():
            if isinstance(block, BasicTransformerBlock) and block.attn1 in temporal:
                for norm in (block.norm1, block.norm2):
                    norm.weight.fill_(1.0)
                    norm.bias.zero_()
    x = torch.randn((rows, f, 40, 64, 4), generator=gen, device="cuda")
    ts = torch.randint(0, 1000, (rows, f), generator=gen, device="cuda")
    ctx = torch.randn((rows, ctx_len, 1024), generator=gen, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        errors, first = [], []
        with unet_packed_swapped(packed_held_to_plain(fa.packed_attention, errors, first)):
            reset_counts()
            out = unet(x, ts, ctx, fps=10)
            torch.cuda.synchronize()
        launched = _launches("phase 5 num_head_channels=160", ("packed_attention",))
        fwd_ms = cuda_ms(lambda: unet(x, ts, ctx, fps=10), reps=3, warmup=0)  # warm from above
        if len(errors) != len(temporal) or not max(errors) <= KERNEL_TOL:
            fail(f"phase 5 num_head_channels=160: K2 calls against their plain versions: "
                 f"{len(errors)} calls, worst row {max(errors, default=math.inf)} "
                 f"(tol {KERNEL_TOL})")
        # the per-call check can see a fault on these inputs: the first call
        # with its last key left out of PV and with its scale halved (launched
        # after the tally was read)
        q, k, v, heads = first
        v_cut = v.clone()
        v_cut[:, -1] = 0
        ref = fa.packed_attention_plain(q, k, v, heads)
        faults = [max_row_rel_err(fa.packed_attention(*args, heads), ref, q.shape[-1] // heads)
                  for args in ((q, k, v_cut), (q * 0.5, k, v))]
        if not min(faults) > KERNEL_TOL:
            fail(f"phase 5 num_head_channels=160: the planted faults read {faults}, "
                 f"not all above {KERNEL_TOL}")
        del first, q, k, v, v_cut, ref
        counts = {name: sum(by_shape.values()) for name, by_shape in launched.items()
                  if name in KERNEL_NAMES}
        want = {name: 0 for name in counts} | {"packed_attention": len(temporal)}
        if counts != want:
            fail(f"phase 5 num_head_channels=160: launches {counts}, want {want} (K2 once at "
                 f"each of the {len(temporal)} temporal and init attentions, nothing else)")
        with unet_packed_swapped(fa.packed_attention_plain):
            reset_counts()
            twin = unet(x, ts, ctx, fps=10)
            torch.cuda.synchronize()
            if fa.packed_attention.launches:
                fail("phase 5: the plain-swapped forward still launched K2")
        with unet_packed_swapped(lambda q, k, v, heads: torch.zeros_like(q)):
            dropped = rel_max(unet(x, ts, ctx, fps=10), out)
    finite = bool(torch.isfinite(out.float()).all())
    rel = rel_max(out, twin)
    if not finite or not rel <= SWITCHED_REL_TOL:
        fail(f"phase 5 num_head_channels=160: K2 forward vs its plain-swapped twin: "
             f"finite={finite}, relative max err {rel} > {SWITCHED_REL_TOL}")
    if not dropped > SWITCHED_REL_TOL:
        fail(f"phase 5 num_head_channels=160: K2's output zeroed moves the forward by "
             f"{dropped} <= {SWITCHED_REL_TOL}: the comparison with the twin cannot see a fault")
    print(f"[profile head 160] U-Net forward at num_head_channels={HEAD160}, {rows} rows x {f} "
          f"frames, context {ctx_len}: {fwd_ms:.1f} ms (CUDA events, mean of 3); K2 at all "
          f"{len(temporal)} temporal and init attentions (shapes "
          f"{sorted(launched['packed_attention'])}), the spatial attention plain; each K2 call "
          f"within {max(errors):.3e} of its plain version (worst row, tol {KERNEL_TOL}; the "
          f"first call's planted faults, last key left out and scale halved, read "
          f"{faults[0]:.3e} and {faults[1]:.3e}); the forward within {rel:.3e} of the "
          f"plain-swapped forward (relative max, tol {SWITCHED_REL_TOL}), and {dropped:.3e} "
          f"from the forward with K2's output zeroed (must exceed the tol); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB", flush=True)
    del unet, out, twin
    torch.cuda.empty_cache()
    return {"unet_d160": launched}


def fp32_forwards(model, rows: int, ctx_len: int, f: int = 16):
    """The full-width U-Net in fp32 on the card (a copy of the model's; its
    kernels' fp32 paths), one forward at the golden clip's FIFO rows as
    shipped and one with MOCA_TPU_FA_FUSED_QKV=1 (K3's fp32 path at every
    temporal attention): each timed (CUDA events, mean of 2 after a
    warm-up), its launches counted over one more forward, the two outputs
    on the same input held to FP32_UNET_REL_TOL of each other. Returns
    {run: launches}."""
    import copy

    import torch

    unet = copy.deepcopy(model.unet).float()
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((rows, f, 40, 64, 4), generator=gen, device="cuda")
    ts = torch.randint(0, 1000, (rows, f), generator=gen, device="cuda")
    ctx = torch.randn((rows, ctx_len, 1024), generator=gen, device="cuda")
    out, launched, fwd_ms = {}, {}, {}
    with torch.inference_mode():
        for run, env, expect in (
                ("unet_fp32_full", {}, ("flash_attention", "packed_attention")),
                ("unet_fp32_full_fused", FUSED_ONLY, ("flash_attention", "fused_qkv_attention"))):
            with switches_on(env):
                fwd_ms[run] = cuda_ms(lambda: unet(x, ts, ctx, fps=10), reps=2, warmup=1)
                reset_counts()
                out[run] = unet(x, ts, ctx, fps=10)
                torch.cuda.synchronize()
                launched[run] = _launches(f"phase 5 {run}", expect)
    finite = all(bool(torch.isfinite(o).all()) for o in out.values())
    rel = rel_max(out["unet_fp32_full_fused"], out["unet_fp32_full"])
    if not finite or not rel <= FP32_UNET_REL_TOL:
        fail(f"fp32 U-Net forward with MOCA_TPU_FA_FUSED_QKV=1 vs as shipped: finite={finite}, "
             f"relative max err {rel} > {FP32_UNET_REL_TOL}")
    print(f"[profile fp32] full-width U-Net forward in fp32 at {rows} rows x {f} frames, context "
          f"{ctx_len}: as shipped {fwd_ms['unet_fp32_full']:.1f} ms, with MOCA_TPU_FA_FUSED_QKV=1 "
          f"{fwd_ms['unet_fp32_full_fused']:.1f} ms (CUDA events, mean of 2); outputs within "
          f"{rel:.3e} (relative max, tol {FP32_UNET_REL_TOL})", flush=True)
    del unet, out
    torch.cuda.empty_cache()
    return launched


def profile_forward(model, x, ts, ctx, label):
    import torch
    from torch.profiler import ProfilerActivity, profile

    rows, f = x.shape[:2]
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: model.apply_unet(x, ts, ctx, 10), reps=3, warmup=1)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = model.apply_unet(x, ts, ctx, 10)
            torch.cuda.synchronize()
    print(f"[profile {label}] U-Net forward at {rows} rows x {f} frames, context "
          f"{ctx.shape[1]}: {fwd_ms:.1f} ms (CUDA events, mean of 3)", flush=True)
    cuda = torch.autograd.DeviceType.CUDA
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == cuda and e.self_device_time_total > 0:
            kernels[e.key] = kernels.get(e.key, 0.0) + e.self_device_time_total / 1e3
    busy = sum(kernels.values())
    if not busy:
        print(f"[profile {label}] the profiler recorded no device time", flush=True)
        return out
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == cuda)
    if spans:
        covered, reach = 0, spans[0][0]
        for start, end in spans:  # union of the device intervals
            covered += max(0, end - max(start, reach))
            reach = max(reach, end)
        span = reach - spans[0][0]
        print(f"[profile {label}] traced forward: device busy {covered / 1e3:.2f} ms of a "
              f"{span / 1e3:.2f} ms device span, idle share {1 - covered / span:.4f} "
              f"(profiler on)", flush=True)
    else:
        print(f"[profile {label}] idle share not measured: the trace holds no device "
              f"intervals", flush=True)
    cats = {}
    for name, ms in kernels.items():
        cat = category(name)
        cats[cat] = cats.get(cat, 0.0) + ms
    for cat, ms in sorted(cats.items(), key=lambda kv: -kv[1]):
        print(f"[profile {label}]   {cat:26s} {ms:9.2f} ms  {100 * ms / busy:5.1f} %",
              flush=True)
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:12]:
        print(f"[profile {label}]   top {ms:9.2f} ms  {name[:110]}", flush=True)
    return out


def kernel_summary(shapes, rows):
    """Fails unless every shape each kernel received in the runs `shapes`
    ({run: {kernel: {shape: launches}}}) has a row in `rows`; gives each row
    its launches over the runs, and in each; prints each kernel's rows
    weighted by their launches (`[kernel summary, launch-weighted]`)."""
    for run, by_kernel in shapes.items():
        for name, by_shape in by_kernel.items():
            checked = {r["shape"] for r in rows if r["name"].split()[0] == name}
            unchecked = set(by_shape) - checked
            if unchecked:
                fail(f"the path ({run}) gave {name} shapes not held to the plain version: "
                     f"{unchecked}")
    for r in rows:  # launches over the path's runs, and in each
        kernel, shape = r["name"].split()[0], r.pop("shape")
        for run in shapes:
            r[f"launches_{run}"] = shapes[run].get(kernel, {}).get(shape, 0)
        r["launches"] = sum(r[f"launches_{run}"] for run in shapes)
    # each kernel's rows (its fp32 and fp16 paths apart), weighted by their
    # launches over the runs: the totals PERF.md's kernel tables carry
    summary = {}
    for r in rows:
        key = r["replaces"].split("(")[-1].rstrip(")") + "".join(
            f" {t}" for t in ("fp32", "fp16") if f" {t} " in r["name"])
        total = summary.setdefault(key, dict.fromkeys(
            ("launches", "ms", "bound_ms", "plain_ms", "library_ms"), 0.0))
        total["launches"] += r["launches"]
        for field in ("ms", "bound_ms", "plain_ms", "library_ms"):
            if total[field] is None or r[field] is None:  # a kernel with no library call
                total[field] = None
            else:
                total[field] += r["launches"] * r[field]
    for total in summary.values():  # the share of its bound the kernel reached over the runs
        total["bound_share"] = total["bound_ms"] / total["ms"] if total["ms"] else 0.0
    rounded = {k: {f: v if v is None else round(v, 4) for f, v in t.items()}
               for k, t in summary.items()}
    print(f"[kernel summary, launch-weighted] {json.dumps(rounded)}", flush=True)


def main(argv):
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")

    new_video_length = int(argv[0]) if argv else 4
    num_partitions = 4
    rows_fifo = 2 * 2 * num_partitions  # windows x CFG rows
    t_start = time.perf_counter()

    def timed(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"[seconds] {label}: {time.perf_counter() - t0:.1f} s", flush=True)
        return out

    timed("phase 1, build", phase_build)
    count_moca_steps()
    # text context: 77 prompt tokens, 154 with the conditioned prompt (FIFO)
    rows = timed("phase 2, kernels against their plain versions", phase_kernels, rows_fifo, 2,
                 154, 77)
    timed("phase 2b, norms against their plain versions", phase_norms, rows)
    timed("phase 2c, GEGLU against its plain version", phase_geglu, rows)
    timed("phase 2d, MoCA scan against the per-window loop", phase_moca_scan, rows)
    unet_runs = timed("phase 3, U-Net against its plain path", phase_unet_reference)
    shapes, model, main_frames = timed("phase 4, main path", phase_main_path, new_video_length,
                                       num_partitions)
    shapes.update(unet_runs)
    shapes.update(timed("phase 5, profile", phase_profile, model, rows_fifo, 154,
                        4 * ACCEPT_PARTITIONS))
    shapes["davis"] = timed("phase 6, DAVIS", phase_davis, model, new_video_length,
                            num_partitions)
    shapes["open_vocab"] = timed("phase 7, open vocab", phase_open_vocab, model,
                                 new_video_length, num_partitions)
    shapes.update(timed("phase 8, batch T2V", phase_t2v_batch, model))
    shapes.update(timed("phase 9, T2V variants", phase_t2v_variants, model))
    shapes.update(timed("phase 10, MoCA B=2", phase_moca_batched, model, num_partitions,
                        new_video_length))
    shapes.update(timed("phase 11, i2v", phase_i2v))
    shapes.update(timed("phase 12, evaluation sweep", phase_eval_sweep, model))
    shapes.update(timed("phase 13, mesh", phase_mesh, main_frames, shapes["default"],
                        new_video_length, num_partitions))
    shapes.update(timed("phase 14, user scripts", phase_user_scripts))
    timed("phase 15, norms, GEGLU and MoCA scan at the runs' other shapes", phase_norm_shapes,
          shapes, rows)
    print(f"[moca scan tally] {json.dumps(MOCA_TALLY)}", flush=True)

    kernel_summary(shapes, rows)
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
