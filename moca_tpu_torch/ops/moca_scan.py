"""MoCA's window step over every FIFO window as one CUDA launch.

`moca_scan` launches the hand-written kernel (csrc/moca_scan.cu, the
"moca_scan" library of ops/cuda_libs.py) on float32 CUDA tensors: for each
of the R windows and B batch rows, `moca_window_step`'s diagonal DDIM step
with momentum (and, given masks, the injection into the queue) over the
window's f frames, read from the queue and written straight into a new queue
and, where asked, a queue-aligned pre-injection pred_x0. There is no CPU
path: sampling/fifo.py `fifo_step` runs the per-window loop
(sampling/moca.py `moca_window_step`, the plain counterpart) on CPU tensors,
and this wrapper refuses a queue, eps or noise that is not float32.

The kernel walks two tables that depend only on the schedule, the FIFO plan
and the MoCA settings, built once on the host and kept on the card: the
per-frame scalars [R, f, len(TABLE_COLUMNS)] float32 (sampling/moca.py
`moca_frame_table`) and the slots [R, f, len(SLOT_COLUMNS)] int32
(sampling/fifo.py `FIFOPlan.scan_slots`). Each call adds one to
`moca_scan.launches`, keyed (R, B, Q, f, h, w, C) with "fp32" appended.
"""

from __future__ import annotations

import functools

import torch

from moca_tpu_torch.ops.cuda_libs import load_library, raise_on, tally, tallied, vector

# the frame table's columns, in the kernel's order (csrc/moca_scan.cu `Col`):
# sqrt(1 - a_t), sqrt(a_t), sqrt(max(1 - a_prev - sigma^2, 0)), sqrt(a_prev),
# sigma, the momentum's strength, 1 where the momentum updates (frames j > 0),
# the injection's factor, 1 where injection applies (its t-gate)
TABLE_COLUMNS = ("sqrt_one_minus_alpha", "sqrt_alpha", "dir_coef", "sqrt_alpha_prev", "sigma",
                 "strength", "momentum", "factor", "inject")
# the slot table's columns (csrc/moca_scan.cu `Slot`): the queue slot frame j
# of window r reads, the slot its output lands in (-1: none), and 1 where that
# output is the slot's old value (the lookahead prefix)
SLOT_COLUMNS = ("src", "dst", "keep")
SCAN_THREADS = 128  # a block's threads: the stream's 20,480 vectors fill 160 blocks


@functools.lru_cache(maxsize=None)
def scan_plan(windows: int, rows: int, frame: int, vec: int):
    """(threads, blocks) of the kernel: one thread a vector of `vec` values
    of a frame slot of `frame` values, for each (window, batch row)."""
    if frame % vec:
        raise ValueError(f"moca_scan: a frame of {frame} values is not whole vectors of {vec}")
    vectors = windows * rows * (frame // vec)
    return SCAN_THREADS, -(-vectors // SCAN_THREADS)


@tallied
def moca_scan(queue, eps, noise, table, slots, masks=None, cond=None, *, beta: float,
              dir_weight: float, with_pred: bool = False):
    """MoCA's window step over every window: queue [B, Q, h, w, C], eps
    [R, B, f, h, w, C] (window r's frames, the U-Net's output), noise
    [R, f, h, w, C] (the step's unit draws, shared by the B rows), the frame
    table and the slots on the queue's device; masks [1 or B, Q, h, w, 1]
    (queue-aligned; only where injection reaches the queue) and cond
    [h, w, C] or [B, h, w, C] (None: zeros). All float32 but the slots.

    Returns (new queue [B, Q, h, w, C], the queue-aligned pred_x0 before
    injection, or None without `with_pred`)."""
    if queue.dtype != torch.float32 or queue.get_device() < 0:
        raise ValueError(f"moca_scan: the queue must be float32 on a CUDA device, got "
                         f"{queue.dtype} on {queue.device}")
    b, q = queue.shape[:2]
    frame_shape, c = tuple(queue.shape[2:]), queue.shape[-1]
    r, f = table.shape[:2]
    want = {"eps": (eps, (r, b, f) + frame_shape, torch.float32),
            "noise": (noise, (r, f) + frame_shape, torch.float32),
            "table": (table, (r, f, len(TABLE_COLUMNS)), torch.float32),
            "slots": (slots, (r, f, len(SLOT_COLUMNS)), torch.int32)}
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != queue.device:
            raise ValueError(f"moca_scan: {name} {tuple(t.shape)} {t.dtype} on {t.device}, "
                             f"want {shape} {dtype} on {queue.device}")
    frame = queue[0, 0].numel()
    mask_rows = cond_rows = 0
    if masks is not None:
        mask_rows = masks.shape[0]
        if (mask_rows not in (1, b) or masks.shape[1] != q or masks[0, 0].numel() * c != frame
                or masks.device != queue.device):
            raise ValueError(f"moca_scan: masks {tuple(masks.shape)} for a queue "
                             f"{tuple(queue.shape)}")
        masks = masks.to(torch.float32).contiguous()
    if cond is not None:
        cond_rows = cond.numel() // frame
        if cond.numel() % frame or cond_rows not in (1, b) or cond.device != queue.device:
            raise ValueError(f"moca_scan: cond {tuple(cond.shape)} for a queue "
                             f"{tuple(queue.shape)}")
        cond = cond.to(torch.float32).contiguous()
    queue, eps, noise = queue.contiguous(), eps.contiguous(), noise.contiguous()
    table, slots = table.contiguous(), slots.contiguous()
    out = torch.empty_like(queue)
    pred = torch.empty_like(queue) if with_pred else None
    vec = vector(4, frame, *(t.data_ptr() for t in (queue, eps, noise, out, pred, cond)
                             if t is not None))
    threads, blocks = scan_plan(r, b, frame, vec)
    gate = None if masks is None else torch.empty(q, dtype=torch.int32, device=queue.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = load_library("moca_scan")
    err = lib.moca_scan(queue.data_ptr(), eps.data_ptr(), noise.data_ptr(), ptr(masks),
                        ptr(cond), table.data_ptr(), slots.data_ptr(), ptr(gate),
                        out.data_ptr(), ptr(pred), r, b, f, q, frame, c, mask_rows, cond_rows,
                        beta, 1.0 - beta, dir_weight, vec, blocks, threads,
                        torch._C._cuda_getCurrentRawStream(queue.get_device()))
    raise_on(lib, err, "moca_scan")
    tally(moca_scan, (r, b, q, f) + frame_shape, queue.dtype)
    return out, pred
