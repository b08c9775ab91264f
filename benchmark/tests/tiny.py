"""The cells at a size the CPU runs in seconds: every width cut (test shapes,
never a benchmark cell), each cell found by name through BENCHMARK.json and
its own traffic and limits files otherwise."""

from __future__ import annotations

from benchmark import common


def shrink(cell: common.Cell, precision: str = None) -> common.Cell:
    c, t = cell.config, cell.traffic
    full_context = c["unet"]["context_dim"]
    c["unet"].update(model_channels=32, num_head_channels=8, context_dim=16, channel_mult=[1, 2],
                     attention_resolutions=[1, 2], num_res_blocks=1, temporal_length=4)
    c["vae"].update(ch=16, ch_mult=[1, 1, 2, 2], num_res_blocks=1, resolution=32)
    c["clip"].update(width=16, heads=2, layers=2)
    if "vision" in c:
        c["vision"].update(image_size=28, patch_size=14, width=32, heads=2, layers=2,
                           output_dim=16)
        c["resampler"]["dim"] = 16
    # the context readers (the cross-attention's keys and values) keep their
    # full-size scale at the cut context width: std x sqrt(1024 / 16)
    w = c["weights"]
    w["std_by_key"] = {k: v * (full_context / c["unet"]["context_dim"]) ** 0.5
                       for k, v in w.get("std_by_key", {}).items()}
    if precision:
        c["precision"] = {tower: precision for tower in c["precision"]}
    t.update(height=32, width=64)
    if t["entry"] == "moca_davis":
        t.update(davis_frames=12, video_length=4, num_partitions=2, decode_batch=2,
                 new_video_length=200, mask={"height": 2, "width": 3})
        t["check"].update(unet_rows=2, vae_rows=2)
    else:
        t.update(frames=4, ddim_steps=6, warmup_steps=2, max_clips=200)
    return cell


def tiny_cell(name: str, seed: int = 5, precision: str = None, seconds: float = 0.5,
              trace: bool = False, root=common.ROOT) -> common.Cell:
    spec = common.load_json(root / "BENCHMARK.json")
    return shrink(common.find_cell(spec, name, seed, seconds, trace, "cpu", root=root),
                  precision)
