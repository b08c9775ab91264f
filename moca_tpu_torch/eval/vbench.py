"""VBench sweep glue (ref: VBench_Evaluation/*/results_*_full_info.json).

A copy of moca_tpu/eval/vbench.py. The reference commits raw VBench
"full_info" configs — a list of {prompt_en, dimension[], video_list[]} —
produced per generated video and fed to the external VBench evaluator. This
module writes the same format for videos generated by moca_tpu_torch and
aggregates per-dimension summaries once VBench results exist.
"""

from __future__ import annotations

import datetime
import json
import os
from typing import Dict, List, Sequence

DEFAULT_DIMENSIONS = [
    "Diversity", "Human_Anatomy", "Human_Identity", "Human_Clothes",
    "Multi-View_Consistency",
]


def write_full_info(
    out_dir: str,
    entries: Sequence[Dict],
    dimensions: Sequence[str] = tuple(DEFAULT_DIMENSIONS),
    timestamp: str | None = None,
) -> str:
    """entries: [{"prompt": str, "video_path": str}] → full_info JSON path."""
    os.makedirs(out_dir, exist_ok=True)
    ts = timestamp or datetime.datetime.now().strftime("%Y-%m-%d-%H:%M:%S")
    path = os.path.join(out_dir, f"results_{ts}_full_info.json")
    payload = [
        {
            "prompt_en": e["prompt"],
            "dimension": list(dimensions),
            "video_list": [e["video_path"]],
        }
        for e in entries
    ]
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    return path


def summarize(results_dir: str) -> Dict[str, Dict]:
    """Aggregate VBench per-dimension scores across results_*.json files
    (the evaluator writes {dimension: [score, detail]} eval files next to
    the full_info configs). Produces the evaluation_summary.json layout."""
    summary: Dict[str, Dict] = {}
    for name in sorted(os.listdir(results_dir)):
        if not name.endswith("_eval_results.json"):
            continue
        with open(os.path.join(results_dir, name)) as f:
            data = json.load(f)
        for dim, val in data.items():
            score = val[0] if isinstance(val, (list, tuple)) else val
            entry = summary.setdefault(dim, {"scores": []})
            entry["scores"].append(score)
    for dim, entry in summary.items():
        s = entry.pop("scores")
        entry["mean"] = sum(s) / len(s)
        entry["n"] = len(s)
    return summary
