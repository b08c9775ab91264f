"""Prompt CSV loading (ref: scripts/evaluation/funcs.py:506-535).

Port of moca_tpu/io/prompts.py. Columns: prompt, conditioned_object,
conditioned_image_path, conditioned_prompt, gamma; one MoCA run per row.
"""

from __future__ import annotations

import csv
from typing import Dict, List, Optional


def load_prompts(prompt_file: str, prompt_index: Optional[int] = None) -> List[Dict]:
    """Every row, or only row `prompt_index` (ValueError past the end)."""
    with open(prompt_file, "r") as f:
        rows = []
        for i, row in enumerate(csv.DictReader(f)):
            item = {
                "prompt": row["prompt"].strip(),
                "conditioned_object": row["conditioned_object"].strip(),
                "conditioned_image_path": row["conditioned_image_path"].strip(),
                # the trailing period matters for grounded segmentation targets
                "conditioned_prompt": row["conditioned_prompt"].strip() + ".",
                "gamma": float(row["gamma"].strip()),
            }
            if prompt_index is None:
                rows.append(item)
            elif i == prompt_index:
                return [item]
    if prompt_index is not None:
        raise ValueError(f"Prompt index {prompt_index} exceeds number of prompts")
    return rows
