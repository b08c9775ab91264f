"""What the harness finds by name, with no list kept in code: the
configuration files, traffic mixes, drivers (a traffic file's `entry`),
limits files and per-layer metric readers under `benchmark/`.

    python3 -m benchmark.catalog
"""

from __future__ import annotations

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def catalog(root: Path = HERE) -> dict:
    names = lambda sub, suffix: sorted(p.name[:-len(suffix)] for p in (root / sub).glob(f"*{suffix}")
                                       if not p.name.startswith("_"))
    return {"configs": names("configs", ".json"), "traffic": names("traffic", ".json"),
            "drivers": names("drivers", ".py"), "limits": names("limits", ".json"),
            "metrics": names("metrics", ".py")}


if __name__ == "__main__":
    print(json.dumps(catalog(), indent=1))
