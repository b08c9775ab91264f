"""Exponential moving average of a set of parameters.

Port of moca_tpu/utils/ema.py: the reference's `LitEma` update
(lvdm/ema.py:5-76), decay = min(decay, (1 + n) / (10 + n)), kept as a dict
of name to tensor and a counter instead of module buffers, and updated
functionally. Inference does not use it (use_ema is off in the shipped
config); the checkpoint side is io/checkpoint.py's EMA layout.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass
class EMAState:
    params: Dict[str, torch.Tensor]
    num_updates: torch.Tensor  # 0-d int32

    @classmethod
    def create(cls, params: Dict[str, torch.Tensor]) -> "EMAState":
        return cls(params={k: torch.as_tensor(v).detach().clone() for k, v in params.items()},
                   num_updates=torch.tensor(0, dtype=torch.int32))


@torch.no_grad()
def ema_update(state: EMAState, new_params: Dict[str, torch.Tensor], decay: float = 0.9999,
               use_num_updates: bool = True) -> EMAState:
    """One EMA step (lvdm/ema.py:24-40): shadow <- shadow - (1 - d)(shadow - new)."""
    n = state.num_updates + 1
    if use_num_updates:
        d = torch.clamp((1.0 + n) / (10.0 + n), max=decay)
    else:
        d = torch.tensor(decay)
    one_minus = 1.0 - d
    shadow = {k: s - (one_minus * (s - new_params[k].to(s.dtype))).to(s.dtype)
              for k, s in state.params.items()}
    return EMAState(params=shadow, num_updates=n)
