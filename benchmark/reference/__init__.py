"""The plain reference: float32 PyTorch, independent of the measured program.

`build(config, weights)` gives the networks of a configuration file with
the benchmark's weights; `layout(config)` the names and shapes of those
weights (the state dict both sides load) and which are normalization scales; `control(model, config)` computes
each tower in the type below the one it is served in.
"""

from __future__ import annotations

import torch

from benchmark.reference import nets
from benchmark.reference.nets import LatentDiffusion, Rounding, set_rounding

# the type below each served type: the control's rounding
BELOW = {"bfloat16": "float8", "float32": "bfloat16"}


def layout(config: dict):
    """({name: shape} of the state dict both sides load, the names of the
    normalization layers' scales)."""
    with torch.device("meta"):
        model = LatentDiffusion(config)
    shapes = {name: tuple(t.shape) for name, t in model.state_dict().items()}
    norms = frozenset(f"{name}.weight" for name, m in model.named_modules()
                      if isinstance(m, (nets.GroupNorm, nets.LayerNorm)))
    return shapes, norms


def build(config: dict, weights: dict) -> LatentDiffusion:
    """The reference on the weights' device, in float32."""
    with torch.device("meta"):
        model = LatentDiffusion(config)
    model.load_state_dict({k: v.float() for k, v in weights.items()}, strict=True, assign=True)
    return model.eval().requires_grad_(False)


def meta_model(config: dict) -> LatentDiffusion:
    with torch.device("meta"):
        return LatentDiffusion(config).eval().requires_grad_(False)


def control(model: LatentDiffusion, config: dict) -> LatentDiffusion:
    """Each tower computed in the type below the one it is served in: the
    operands of every product and the output of every module (the values
    the program holds in its served type between operations) rounded to it;
    statistics, softmax and accumulation stay float32, as in the program."""
    for tower, dtype in config["precision"].items():
        rounding = Rounding(BELOW[dtype])
        module = getattr(model, tower)
        set_rounding(module, rounding)
        for m in module.modules():
            m.register_forward_hook(
                lambda mod, args, out, r=rounding: r(out) if isinstance(out, torch.Tensor) else out)
    return model
