"""The whole step's share of the card's bf16 peak: the model FLOPs of the
work finished in the traced window (the benchmark's own count at the cell's
shapes: convolutions, matrix products, attention), over the window's length
times 989 TFLOP/s."""

from benchmark import flops


def read(view, metric):
    total = sum(view.flops.values())
    return 100.0 * total / (view.window_s * flops.H100_BF16_FLOPS) if total else None
