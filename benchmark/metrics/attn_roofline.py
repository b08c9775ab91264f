"""The attention kernels' (K1-K4) share of their roofline: the sum of every
launch's least time (benchmark/flops.py, at the shapes of the program's
launch tallies) over the device time of the same kernels in the window."""

from benchmark import flops, trace


def read(view, metric):
    seconds = sum(op.seconds for op in view.ops
                  if trace.category(op.name).startswith(trace.ATTENTION_KERNELS))
    if not seconds:
        return None
    return 100.0 * flops.launches_bound_ms(view.launches) / (seconds * 1e3)
