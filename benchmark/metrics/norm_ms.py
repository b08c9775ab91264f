"""Device milliseconds of the U-Net's norms a U-Net call: the device time of
every operation launched inside a `unet.norm` span (the program's fp32
GroupNorm32 and LayerNorm32 of the U-Net: the fp32 copy, the statistics,
the affine map, SiLU and the cast back), over the `unet` calls in the
window. Nothing to read where the program opens no such span."""


def read(view, metric):
    calls, seconds = view.span_counts.get("unet", 0), view.seconds("unet.norm")
    return seconds / calls * 1e3 if calls and seconds else None
