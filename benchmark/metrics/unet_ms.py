"""Device milliseconds of one U-Net call: the device time of every operation
launched inside the `unet` span (LatentDiffusion.apply_unet), over the
calls in the window."""


def read(view, metric):
    calls, seconds = view.span_counts.get("unet", 0), view.seconds("unet")
    return seconds / calls * 1e3 if calls and seconds else None
