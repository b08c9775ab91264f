"""Device milliseconds of the U-Net's cross-attention a U-Net call: the
device time of every operation launched inside a `unet.xattn` span (the
spatial transformers' attn2, text and image cross-attention: the
projections, the attention of the plain path and the output projection),
over the `unet` calls in the window. Nothing to read where the program opens
no such span."""


def read(view, metric):
    calls, seconds = view.span_counts.get("unet", 0), view.seconds("unet.xattn")
    return seconds / calls * 1e3 if calls and seconds else None
