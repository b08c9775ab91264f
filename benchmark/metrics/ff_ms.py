"""Device milliseconds of the U-Net's feed-forwards a U-Net call: the device
time of every operation launched inside a `unet.ff` span (each transformer
block's feed-forward after its norm: the projection GEMM, GEGLU and the out
GEMM), over the `unet` calls in the window. Nothing to read where the program
opens no such span."""


def read(view, metric):
    calls, seconds = view.span_counts.get("unet", 0), view.seconds("unet.ff")
    return seconds / calls * 1e3 if calls and seconds else None
