"""Device milliseconds a unit (a frame of the stream) of everything outside
the network spans: the sampler's arithmetic (DDIM, MoCA's window step, the
FIFO write-back, the queue shift and its tail), the noise draws, the copies
between them."""

NETWORKS = ("unet", "vae.decode", "image_embed", "text_encode")


def read(view, metric):
    units, seconds = view.counts.get("units", 0), view.seconds(exclude=NETWORKS)
    return seconds / units * 1e3 if units and seconds else None
