"""Device milliseconds of the VAE decoder a decoded frame: the device time
inside the `vae.decode` span (LatentDiffusion.decode_single), over the
frames decoded in the window."""


def read(view, metric):
    frames = view.counts.get("decoded_frames", 0)
    seconds = view.seconds("vae.decode")
    return seconds / frames * 1e3 if frames and seconds else None
