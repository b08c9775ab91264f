"""Device milliseconds of the image towers a clip: the device time inside the
`image_embed` span (LatentVisualDiffusion.get_image_embeds: the ViT-H/14
tower and the Resampler), over the clips of the window."""


def read(view, metric):
    clips = view.counts.get("units", 0)
    seconds = view.seconds("image_embed")
    return seconds / clips * 1e3 if clips and seconds else None
