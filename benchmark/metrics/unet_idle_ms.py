"""Idle milliseconds of the device a U-Net call that the host spent inside
the U-Net: the idle gaps whose innermost open span is `unet` (the harness's,
around LatentDiffusion.apply_unet) or one of the program's `unet.*` spans
within it, over the `unet` calls in the window."""


def inside_unet(span: str) -> bool:
    return span == "unet" or span.startswith("unet.")


def read(view, metric):
    calls = view.span_counts.get("unet", 0)
    if not calls or view.busy_s <= 0:  # no U-Net call or no device operation traced
        return None
    return sum(s for s, span in view.gaps if inside_unet(span)) / calls * 1e3
