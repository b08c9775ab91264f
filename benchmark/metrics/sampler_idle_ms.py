"""Idle milliseconds of the device a unit (a frame of the stream, a clip)
that the host spent in the sampler outside the networks: the idle gaps whose
innermost open span is one of the program's `sampler.*` spans (the window
gather, the guidance rows and combine, MoCA's window steps, the queue shift,
a DDIM step), over the units of the window. Nothing to read where the
program opens no such span."""


def read(view, metric):
    units = view.counts.get("units", 0)
    sampled = any(span.startswith("sampler.") for span in view.span_counts)
    if not units or not sampled or view.busy_s <= 0:
        return None
    return sum(s for s, span in view.gaps if span.startswith("sampler.")) / units * 1e3
