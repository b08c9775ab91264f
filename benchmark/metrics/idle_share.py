"""The share of the traced window in which no operation ran on the device."""


def read(view, metric):
    if view.window_s <= 0 or view.busy_s <= 0:  # no device operation traced: nothing to read
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)
