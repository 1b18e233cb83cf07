"""Layer "device": the share of the window in which no operation ran on the
card, 100 x (1 - busy / window). Busy is the union of the device
operations' intervals in the traced window; the window is the untraced
one over the same clips, since the profiler stretches the host's time and
not the device's (the traced window's own length is ``device.window_s``).
Device trace. Moves ``passes_per_s``."""

UNIT = "%"


def read(w):
    if w.trace is None or not w.trace.ops or w.window_s <= 0:
        return None
    return 100.0 * (1.0 - w.trace.busy_s / w.window_s)
