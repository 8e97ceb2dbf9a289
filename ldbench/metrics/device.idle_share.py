"""device.idle_share: 1 - (the union of the device's operation intervals
over the wall time) in the traced slice of the window."""


def read(run):
    t = run.trace
    if t is None or t['window_s'] <= 0:
        return None
    return 1.0 - t['busy_s'] / t['window_s']
