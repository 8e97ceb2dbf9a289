"""comb_roofline: the comb windows of the traced slice as a share of their
roofline, %: the least time of the frames they emitted at the card's
memory rate (each frame's 525 x 910 .tbc samples read once at 2 bytes and
its 480 x 744 RGB48 written once at 6 bytes, `comb_yardstick.py`), over
the traced device time of the kernels launched inside the windows'
`comb.replay` spans (the window's CUDA graph; the copies to the host are
the link's, not the memory's).  Every window whose span begins in the
slice counts whole, each emitting the traffic's `comb_batch` frames."""

from ldbench import comb_yardstick as CY


def read(run):
    found = CY.comb_records(run, ('comb.replay',))
    if found is None:
        return None
    recs, (lo, hi) = found
    windows = [(a, b) for _, a, b in recs if lo <= a < hi]
    ops = CY.launched_in(run, windows)
    if not ops:
        return None
    busy = sum(b - a for each in ops for a, b, name in each
               if CY.is_kernel(name))
    if busy <= 0:
        return None
    frames = len(windows) * int(run.cell['traffic']['comb_batch'])
    return 100.0 * CY.comb_least_ms(frames) * 1e3 / busy
