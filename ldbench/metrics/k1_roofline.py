"""k1_roofline: kernel K1 (`csrc/resample_lines.cu`, the line resample) in
the traced slice, as a share of its roofline, %: the sum of the least times
of its launches at the card's memory rate (their bytes from the shapes the
batch call launches it with: NTSC two 48-column burst windows and the
picture, PAL the picture, each a batch) over the sum of its traced kernel
times.  Launches are attributed to shapes by their count: a slice that
cuts a batch misattributes at most two of them."""

from ldbench import yardstick as Y

KERNEL = 'resample_lines_kernel'


def calls(system: str, batch: int):
    """(batch, nlines, ncols, outwidth, steplen, table width) of each K1
    launch of one batch call."""
    if system == 'NTSC':
        W, lc, tab, steplen = 910, 263, 267, 40 * 63.5555555555
        return [(batch, lc, 48, W, steplen, tab)] * 2 \
            + [(batch, lc, W, W, steplen, tab - 1)]
    W, lc, tab, steplen = 1135, 313, 317, 40 * 64.0
    return [(batch, lc, W, W, steplen, tab - 3)]


def read(run):
    t = run.trace
    if t is None:
        return None
    times = [b - a for a, b, name in t['ops'] if KERNEL in name]
    if not times:
        return None
    per_batch = calls(run.cell['config']['system'], run.after['batch'])
    least_ms = sum(Y.k1_least_ms(*c) for c in per_batch)
    batches = len(times) / len(per_batch)
    return 100.0 * batches * least_ms * 1e3 / sum(times)
