"""comb.device_share: the device time of the operations the program
launched inside its `comb.*` spans (the AGC's copy, the window's CUDA
graph, the RGB48 copies to the host), within the traced slice, over the
slice's device busy time (the benchmark source's own left out)."""

from ldbench import comb_yardstick as CY
from ldbench import program_spans as P
from ldbench import yardstick as Y


def read(run):
    found = CY.comb_records(run)
    if found is None or run.trace['busy_s'] <= 0:
        return None
    recs, (lo, hi) = found
    spans = P.union((a, b) for _, a, b in recs)
    ops = CY.launched_in(run, spans)
    if ops is None:
        return None
    intervals = [(a, b) for each in ops for a, b, _ in each]
    if not intervals:
        return None
    return Y._busy_us(intervals, lo, hi) / 1e6 / run.trace['busy_s']
