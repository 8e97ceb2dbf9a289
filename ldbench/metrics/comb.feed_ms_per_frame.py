"""comb.feed_ms_per_frame: the host's time in the comb's feeds per frame fed
in the traced slice, ms: the total of the program's `comb.feed` spans
(`comb/batch.py::CombWindows._flush`: the window's stack, the AGC's round
trip and the graph's replay with the start of its copies) over the frames
they fed, a window of the traffic's `comb_batch` frames each."""

from ldbench import program_spans as P


def read(run):
    recs = P.records(run)
    if recs is None:
        return None
    feeds = [b - a for n, a, b, _, _ in recs if n == 'comb.feed']
    if not feeds:
        return None
    frames = len(feeds) * int(run.cell['traffic']['comb_batch'])
    return sum(feeds) / 1e6 / frames
