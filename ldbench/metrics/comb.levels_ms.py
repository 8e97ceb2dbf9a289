"""comb.levels_ms: the median of the traced slice's `comb.levels` spans, ms
(`comb/batch.py::NTSCCombBatch._levels`: the window's burst column to the
host, which waits for every kernel queued before it, and the AGC's float32
loop over its lines)."""

from ldbench import program_spans as P


def read(run):
    return P.median_ms(run, 'comb.levels')
