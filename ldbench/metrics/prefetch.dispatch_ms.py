"""prefetch.dispatch_ms: the median host time of one batch's dispatch in
the traced slice, ms: the program's `prefetch.dispatch` span
(`tbc/pipeline.py::FieldPrefetcher._dispatch`: the batch call's replay and
its input copies)."""

from ldbench import program_spans as P


def read(run):
    return P.median_ms(run, 'prefetch.dispatch')
