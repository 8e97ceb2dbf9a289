"""segment.idle_share: the device's idle time inside the program's
`segment.swap` and `prefetch.refill` spans (each swap, and the refill of
the in-flight batches that follows it), over the traced slice's wall time:
the spans' union less the device operations that ran inside it, the
benchmark source's own left out, read on the trace's clock."""

from ldbench import program_spans as P


def read(run):
    return P.idle_share(run, ('segment.swap', 'prefetch.refill'))
