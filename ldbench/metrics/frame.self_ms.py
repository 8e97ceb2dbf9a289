"""frame.self_ms: the median self time of a frame in the traced slice, ms:
the program's `frame` span (`tbc/framer.py::Framer.readframe`) less the
spans directly inside it (the swap, the prefetcher's fetches, dispatches
and refills, the weave): the Framer's own Python."""

from ldbench import program_spans as P


def read(run):
    return P.self_ms(run, 'frame')
