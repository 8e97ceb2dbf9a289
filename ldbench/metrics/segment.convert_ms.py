"""segment.convert_ms: the median over the traced slice's segment swaps of
the time each spent converting the samples to float32 on the host, ms:
the program's `segment.convert` span inside a `segment.swap`
(`tbc/framer.py::to_device_capture`'s recentre and `astype`)."""

from ldbench import program_spans as P


def read(run):
    return P.per_swap_ms(run, 'segment.convert')
