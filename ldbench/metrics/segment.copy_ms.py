"""segment.copy_ms: the median over the traced slice's segment swaps of
the host's time in the copy to the card, ms: the program's `segment.copy`
span inside a `segment.swap` (`tbc/framer.py::to_device_capture`'s copy
into the resident buffer and the tail's zeroing, until the host
returns)."""

from ldbench import program_spans as P


def read(run):
    return P.per_swap_ms(run, 'segment.copy')
