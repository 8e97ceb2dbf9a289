"""segment.wait_ms: the median over the traced slice's segment swaps of the
time the decode's thread waited in each for the read of the next segment
ahead, ms: the program's `segment.wait` spans inside a `segment.swap`
(`tbc/framer.py::Framer._ensure_segment`; the read runs on a worker thread
under `segment.readahead`).  Near 0 where the read was done before the
swap came; None for a program that reads no segment ahead."""

from ldbench import program_spans as P


def read(run):
    return P.per_swap_ms(run, 'segment.wait')
