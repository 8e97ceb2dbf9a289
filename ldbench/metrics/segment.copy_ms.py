"""segment.copy_ms: the median over the traced slice's segment swaps of
the host's time in the copy to the card, ms: the program's `segment.copy`
span inside a `segment.swap` (`tbc/framer.py::to_device_capture`).  On the
card that span is the copy of the loader's uint16 samples as they are, from
pageable memory, into the resident buffer (`tbc/cuda_widen.py::stage`),
until the host returns; their widening to float32 and the tail's zeroing
are `segment.convert`'s."""

from ldbench import program_spans as P


def read(run):
    return P.per_swap_ms(run, 'segment.copy')
