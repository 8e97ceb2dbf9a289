"""segment.swap_ms: the median wall time of the traced slice's segment
swaps, ms: the program's `segment.swap` span (`tbc/framer.py::
Framer._ensure_segment` when it loads: the loader's read and unpack, the
float32 conversion and the copy into the resident buffer)."""

from ldbench import program_spans as P


def read(run):
    return P.median_ms(run, 'segment.swap')
