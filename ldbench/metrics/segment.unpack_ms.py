"""segment.unpack_ms: the median over the traced slice's segment swaps of
the time each spent in the .lds unpack, ms: the program's `load.unpack`
spans inside a `segment.swap` (`io/loaders.py::unpack_data_4_40`, either
route; the source's own time making the bytes sits in `load.read`)."""

from ldbench import program_spans as P


def read(run):
    return P.per_swap_ms(run, 'load.unpack')
