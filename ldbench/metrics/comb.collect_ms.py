"""comb.collect_ms: the median of the traced slice's `comb.collect` spans,
ms (`comb/batch.py::_RgbCodecMixin._receive`: the wait for a window's RGB48
copies to the host and their conversion to uint16 frames)."""

from ldbench import program_spans as P


def read(run):
    return P.median_ms(run, 'comb.collect')
