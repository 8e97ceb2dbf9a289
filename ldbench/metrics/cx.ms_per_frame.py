"""cx.ms_per_frame: the median of the traced slice's `cx.process` spans, ms
(`audio/cx.py::CXExpander.process` on one frame's audio: the two
high-passes and the envelope followers' host loop)."""

from ldbench import program_spans as P


def read(run):
    return P.median_ms(run, 'cx.process')
