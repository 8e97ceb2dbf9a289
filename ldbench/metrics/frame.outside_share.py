"""frame.outside_share: the share of the traced slice's wall time outside
every `frame` span of the program (`tbc/framer.py::Framer.readframe`): the
caller's time between frames."""

from ldbench import program_spans as P


def read(run):
    return P.outside_share(run, 'frame')
