"""segment.convert_ms: the median over the traced slice's segment swaps of
the host's time in the conversion of the samples to float32, ms: the
program's `segment.convert` span inside a `segment.swap`
(`tbc/framer.py::to_device_capture`).  On the card that span holds the
host's launches of the widening kernel K4 (`tbc/cuda_widen.py::widen`) and
returns before K4 runs, so this reads the launches' host time, whatever K4
takes on the device (its `widen_kernel` operations in the trace)."""

from ldbench import program_spans as P


def read(run):
    return P.per_swap_ms(run, 'segment.convert')
