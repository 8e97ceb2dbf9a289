"""loader.share: the share of the window's wall time (less the profiler's
own stop) spent inside the port's .lds loader calls (read and 10-bit
unpack; the harness times the callable it hands the Framer), less the
benchmark source's own time making the bytes.  The segment swaps of `tbc/framer.py::_ensure_segment` call it."""


def read(run):
    b, a = run.before, run.after
    own = (a['loader_seconds'] - b['loader_seconds']) \
        - (a['source_seconds'] - b['source_seconds'])
    return own / run.window_s
