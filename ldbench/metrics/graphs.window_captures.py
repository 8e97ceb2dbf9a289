"""graphs.window_captures: eager warm-ups plus CUDA graph captures that the
Framer's graph caches (`utils/graphs.py::GraphCache`, the batch call's and
the weave's) made inside the window; set-up should have made them all."""


def read(run):
    return run.after['graph_builds'] - run.before['graph_builds']
