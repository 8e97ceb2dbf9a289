"""prefetch.fetch_wait_share: the share of the window's wall time (less the
profiler's own stop) the prefetcher (`tbc/pipeline.py`) waited for a
batch's outputs to reach the host (its `stats['t_fetch']`)."""


def read(run):
    return (run.after['t_fetch'] - run.before['t_fetch']) / run.window_s
