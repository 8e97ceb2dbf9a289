"""segment.readahead_share: the share of the traced slice's segment swaps
that took the samples the read ahead had staged: `segment.swap` records
that hold a `segment.take` record (`tbc/framer.py::Framer._ensure_segment`),
over all the slice's `segment.swap` records.  1.0 where every swap was a
hit; a swap after a seek or resync jump loads on the decode's thread.
None without a swap in the slice, or for a program that reads no segment
ahead (no `segment.readahead`, `segment.wait` or `segment.take` record)."""

from ldbench import program_spans as P

AHEAD = ('segment.readahead', 'segment.wait', 'segment.take')


def read(run):
    recs = P.records(run)
    if recs is None or not any(r[0] in AHEAD for r in recs):
        return None
    swaps = {k for k, r in enumerate(recs) if r[0] == 'segment.swap'}
    if not swaps:
        return None
    took = set()
    for name, _, _, p, _ in recs:
        if name != 'segment.take':
            continue
        while p >= 0 and recs[p][0] != 'segment.swap':
            p = recs[p][3]
        if p >= 0:
            took.add(p)
    return len(took) / len(swaps)
