"""1 - the union of all kernel intervals, over all streams, over the
traced co-run's wall time (host clock, synchronised)."""
from portbench.metrics import traced


def read(ctx):
    if not traced(ctx):
        return None
    tr = ctx["trace"]
    return 1.0 - tr.busy_s() / tr.wall_s
