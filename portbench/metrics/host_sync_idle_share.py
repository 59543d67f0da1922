"""The device's idle time while the host waited in the MoE decode's read
of its expert counts (``moe.host_sync`` spans), over the traced co-run's
wall time (``spans.py``)."""
from portbench import spans


def read(ctx):
    sp = spans.of(ctx)
    return None if sp is None or not sp.named(spans.HOST_SYNC) else sp.idle_share("host_sync")
