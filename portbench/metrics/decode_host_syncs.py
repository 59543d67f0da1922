"""The MoE decode's host syncs a decode step: the ``moe.host_sync`` span
instances inside ``step.decode`` instances, over the ``step.decode``
instances of the traced co-run (``spans.py``)."""
from portbench import spans


def read(ctx):
    sp = spans.of(ctx)
    steps = [] if sp is None else sp.named("step.decode")
    if not steps:
        return None
    return sum(len(sp.inside(spans.HOST_SYNC, s)) for s in steps) / len(steps)
