"""A decode step's time on the device inside the co-run: for each
``step.decode`` instance of the traced co-run, the first kernel it
launched's start to the last one's end; the mean (``spans.py``)."""
from portbench import spans


def read(ctx):
    sp = spans.of(ctx)
    return None if sp is None else sp.latency_ms("step.decode")
