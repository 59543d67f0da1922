"""The device's idle time while the host was inside a serve step (a
``step.*`` span or one inside it innermost), its host syncs left out,
over the traced co-run's wall time (``spans.py``)."""
from portbench import spans


def read(ctx):
    sp = spans.of(ctx)
    return None if sp is None else sp.idle_share("dispatch")
