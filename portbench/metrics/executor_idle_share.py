"""The device's idle time while the host was in the executor's own code
(an ``executor.*`` span innermost: the barrier and the macro-step's
bookkeeping, no step open), over the traced co-run's wall time
(``spans.py``)."""
from portbench import spans


def read(ctx):
    sp = spans.of(ctx)
    return None if sp is None else sp.idle_share("executor")
