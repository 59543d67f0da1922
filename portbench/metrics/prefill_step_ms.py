"""One prefill step of the cell's prefill tenant alone (its quanta on its
stream, host clock, synchronised, over the quanta)."""
from portbench.metrics import alone_step_ms


def read(ctx):
    return alone_step_ms(ctx, "prefill")
