"""One decode step of the cell's decode tenant alone (its quanta on its
stream, host clock, synchronised, over the quanta); host-paced."""
from portbench.metrics import alone_step_ms


def read(ctx):
    return alone_step_ms(ctx, "decode")
