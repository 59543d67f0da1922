"""Device time of the K/V caches' allocation and zero fill in the prefill
steps: the union of the kernel and memset intervals launched inside
``kv_cache.init`` instances within ``step.prefill`` instances of the
traced co-run, per prefill step (``spans.py``)."""
from portbench import spans
from portbench.trace import busy_us


def read(ctx):
    sp = spans.of(ctx)
    steps = [] if sp is None else sp.named("step.prefill")
    inits = [k for s in steps for k in sp.inside("kv_cache.init", s)]
    if not inits:
        return None
    return busy_us([iv for k in inits for iv in sp.launched(k)]) / 1e3 / len(steps)
