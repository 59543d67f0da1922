"""One reader a metric: ``read(ctx) -> float | None``, found by the
metric's name in ``BENCHMARK.json``.  ``ctx`` is the run's record
(``harness.run``): the window's counts and times, the cell and its
tenants, and in a traced run the trace, the launches and the tenants'
quanta timed alone.  A reader that finds nothing to read returns None and
the metric is left out of the line."""


def tenants(ctx, kind: str) -> list:
    return [t for t in ctx["cell"].tenants if t.kind == kind]


def traced(ctx) -> bool:
    return "trace" in ctx and bool(ctx["trace"].kernels)


def alone_step_ms(ctx, kind: str):
    ts = tenants(ctx, kind)
    if not ts or "alone_s" not in ctx:
        return None
    t = ts[0]
    return 1e3 * ctx["alone_s"][t.name] / ctx["quanta"][t.name]
