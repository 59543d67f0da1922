"""Device time of the kernels launched inside the package's ``moe`` region
during the prefill tenant's steps of the traced co-run (the union of their
intervals), per prefill step."""
from portbench.metrics import tenants, traced


def read(ctx):
    pre = tenants(ctx, "prefill")
    if not pre or not traced(ctx):
        return None
    t = pre[0]
    steps = len(ctx["traced_steps"][t.name])
    span = f"portbench:{t.name}"
    s = ctx["trace"].busy_s(lambda k, labels: "moe" in labels and span in labels)
    return 1e3 * s / steps if steps and s > 0 else None
