"""The flash forward kernel's share of its roofline in the traced co-run:
its launches (``flash_attention.launches``) times the least time of each
launch's shape (``flops.flash_bound_s``), over the kernel's device time by
name (the union of its intervals), in percent."""
from portbench import flops
from portbench.metrics import traced


def read(ctx):
    if not traced(ctx):
        return None
    dtype = ctx["config"]["dtype"]
    bound = n = 0
    for t in ctx["cell"].tenants:
        steps = len(ctx["traced_steps"][t.name])
        n += steps * len(t.flash)
        bound += steps * sum(flops.flash_bound_s(*shape, dtype) for shape in t.flash)
    if n == 0 or ctx["traced_launches"]["flash"] != n:
        return None
    tr = ctx["trace"]
    dev = tr.busy_s(lambda k, labels: "flash_fwd" in k["name"])
    return 100.0 * bound / dev if dev > 0 else None
