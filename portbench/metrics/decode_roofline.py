"""The decode attention kernels' share of their roofline in the traced
co-run: each launch's least time at the valid lengths of its step
(``flops.decode_bound_s``; self-attention over each row's position + 1,
cross-attention over its frames), summed over the launches, over the
device time of the split and combine kernels by name (the union of their
intervals), in percent."""
from portbench.metrics import tenants, traced


def read(ctx):
    dec = tenants(ctx, "decode")
    if not dec or not traced(ctx):
        return None
    bound = n = 0
    for t in dec:
        for s in ctx["traced_steps"][t.name]:
            b = t.decode_bounds_at(s)
            bound += sum(b)
            n += len(b)
    if n == 0 or ctx["traced_launches"]["decode"] != n:
        return None
    dev = ctx["trace"].busy_s(lambda k, labels: "decode_split" in k["name"]
                              or "decode_combine" in k["name"])
    return 100.0 * bound / dev if dev > 0 else None
