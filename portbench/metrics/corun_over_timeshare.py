"""The executor's layer: a co-run macro-step's time (the window's time over
its macro-steps) over the sum of each tenant's quanta run alone on its
stream (host clock, synchronised, the least of two rounds).  Below 1 the
co-run beats time sharing."""


def read(ctx):
    alone = ctx.get("alone_s")
    if not alone or len(alone) < 2:
        return None
    return (ctx["window_s"] / ctx["n_macro"]) / sum(alone.values())
