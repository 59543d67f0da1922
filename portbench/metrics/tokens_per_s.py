"""Every position every tenant processed in the window (encoder frames,
prompt tokens, one decoded token a sequence a step, trained positions)
over the window's time (host clock, all completed macro-steps)."""


def read(ctx):
    return ctx["positions"] / ctx["window_s"]
