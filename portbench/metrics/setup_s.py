"""Seconds from the process's start to the first timed macro-step: imports,
weights, inputs, caches, the kernels' build where it is not cached, and
one warm-up macro-step."""


def read(ctx):
    return ctx["setup_s"]
