"""The window's model operations (``flops.py``: the products and the
attention the step shapes need) over the window's time times the card's
bf16 peak, in percent."""
from portbench import flops


def read(ctx):
    peak = flops.PEAK_FLOPS[ctx["config"]["dtype"]]
    return 100.0 * ctx["flops"] / (ctx["window_s"] * peak)
