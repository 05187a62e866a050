"""lanes_per_launch: how many query lanes share each step launch: the
``kernel.eval`` spans' ``lanes`` weighted by their ``loops``, over the
summed ``loops``."""
from graphbench.spans import in_window, on_card


def read(ctx):
    evals = [sp for sp in in_window(ctx, "kernel.eval")
             if "loops" in sp.attrs and "lanes" in sp.attrs]
    loops = sum(sp.attrs["loops"] for sp in evals)
    if not on_card(ctx) or not loops:
        return None
    return sum(sp.attrs["lanes"] * sp.attrs["loops"] for sp in evals) / loops
