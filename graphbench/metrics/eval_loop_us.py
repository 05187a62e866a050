"""eval_loop_us: host wall time per evaluator loop, in us: the
``kernel.eval`` spans' summed duration over their summed ``loops`` (each
call's step launches, ``batched_iters``), device waits included.  Tells a
slower loop from more loops."""
from graphbench.spans import in_window, on_card


def read(ctx):
    evals = [sp for sp in in_window(ctx, "kernel.eval") if "loops" in sp.attrs]
    loops = sum(sp.attrs["loops"] for sp in evals)
    if not on_card(ctx) or not loops:
        return None
    return 1e6 * sum(sp.t1 - sp.t0 for sp in evals) / loops
