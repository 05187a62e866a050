"""device_idle_pct: the share of the profiled slice in which no kernel,
copy or memset of the program ran on the card, in %."""
from graphbench.tracing import busy_s


def read(ctx):
    sl = ctx["slice"]
    busy = busy_s(sl)
    if busy is None:
        return None
    return 100.0 * (1.0 - busy / (sl["t1"] - sl["t0"]))
