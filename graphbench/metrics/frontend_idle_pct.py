"""frontend_idle_pct: the share of the profiled slice, in %, in which the
card ran nothing while the host was in ``frontend.serve`` outside every
``scheduler.*`` span: the idle time the front end's own work leaves.
Spans are placed on the profiler's clock through the program's
``clock.anchor`` events (``graphbench.spans.anchor_clock``); a program
without anchors leaves the metric out."""
from graphbench.spans import anchor_clock, idle_while, in_window, subtract


def read(ctx):
    sl = ctx["slice"]
    serves = in_window(ctx, "frontend.serve")
    clock = anchor_clock(ctx["spans"])
    if not sl or not sl["device"] or sl["side_stream"] is None or not serves or clock is None:
        return None

    def mapped(spans):
        return sorted([int(a), int(b)] for a, b in zip(clock([sp.t0 for sp in spans]),
                                                      clock([sp.t1 for sp in spans])))
    lo, hi = (int(x) for x in clock([sl["t0"], sl["t1"]]))
    host = subtract(mapped(serves), mapped(in_window(ctx, "scheduler.")))
    return 100.0 * idle_while(sl, host, lo, hi) / (hi - lo)
