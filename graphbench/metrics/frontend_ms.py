"""frontend_ms: the front end's own host time per completed query, in ms:
each ``frontend.serve`` span's self time outside its ``scheduler.*``
descendants (``scheduler.admit``, ``scheduler.run``), summed over the
window, over the queries completed in it.  Plans and cost prediction in
admission, draining completions into the session (``session.absorb``),
the serving counters."""
from graphbench.spans import descendants, in_window, on_card, self_time


def read(ctx):
    served = ctx["served"]
    serves = in_window(ctx, "frontend.serve")
    if not on_card(ctx) or not serves or not served.completed:
        return None
    kids = descendants(ctx["spans"], serves, "scheduler.")
    own = sum(self_time(sp, kids[sp.span_id]) for sp in serves)
    return 1e3 * own / served.completed
