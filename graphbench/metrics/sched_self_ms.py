"""sched_self_ms: the scheduler's host work between its rounds, per
round, in ms: each ``scheduler.run`` span's self time outside its
``scheduler.round`` children (retirement, the waiter index, the ranking,
result collection), summed over the window, over those rounds."""
from graphbench.spans import in_window, on_card, self_time


def read(ctx):
    runs = in_window(ctx, "scheduler.run")
    rounds = {sp.span_id: [] for sp in runs}
    for sp in in_window(ctx, "scheduler.round"):
        if sp.parent_id in rounds:
            rounds[sp.parent_id].append(sp)
    n = sum(len(r) for r in rounds.values())
    if not on_card(ctx) or not n:
        return None
    return 1e3 * sum(self_time(sp, rounds[sp.span_id]) for sp in runs) / n
