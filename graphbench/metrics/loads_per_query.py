"""loads_per_query: partition loads (the store's cold and warm loads,
``LoadStats`` hits + misses, over the window) per completed query.  The
paper's own cost measure; the scheduler (``core/scheduler.py``,
``core/heuristics.py``) decides it."""


def read(ctx):
    served = ctx["served"]
    return served.loads / served.completed if served.completed else None
