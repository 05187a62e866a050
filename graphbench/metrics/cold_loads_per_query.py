"""cold_loads_per_query: the window's cold partition loads (``store.load``
spans with ``tier`` "cold": a copy from pinned host memory on the
critical path) over the queries completed in it.  Warm and prefetched
loads copy nothing on the critical path; ``loads_per_query`` counts all
three."""
from graphbench.spans import in_window, on_card


def read(ctx):
    served = ctx["served"]
    loads = [sp for sp in in_window(ctx, "store.load") if "tier" in sp.attrs]
    if not on_card(ctx) or not loads or not served.completed:
        return None
    return sum(sp.attrs["tier"] == "cold" for sp in loads) / served.completed
