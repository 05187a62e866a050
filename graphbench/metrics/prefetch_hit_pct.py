"""prefetch_hit_pct: loads served by a prefetch (``store.load`` spans with
``tier`` "prefetch") over the prefetches issued (``store.prefetch``
spans, one a staged copy) in the window, in %.  A prefetch that no load
uses is a whole partition copied for nothing."""
from graphbench.spans import in_window, on_card


def read(ctx):
    issued = in_window(ctx, "store.prefetch")
    if not on_card(ctx) or not issued:
        return None
    hits = sum(sp.attrs.get("tier") == "prefetch" for sp in in_window(ctx, "store.load"))
    return 100.0 * hits / len(issued)
