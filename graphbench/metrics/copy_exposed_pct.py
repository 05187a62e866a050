"""copy_exposed_pct: the share of the profiled slice, in %, in which a
pinned host-to-device copy (a partition load, ``graphbench.h2d``) runs on
the card and no kernel does: the load time the runner-up prefetch did
not hide behind the evaluator."""
from graphbench import h2d
from graphbench.spans import subtract
from graphbench.tracing import is_kernel, union_intervals


def read(ctx):
    sl = ctx["slice"]
    if not sl or not sl["device"] or sl["side_stream"] is None:
        return None
    lo, hi = sl["t0_ns"], sl["t1_ns"]
    kernels = union_intervals([ev for ev in sl["events"] if is_kernel(ev[0])], lo, hi)
    exposed = subtract(h2d.copy_intervals(sl), kernels)
    return 100.0 * sum(e - s for s, e in exposed) / (hi - lo)
