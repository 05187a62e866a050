"""h2d_roofline: the partition loads' share of the host link's peak, in
%: the least time their bytes take at the link's per-direction peak
(``graphbench.h2d``: the ``nbytes`` of the window's cold ``store.load``
and ``store.prefetch`` spans), over the union of the pinned
host-to-device copies in the profiled slice."""
from graphbench import h2d


def read(ctx):
    sl = ctx["slice"]
    if not sl or not sl["device"] or sl["side_stream"] is None:
        return None
    nbytes = h2d.copied_bytes(ctx)
    busy = sum(e - s for s, e in h2d.copy_intervals(sl)) / 1e9
    if not nbytes or not busy:
        return None
    return 100.0 * h2d.bound_s(nbytes) / busy
