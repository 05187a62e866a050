"""fused_frontier_roofline: the frontier step kernel's share of its
bytes roofline over the profiled slice, in %: the least time its work
could take at the HBM bandwidth (``graphbench.roofline``, counted from
each launch's bindings and their vertices' degrees), over the kernel's
device time from the profiler.  It reads the kernel named
``STEP_KERNEL``; a program that no longer launches it leaves the metric
out."""
from graphbench import roofline
from graphbench.tracing import STEP_KERNEL


def read(ctx):
    sl = ctx["slice"]
    if not sl or not sl["device"]:
        return None
    times = [dur for name, _, dur, _ in sl["events"] if STEP_KERNEL in name]
    if not times or len(times) != sl["recorded_launches"]:
        return None
    ec = ctx["cfg"]["engine_config"]
    nbytes = roofline.step_bytes(sl["entries"], sl["bindings"], sl["lanes"],
                                 ec["q_pad"], ec["s_pad"])
    return 100.0 * roofline.bound_s(nbytes) / (sum(times) / 1e9)
