"""launches_per_loop: device kernels in the profiled slice per evaluator
loop, where loops are the frontier step's launches over the same slice
(``repro_torch.kernels.build.LAUNCHES["fused_frontier"]``, one a loop).
Copies and memsets are not kernels; the recorder's stream is left out."""
from graphbench.tracing import is_kernel


def read(ctx):
    sl = ctx["slice"]
    if not sl or not sl["device"] or sl["side_stream"] is None or not sl["step_launches"]:
        return None
    kernels = sum(1 for name, _, _, _ in sl["events"] if is_kernel(name))
    return kernels / sl["step_launches"]
