"""Hand-written CUDA kernels of the port, with their plain PyTorch twins.

  fused_frontier  — the evaluator loop's frontier step: from the loop's
                    selection to the match, the done/keep/out routing and
                    the new rows, one launch per loop; csrc/fused_frontier.cu
  frontier_append — the evaluator's appends: ranks the step's done / outm /
                    keep flags and moves only the rows that land, one
                    launch per loop; csrc/frontier_append.cu
  frontier_expand — the match alone (ok, dg); csrc/frontier_expand.cu
  label_histogram — start-node count of one partition (SNI seed);
                    csrc/label_histogram.cu

The two frontier kernels share their match through csrc/frontier_match.cuh.

build.py compiles csrc/*.cu with nvcc at first use and counts launches;
ops.py holds the engine-facing adapters; ref.py the gather-based oracles.
Importing this package needs neither nvcc nor a card.
"""
from . import build, ops, ref

__all__ = ["build", "ops", "ref"]
