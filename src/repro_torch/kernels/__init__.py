"""Hand-written CUDA kernels of the port, with their plain PyTorch twins.

  fused_frontier — expansion + match + done/keep/out routing (engine inner
                   step); CUDA source in csrc/fused_frontier.cu

build.py compiles csrc/*.cu with nvcc at first use and counts launches;
ops.py holds the engine-facing adapters; ref.py the gather-based oracles.
Importing this package needs neither nvcc nor a card.
"""
from . import build, ops, ref

__all__ = ["build", "ops", "ref"]
