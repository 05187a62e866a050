"""PyTorch + CUDA port of the partitioned graph query processor.

Mirrors the layout of the JAX package: host-only numpy modules
(graph, partitioning, planning, query state) are kept as copies here, and
the device path (evaluator, partition store, OPAT engine, session) runs on
PyTorch tensors.  The fused frontier step is a hand-written CUDA kernel
(kernels/csrc/fused_frontier.cu); on CPU tensors its plain PyTorch
version runs instead.  Entry points default to ``device="cuda"``.
"""
