"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``graphbench/run.py`` runs one cell of ``BENCHMARK.json`` once; see
``graphbench/README.md``.  Nothing here imports JAX or the JAX package.
"""
