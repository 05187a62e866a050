"""Entry points: ``python -m repro_torch.launch.serve`` (serve.py), the
in-RAM query-serving CLI."""
