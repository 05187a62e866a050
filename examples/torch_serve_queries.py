"""End-to-end serving demo on the PyTorch port (the paper's kind: query
serving): batched queries on a partitioned graph with the paper's
metrics, served through one GraphSession.  The counterpart of
``examples/serve_queries.py``: it runs ``repro_torch.launch.serve`` with
the demo's flags first, so that any flag given overrides them, and ``-p``
standing for ``--processors``.

    python examples/torch_serve_queries.py                     # on the card
    python examples/torch_serve_queries.py --device cpu        # on the host
    python examples/torch_serve_queries.py --engine traditional -p 4
    python examples/torch_serve_queries.py --cache-parts 2 \\
        --max-answers 5 --json report.json
    python examples/torch_serve_queries.py --engine mapreduce
"""
import os
import sys
from typing import List, Optional

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "src"))

from repro_torch.launch import serve

DEMO = ["--dataset", "synthetic", "--scale", "1.0", "--k", "4", "--scheme", "ecosocial",
        "--engine", "opat", "--heuristic", "max-sn", "--verify"]


def main(argv: Optional[List[str]] = None) -> int:
    return serve.main(DEMO + ["--processors" if a == "-p" else a
                              for a in (sys.argv[1:] if argv is None else argv)])


if __name__ == "__main__":
    raise SystemExit(main())
