"""Put the checkout's root and ``src`` on the path, as ``run.py`` does,
and give the tests small configurations of the cells' own files."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

# sizes a CPU test holds: the cells' configurations with their scale cut
SMALL = {
    "subgen-400k-k4": {"n_nodes": 2000, "n_edges": 6000, "n_embed": 50},
    "imdb-74k-k4": {"n_movies": 300, "n_people": 400, "n_companies": 40},
}


@pytest.fixture
def small_config():
    from graphbench import bench

    def make(name: str) -> dict:
        cfg = bench.load_config(name)
        cfg.update(SMALL[name])
        return cfg
    return make
