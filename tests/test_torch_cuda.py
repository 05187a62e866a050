"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Imports no JAX, so it runs on a machine with only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Without a CUDA device the test skips (decided inside the test).
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke
from repro_torch.kernels import fused_frontier as ff

CASES = [((4, 4, 4, 8), False), ((16, 7, 6, 32), False),
         ((32, 128, 8, 64), False), ((8, 130, 5, 16), False),
         ((1, 1, 1, 1), False), ((8, 16, 4, 8), True),
         ((512, 20, 8, 4096), False)]


@pytest.mark.cuda
def test_cuda_fused_frontier_matches_plain():
    """Bit-equal masks, dg where an edge exists, dest where routed out,
    done/keep/out disjoint and covering ok — over the test sweep, an
    empty frontier and the main path's EB/W/Q."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(0)
    for (EB, W, Q, Np), empty in CASES:
        args = chip_smoke.fused_case(rng, EB, W, Q, Np, V=1000 + 2 * Np,
                                     empty=empty)
        got = ff.fused_frontier_cuda(*args)
        torch.cuda.synchronize()
        rec = chip_smoke.compare_fused(got, ff.fused_frontier_plain(*args), args)
        assert rec["mask_mismatches"] == 0 and rec["max_abs_err"] == 0, rec
        assert rec["disjoint"] and rec["covers_ok"], rec
