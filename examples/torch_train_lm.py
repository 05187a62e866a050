"""LM demo on the PyTorch port: train a reduced qwen2-1.5b for 200 steps
on the synthetic Markov token pipeline, with checkpoints; kill it and
rerun it to watch it resume.  Loss drops from ~4.9 (uniform) toward the
source entropy.  The counterpart of ``examples/train_lm.py``: it runs
``repro_torch.launch.train`` with the demo's flags first, so that any flag
given overrides them.  Its checkpoints go under the temporary directory,
in ``repro_torch_train_lm`` (the JAX demo keeps its own).

    python examples/torch_train_lm.py                   # on the card
    python examples/torch_train_lm.py --device cpu      # on the host
"""
import os
import sys
import tempfile
from typing import List, Optional

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "src"))

from repro_torch.launch import train


def main(argv: Optional[List[str]] = None) -> int:
    demo = ["--arch", "qwen2-1.5b", "--smoke", "--steps", "200", "--batch", "16",
            "--seq", "128", "--lr", "1e-3",
            "--ckpt-dir", os.path.join(tempfile.gettempdir(), "repro_torch_train_lm"),
            "--ckpt-every", "50"]
    return train.main(demo + list(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    raise SystemExit(main())
