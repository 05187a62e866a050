"""Deterministic synthetic token pipeline for the LM substrate.

A tiny order-1 Markov source over the vocabulary (Zipf-ish marginals, sparse
transitions) so that a model can actually reduce loss — pure-random tokens
give a constant-entropy floor and make training demos meaningless.

The pipeline is stateless-per-step: batch ``i`` is a pure function of
(seed, i), so data-pipeline state is a single integer.  Checkpoints store
``step`` and restarts are bitwise reproducible.  At cluster scale each
host draws its own slice by folding ``process_index`` into the key —
same code path here with one host.

A copy of the JAX package's module (numpy only, the same draws).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class TokenPipeline:
    vocab: int
    batch: int
    seq: int
    seed: int = 0
    branching: int = 4          # out-degree of the Markov chain
    step: int = 0               # checkpointable cursor

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # sparse deterministic transition table [vocab, branching]
        self._next = rng.integers(0, self.vocab,
                                  size=(self.vocab, self.branching),
                                  dtype=np.int32)
        # Zipf-ish start distribution
        ranks = np.arange(1, self.vocab + 1, dtype=np.float64)
        p = 1.0 / ranks
        self._start_p = (p / p.sum()).astype(np.float64)

    def batch_at(self, step: int, process_index: int = 0) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + process_index) * 2_654_435_761 + step)
        starts = rng.choice(self.vocab, size=self.batch, p=self._start_p)
        seqs = np.empty((self.batch, self.seq + 1), dtype=np.int32)
        seqs[:, 0] = starts
        # vectorized Markov walk with occasional resets (doc boundaries)
        for t in range(self.seq):
            branch = rng.integers(0, self.branching, size=self.batch)
            nxt = self._next[seqs[:, t], branch]
            reset = rng.random(self.batch) < 0.01
            if reset.any():
                nxt = np.where(reset,
                               rng.choice(self.vocab, size=self.batch,
                                          p=self._start_p), nxt)
            seqs[:, t + 1] = nxt
        return {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()

    def next_batch(self) -> Dict[str, np.ndarray]:
        b = self.batch_at(self.step)
        self.step += 1
        return b

    # --- checkpoint integration -----------------------------------------
    def state_dict(self) -> Dict[str, int]:
        return {"pipeline_step": self.step, "pipeline_seed": self.seed}

    def load_state_dict(self, d: Dict[str, int]) -> None:
        assert int(d.get("pipeline_seed", self.seed)) == self.seed, \
            "pipeline seed changed across restart"
        self.step = int(d["pipeline_step"])


def frontend_batch(cfg, batch: int, seq: int, seed: int = 0
                   ) -> Dict[str, np.ndarray]:
    """Synthetic frontend-stub tensors for audio/vlm families."""
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}
    from ..models.config import FAMILY_AUDIO, FAMILY_VLM
    if cfg.family == FAMILY_AUDIO:
        out["frame_embeds"] = rng.normal(
            size=(batch, seq, cfg.frontend_dim())).astype(np.float32)
    elif cfg.family == FAMILY_VLM and cfg.frontend_tokens:
        F = min(cfg.frontend_tokens, seq // 2)
        out["image_embeds"] = rng.normal(
            size=(batch, F, cfg.frontend_dim())).astype(np.float32)
    return out
