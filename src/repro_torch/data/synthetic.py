"""Synthetic data pipelines, host-side numpy (the port's own copy of the
reference's ``repro/data/synthetic.py``; for a seed each batch is array
for array the reference's).

  lm_batches        deterministic PRNG token streams with next-token
                    labels, for throughput work.
  needle_batches    a long-range retrieval task (the paper's LRA-Text
                    stand-in): a MARKER token planted at a random position
                    is followed by a class token, which the model must
                    emit at the final position.  Static local attention
                    fails at it; content-based sparse attention succeeds.

The training step moves each batch to its parameters' device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

MARKER_OFFSET = 2      # token id reserved: vocab-2
PAD_ID = 0


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_classes: int = 8
    n_distractors: int = 4


def lm_batches(cfg: DataConfig) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(cfg.seed)
    while True:
        toks = rng.integers(1, cfg.vocab - 4,
                            size=(cfg.global_batch, cfg.seq_len),
                            dtype=np.int32)
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = PAD_ID
        mask = np.ones_like(toks, np.float32)
        mask[:, -1] = 0.0
        yield {"tokens": toks, "labels": labels, "loss_mask": mask}


def needle_batches(cfg: DataConfig) -> Iterator[Dict[str, np.ndarray]]:
    """Classification as LM: the answer is due at the last position."""
    rng = np.random.default_rng(cfg.seed)
    marker = cfg.vocab - MARKER_OFFSET
    cls_base = cfg.vocab - MARKER_OFFSET - cfg.n_classes
    while True:
        b, s = cfg.global_batch, cfg.seq_len
        toks = rng.integers(1, cls_base - 1, size=(b, s), dtype=np.int32)
        cls = rng.integers(0, cfg.n_classes, size=(b,), dtype=np.int32)
        pos = rng.integers(1, s - 2, size=(b,))
        for i in range(b):
            toks[i, pos[i]] = marker
            toks[i, pos[i] + 1] = cls_base + cls[i]
            # distractor class tokens NOT preceded by a marker
            dpos = rng.integers(1, s - 2, size=(cfg.n_distractors,))
            for dp in dpos:
                if abs(int(dp) - int(pos[i])) > 1:
                    toks[i, dp] = cls_base + rng.integers(0, cfg.n_classes)
        toks[:, -1] = marker          # query marker at the end
        labels = np.zeros_like(toks)
        labels[:, -1] = cls_base + cls
        mask = np.zeros((b, s), np.float32)
        mask[:, -1] = 1.0
        yield {"tokens": toks, "labels": labels, "loss_mask": mask}


def make_batches(kind: str, cfg: DataConfig):
    return {"lm": lm_batches, "needle": needle_batches}[kind](cfg)
