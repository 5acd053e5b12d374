"""Token data pipeline: a deterministic synthetic corpus, sharded batches.

Counterpart of `repro.data.pipeline.SyntheticLMData`, a numpy copy of it:
the corpus is a Zipf-ish Markov stream (stable unigram/bigram statistics, so
a training loss falls, unlike on uniform noise), and the batch of any
(step, shard) is regenerated from the seed alone, so a restart needs no
data state beyond the step. The same arguments give the JAX package's
tokens, array for array. Batches are numpy int32 arrays; the caller moves
them to its device. `make_batch_specs` gives every model input of a shape
cell as meta tensors (the JAX package's `jax.ShapeDtypeStruct` stand-ins:
shapes and dtypes, no memory).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class SyntheticLMData:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = self.vocab_size
        # sparse bigram transition: each token has few likely successors
        self._succ = rng.integers(0, v, size=(v, 4))
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = ranks ** (-self.zipf_a)
        self._unigram = p / p.sum()

    def batch(self, step: int, shard: int = 0, n_shards: int = 1) -> dict:
        """Deterministic batch for (step, shard): tokens (B / n_shards, S)
        int32."""
        b = self.global_batch // n_shards
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + shard)
        s = self.seq_len
        toks = np.empty((b, s), np.int32)
        toks[:, 0] = rng.choice(self.vocab_size, size=b, p=self._unigram)
        follow = rng.random((b, s)) < 0.8
        pick = rng.integers(0, 4, size=(b, s))
        fresh = rng.choice(self.vocab_size, size=(b, s), p=self._unigram)
        for t in range(1, s):
            nxt = self._succ[toks[:, t - 1], pick[:, t]]
            toks[:, t] = np.where(follow[:, t], nxt, fresh[:, t])
        return {"tokens": toks}


def make_batch_specs(cfg, shape_cfg, prefix_dtype="float32") -> dict:
    """Meta tensors of every model input of a shape cell: ``tokens`` (B,
    S - prefix) int32 and, for a vlm, ``prefix_embed`` (B, prefix, D) of
    ``prefix_dtype``."""
    b, s = shape_cfg.global_batch, shape_cfg.seq_len
    text = s - cfg.prefix_len
    specs = {"tokens": torch.empty((b, text), dtype=torch.int32,
                                   device="meta")}
    if cfg.prefix_len:
        specs["prefix_embed"] = torch.empty(
            (b, cfg.prefix_len, cfg.d_model), dtype=getattr(torch,
                                                           prefix_dtype),
            device="meta")
    return specs
