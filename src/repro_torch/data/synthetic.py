"""Deterministic synthetic LM data.

A Zipf-ish unigram stream with a planted bigram structure so the loss has
learnable signal (useful for convergence smoke tests), generated chunk-wise
from a counter-based RNG — every shard is reproducible from (seed, step),
which is what checkpoint-restart correctness tests rely on.
"""
from __future__ import annotations

import numpy as np


class SyntheticLM:
    def __init__(self, vocab_size: int, seq_len: int, seed: int = 0):
        self.vocab = vocab_size
        self.seq = seq_len
        self.seed = seed
        # planted bigram: token t is often followed by (a*t + c) % V
        self._a = 31
        self._c = 17

    def batch(self, step: int, batch_size: int) -> dict:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        # zipf-ish unigram draw
        u = rng.random((batch_size, self.seq + 1))
        toks = np.minimum((self.vocab * u ** 2.5).astype(np.int64),
                          self.vocab - 1)
        # plant bigrams with prob 0.5
        follow = rng.random((batch_size, self.seq)) < 0.5
        nxt = (self._a * toks[:, :-1] + self._c) % self.vocab
        toks[:, 1:] = np.where(follow, nxt, toks[:, 1:])
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }


def batch_for_model(cfg, shape_kind: str, step: int, batch: int, seq: int,
                    seed: int = 0) -> dict:
    """Synthetic batch matching a model's batch_specs."""
    ds = SyntheticLM(cfg.vocab_size, seq, seed)
    out = ds.batch(step, batch)
    if cfg.family == "vlm":
        npatch = cfg.n_frontend_tokens
        rng = np.random.default_rng(step + 1)
        out = {
            "patches": rng.standard_normal(
                (batch, npatch, cfg.d_model)).astype(np.float32) * 0.02,
            "tokens": out["tokens"][:, :seq - npatch],
            "labels": out["labels"][:, :seq - npatch],
        }
    elif cfg.family == "audio":
        rng = np.random.default_rng(step + 2)
        out["frames"] = rng.standard_normal(
            (batch, seq, cfg.d_model)).astype(np.float32) * 0.02
    if shape_kind == "prefill":
        out.pop("labels", None)
    return out
