"""Synthetic task-labeled long-context corpus (port of
``repro/data/synthetic.py``: numpy only, the same batches for the same
seed).

The paper trains the router on a mixture of retrieval-intensive (QA,
multi-hop) and context-holistic (LM, summarization, code) tasks
(§4.1).  We reproduce the *property that matters for the router* —
divergent sparsity tolerance — with two controlled synthetic families:

  * ``needle`` / ``multihop`` (retrieval-intensive): KEY/VALUE records
    are scattered through filler; the final query asks for a key's
    value.  Answering requires exact long-range attention — accuracy
    collapses under sink+local sparsity once the needle falls outside
    the window (paper Fig. 1a).
  * ``markov`` (context-holistic): a fixed-order Markov language; next-
    token prediction depends only on recent context — robust to
    aggressive sparsification.

Token space layout (vocab ≥ 64):
  0 PAD, 1 QUERY, 2 KEY, 3 VALUE, 4 SEP,
  [5, 5+n_symbols) symbol tokens (keys/values/filler/markov states).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from repro_torch.core.sparsity import TASK_HOLISTIC, TASK_RETRIEVAL

PAD, QUERY, KEY, VALUE, SEP = 0, 1, 2, 3, 4
SYM0 = 5


@dataclass
class Batch:
    tokens: np.ndarray      # (B, S) int32
    labels: np.ndarray      # (B, S) int32 (next-token targets)
    loss_mask: np.ndarray   # (B, S) float32
    task_type: np.ndarray   # (B,) int32


def _n_symbols(vocab: int) -> int:
    return max(8, min(vocab - SYM0, 256))


def _markov_matrix(rng: np.random.Generator, n: int) -> np.ndarray:
    """Sparse-ish row-stochastic transition matrix (top-4 successors)."""
    m = np.full((n, n), 1e-3)
    for i in range(n):
        succ = rng.choice(n, size=4, replace=False)
        m[i, succ] += rng.dirichlet(np.ones(4)) * 10.0
    return m / m.sum(1, keepdims=True)


class SyntheticTasks:
    """Deterministic-seeded generator for both task families."""

    def __init__(self, vocab: int, seed: int = 0):
        self.vocab = vocab
        self.n_sym = _n_symbols(vocab)
        rng = np.random.default_rng(seed)
        self.markov = _markov_matrix(rng, self.n_sym)

    # -- context-holistic ---------------------------------------------------
    def markov_batch(self, rng: np.random.Generator, batch: int,
                     seq: int) -> Batch:
        toks = np.empty((batch, seq + 1), np.int64)
        toks[:, 0] = rng.integers(0, self.n_sym, batch)
        cdf = np.cumsum(self.markov, axis=1)
        for t in range(seq):
            u = rng.random(batch)
            toks[:, t + 1] = (u[:, None] < cdf[toks[:, t]]).argmax(1)
        toks += SYM0
        tokens = toks[:, :-1].astype(np.int32)
        labels = toks[:, 1:].astype(np.int32)
        mask = np.ones((batch, seq), np.float32)
        return Batch(tokens, labels, mask,
                     np.full(batch, TASK_HOLISTIC, np.int32))

    # -- retrieval-intensive ------------------------------------------------
    # Symbol space is split: filler draws from the lower half, keys and
    # values from the upper half — filler can never collide with a key,
    # so the retrieval target is unambiguous (otherwise a random filler
    # token equal to the key caps attainable accuracy).
    @property
    def _kv_pool(self) -> Tuple[int, int]:
        half = self.n_sym // 2
        return SYM0 + half, SYM0 + self.n_sym

    def _filler(self, rng, shape):
        half = self.n_sym // 2
        return rng.integers(SYM0, SYM0 + half, shape).astype(np.int64)

    def needle_batch(self, rng: np.random.Generator, batch: int, seq: int,
                     hops: int = 1, needle_pos: Optional[float] = None
                     ) -> Batch:
        """(KEY, k, v, SEP) records in filler; suffix (SEP, QUERY, k) →
        predict v at the final position (value right after the matched
        key: the classic induction pattern, learnable by a 2-layer
        model).

        ``needle_pos`` ∈ [0,1) pins the needle's relative depth
        (RULER-style placement sweeps); None = uniform random.
        """
        lo_kv, hi_kv = self._kv_pool
        tokens = self._filler(rng, (batch, seq))
        labels = np.zeros((batch, seq), np.int64)
        mask = np.zeros((batch, seq), np.float32)
        rec, q_len = 4, 3
        for b in range(batch):
            k, v = rng.choice(np.arange(lo_kv, hi_kv), size=2,
                              replace=False)
            lo, hi = 0, seq - q_len - rec - 1
            if needle_pos is not None:
                p = int(needle_pos * (hi - lo)) + lo
            else:
                p = int(rng.integers(lo, max(hi, lo + 1)))
            tokens[b, p:p + rec] = (KEY, k, v, SEP)
            tokens[b, seq - q_len:] = (SEP, QUERY, k)
            labels[b, seq - 1] = v
            mask[b, seq - 1] = 1.0
        return Batch(tokens.astype(np.int32), labels.astype(np.int32), mask,
                     np.full(batch, TASK_RETRIEVAL, np.int32))

    def multihop_batch(self, rng, batch: int, seq: int) -> Batch:
        """Two-hop retrieval: (KEY,k0,k1,SEP) … (KEY,k1,k2,SEP); query
        k0 → k2 requires composing two lookups (MuSiQue-style)."""
        lo_kv, hi_kv = self._kv_pool
        tokens = self._filler(rng, (batch, seq))
        labels = np.zeros((batch, seq), np.int64)
        mask = np.zeros((batch, seq), np.float32)
        for b in range(batch):
            k0, k1, k2 = rng.choice(np.arange(lo_kv, hi_kv), size=3,
                                    replace=False)
            hi = seq - 3 - 5
            p0, p1 = sorted(rng.choice(hi - 8, size=2, replace=False))
            p1 += 8  # ensure no overlap
            tokens[b, p0:p0 + 4] = (KEY, k0, k1, SEP)
            tokens[b, p1:p1 + 4] = (KEY, k1, k2, SEP)
            tokens[b, seq - 3:] = (SEP, QUERY, k0)
            labels[b, seq - 1] = k2
            mask[b, seq - 1] = 1.0
        return Batch(tokens.astype(np.int32), labels.astype(np.int32), mask,
                     np.full(batch, TASK_RETRIEVAL, np.int32))

    def batch(self, rng, task: str, batch: int, seq: int, **kw) -> Batch:
        if task == "markov":
            return self.markov_batch(rng, batch, seq)
        if task == "needle":
            return self.needle_batch(rng, batch, seq, **kw)
        if task == "multihop":
            return self.multihop_batch(rng, batch, seq)
        raise ValueError(task)


def mixture_iterator(vocab: int, batch: int, seq: int, *, seed: int = 0,
                     weights: Optional[Dict[str, float]] = None
                     ) -> Iterator[Batch]:
    """Infinite task-mixture stream (paper §4.1 / Fig. 7).

    ``weights``: task → sampling weight; default balanced
    retrieval/holistic (the paper shows skew collapses the router —
    bench_data_balance sweeps this).
    """
    weights = weights or {"markov": 0.5, "needle": 0.35, "multihop": 0.15}
    tasks = list(weights)
    p = np.asarray([weights[t] for t in tasks], np.float64)
    p /= p.sum()
    gen = SyntheticTasks(vocab, seed)
    rng = np.random.default_rng(seed + 1)
    while True:
        yield gen.batch(rng, tasks[rng.choice(len(tasks), p=p)], batch, seq)


def retrieval_accuracy(logits: np.ndarray, batch: Batch) -> float:
    """Accuracy at masked (answer) positions."""
    pred = logits.argmax(-1)
    hit = (pred == batch.labels) * (batch.loss_mask > 0)
    denom = batch.loss_mask.sum()
    return float(hit.sum() / max(denom, 1))
