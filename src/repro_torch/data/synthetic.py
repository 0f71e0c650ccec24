"""Synthetic conversation corpus (stands in for ShareGPT, paper §5): the
port's own copy of ``repro/data/synthetic.py``, numpy only, whose arrays
equal the JAX package's bit for bit for the same seeds.

A seeded order-2 Markov language over the model vocab with peaked but
stochastic transitions. This has exactly the statistical property the paper
exploits: strong dependence between NEIGHBORING tokens, so a sequentially-
independent draft head (Medusa) predicting x_{t+2} from h_t alone faces
irreducible branching entropy, while a sequentially-dependent head (Hydra)
conditioning on the sampled x̂_{t+1} can predict it — letting container-scale
experiments reproduce the paper's Hydra > Medusa ordering mechanistically.

"Conversations" are turn-structured: BOS / USER / ASSISTANT role tokens
delimit turns (paper trains on multi-turn chat data).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

BOS, USER, ASSISTANT = 0, 1, 2
N_SPECIAL = 3


@dataclass
class MarkovSpec:
    vocab_size: int
    branch: int = 4              # candidate continuations per bigram context
    peak: float = 0.7            # prob of the rank-0 continuation
    n_clusters: int = 16         # token clusters; context = cluster bigram
    seed: int = 0

    @property
    def n_ctx(self) -> int:
        return self.n_clusters * self.n_clusters


def _transition_tables(spec: MarkovSpec):
    """Per-context candidate sets. Contexts are CLUSTER bigrams
    (cluster(x) = x mod n_clusters): with n_ctx <= d_model the
    context->candidate lookup is low-rank and therefore LEARNABLE by the
    shallow draft-head MLPs — a hashed table would be a modular-arithmetic
    problem no 1-layer MLP can fit (empirically: heads stuck at chance)."""
    rng = np.random.RandomState(spec.seed)
    cands = rng.randint(N_SPECIAL, spec.vocab_size,
                        size=(spec.n_ctx, spec.branch)).astype(np.int32)
    rest = 1.0 - spec.peak
    tail = np.array([0.5 ** i for i in range(spec.branch - 1)])
    tail = rest * tail / tail.sum()
    probs = np.concatenate([[spec.peak], tail])
    return cands, probs


def _ctx_of(a: np.ndarray, b: np.ndarray, n_clusters: int) -> np.ndarray:
    return ((a.astype(np.int64) % n_clusters) * n_clusters
            + b.astype(np.int64) % n_clusters)


def sample_corpus(spec: MarkovSpec, n_seqs: int, seq_len: int,
                  seed: int = 1) -> np.ndarray:
    """Returns (n_seqs, seq_len) int32 token sequences."""
    cands, probs = _transition_tables(spec)
    rng = np.random.RandomState(seed)
    out = np.zeros((n_seqs, seq_len), np.int32)
    out[:, 0] = BOS
    out[:, 1] = rng.randint(N_SPECIAL, spec.vocab_size, size=n_seqs)
    roles = rng.randint(8, 24, size=n_seqs)  # turn length per conversation
    choice = rng.choice(spec.branch, size=(n_seqs, seq_len), p=probs)
    for t in range(2, seq_len):
        ctx = _ctx_of(out[:, t - 2], out[:, t - 1], spec.n_clusters)
        nxt = cands[ctx, choice[:, t]]
        # sprinkle role tokens to delimit "turns"
        turn = (t % roles) == 0
        out[:, t] = np.where(turn, USER + (t // roles) % 2, nxt)
    return out


class DataPipeline:
    """Deterministic batched iterator with train/eval split and (optional)
    per-host sharding for multi-process data parallelism."""

    def __init__(self, spec: MarkovSpec, *, seq_len: int, batch_size: int,
                 n_train: int = 512, n_eval: int = 64, seed: int = 1,
                 shard_index: int = 0, shard_count: int = 1):
        full = sample_corpus(spec, n_train + n_eval, seq_len, seed=seed)
        self.train = full[:n_train]
        self.eval = full[n_train:]
        self.batch_size = batch_size
        self.shard_index, self.shard_count = shard_index, shard_count
        self._rng = np.random.RandomState(seed + 17)

    def train_batches(self, n_steps: int):
        n = len(self.train)
        for _ in range(n_steps):
            idx = self._rng.randint(0, n, size=self.batch_size)
            idx = idx[self.shard_index::self.shard_count]
            yield self.train[idx]

    def eval_batch(self, size: int | None = None):
        size = size or self.batch_size
        return self.eval[:size]
