"""Synthetic token streams for LM training and serving — the port's own
numpy copy of ``repro.data.synthetic_lm``, which gives the same batches bit
for bit.

Deterministic, seekable (resume-from-step) generators of structured token
sequences (Zipfian unigram + Markov bigram mixture), so the loss falls
during training runs; and the stub modality frontends' inputs (patch and
frame embeddings).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TokenStreamConfig", "sample_batch", "sample_modality_stub"]


@dataclasses.dataclass(frozen=True)
class TokenStreamConfig:
    vocab_size: int
    seq_len: int
    zipf_a: float = 1.2
    markov_order: int = 1
    n_states: int = 64  # latent Markov states inducing learnable structure


def _zipf_probs(vocab: int, a: float) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-a)
    return p / p.sum()


def sample_batch(
    cfg: TokenStreamConfig, batch: int, step: int, seed: int = 0
) -> dict[str, np.ndarray]:
    """Deterministic batch for a given (seed, step): resumable by construction."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    probs = _zipf_probs(cfg.vocab_size, cfg.zipf_a)
    # latent-state Markov chain over vocab partitions: state s emits tokens
    # ≡ s mod n_states w.h.p., so next-token prediction is learnable
    states = rng.integers(0, cfg.n_states, (batch,))
    toks = np.empty((batch, cfg.seq_len + 1), dtype=np.int32)
    base = rng.choice(cfg.vocab_size, size=(batch, cfg.seq_len + 1), p=probs)
    for t in range(cfg.seq_len + 1):
        emit = (base[:, t] // cfg.n_states) * cfg.n_states + states
        use_struct = rng.random(batch) < 0.75
        toks[:, t] = np.where(use_struct, emit % cfg.vocab_size, base[:, t])
        states = (states * 31 + toks[:, t]) % cfg.n_states
    return {
        "tokens": toks[:, :-1],
        "labels": toks[:, 1:],
        "weights": np.ones((batch,), dtype=np.float32),
    }


def sample_modality_stub(
    batch: int, n_positions: int, dim: int, step: int, seed: int = 1
) -> np.ndarray:
    """Precomputed patch/frame embeddings (the vision and audio frontend stubs)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step, 7]))
    return rng.standard_normal((batch, n_positions, dim)).astype(np.float32) * 0.02
