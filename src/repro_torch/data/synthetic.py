"""Synthetic datasets (host numpy).

``make_classification`` builds an MNIST-like 10-class problem: each class
is a random template in R^dim plus noise, squashed into a pixel-like
range.  ``make_tokens`` builds Zipf-distributed token streams for the
substrate's training path.  The draws are the reference package's, in
the same order, so one numpy seed gives the same data bit for bit.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def make_classification(rng: np.random.Generator, *, n_samples: int,
                        dim: int = 784, n_classes: int = 10,
                        noise: float = 1.2, template_scale: float = 1.0
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (x (n, dim) float32 in ~[0,1], y (n,) int32)."""
    templates = rng.normal(0.0, template_scale, (n_classes, dim))
    y = rng.integers(0, n_classes, n_samples)
    x = templates[y] + rng.normal(0.0, noise, (n_samples, dim))
    x = 1.0 / (1.0 + np.exp(-x))
    return x.astype(np.float32), y.astype(np.int32)


def make_tokens(rng: np.random.Generator, *, n_tokens: int, vocab: int,
                zipf_a: float = 1.2) -> np.ndarray:
    """Zipf-distributed token stream (n_tokens,) int32 in [0, vocab)."""
    ranks = rng.zipf(zipf_a, n_tokens).astype(np.int64)
    return (ranks % vocab).astype(np.int32)
