"""LM token batching for the substrate's training path.

Host-side iterator producing (tokens, labels) next-token batches from a
synthetic Zipf stream, the reference's ``data/tokens.py``: one numpy
generator gives the same batches bit for bit.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from repro_torch.data import synthetic


def token_batches(rng: np.random.Generator, *, vocab: int, batch: int,
                  seq_len: int, n_batches: int
                  ) -> Iterator[Dict[str, np.ndarray]]:
    stream = synthetic.make_tokens(
        rng, n_tokens=batch * (seq_len + 1) * n_batches + 1, vocab=vocab)
    per = batch * (seq_len + 1)
    for i in range(n_batches):
        chunk = stream[i * per:(i + 1) * per + 1]
        toks = chunk[:-1].reshape(batch, seq_len + 1)
        yield {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}
