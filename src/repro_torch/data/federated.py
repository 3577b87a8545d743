"""Federated partitioning: IID and Dirichlet label-skew non-IID (paper §V,
Zhao et al.) with heterogeneous per-client data quantities D_n.

Host numpy, draw for draw the reference package's ``data/federated.py``,
so one seed gives the same federation bit for bit.  The partition is
materialised as fixed-capacity padded arrays:
  x (N, cap, dim), y (N, cap), counts (N,).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data import synthetic


@dataclasses.dataclass
class FederatedData:
    x: np.ndarray          # (N, cap, dim) float32, zero-padded
    y: np.ndarray          # (N, cap) int32
    counts: np.ndarray     # (N,) int64 — D_n
    test_x: np.ndarray     # (T, dim)
    test_y: np.ndarray     # (T,)

    @property
    def n_clients(self) -> int:
        return self.x.shape[0]


def _quantities(rng: np.random.Generator, n_clients: int, lo: int, hi: int
                ) -> np.ndarray:
    # every client owns at least one sample
    return np.maximum(rng.integers(lo, hi + 1, n_clients), 1)


def make_federated(rng: np.random.Generator, *, n_clients: int,
                   dim: int = 784, n_classes: int = 10, iid: bool = True,
                   min_samples: int = 200, max_samples: int = 1200,
                   dirichlet_alpha: float = 0.5, test_samples: int = 2000,
                   noise: float = 1.2) -> FederatedData:
    counts = _quantities(rng, n_clients, min_samples, max_samples)
    cap = int(max_samples)
    total = int(counts.sum())
    # one shared pool so all clients draw from the same distribution family
    pool_x, pool_y = synthetic.make_classification(
        rng, n_samples=total + test_samples, dim=dim, n_classes=n_classes,
        noise=noise)
    test_x, test_y = pool_x[:test_samples], pool_y[:test_samples]
    pool_x, pool_y = pool_x[test_samples:], pool_y[test_samples:]

    x = np.zeros((n_clients, cap, dim), np.float32)
    y = np.zeros((n_clients, cap), np.int32)

    if iid:
        perm = rng.permutation(total)
        offset = 0
        for c in range(n_clients):
            take = perm[offset:offset + counts[c]]
            offset += counts[c]
            x[c, :counts[c]] = pool_x[take]
            y[c, :counts[c]] = pool_y[take]
    else:
        # Dirichlet label-skew: each client draws a class mixture ~ Dir(α)
        by_class = [np.where(pool_y == k)[0] for k in range(n_classes)]
        for k in range(n_classes):
            rng.shuffle(by_class[k])
        sizes = np.asarray([len(b) for b in by_class], np.int64)
        if sizes.sum() == 0:
            raise ValueError("empty sample pool for the Dirichlet partition")
        class_ptr = np.zeros(n_classes, np.int64)
        for c in range(n_clients):
            mix = rng.dirichlet(np.full(n_classes, dirichlet_alpha))
            quota = mix * counts[c]
            per_class = np.floor(quota).astype(np.int64)
            # top the flooring deficit back up over non-empty classes by
            # largest fractional remainder, so every client gets exactly
            # its drawn counts[c]
            per_class[sizes == 0] = 0
            eligible = np.flatnonzero(sizes > 0)
            order = eligible[np.argsort(-(quota[eligible] % 1.0),
                                        kind="stable")]
            deficit = int(counts[c] - per_class.sum())
            if deficit > 0:
                add = np.bincount(np.arange(deficit) % len(order),
                                  minlength=len(order))
                per_class[order] += add
            taken = []
            for k in range(n_classes):
                need = int(per_class[k])
                if need == 0:
                    continue
                avail = by_class[k]
                start = class_ptr[k]
                idx = [avail[(start + i) % len(avail)] for i in range(need)]
                class_ptr[k] = (start + need) % len(avail)
                taken.extend(idx)
            taken = np.asarray(taken, np.int64)
            rng.shuffle(taken)
            if len(taken) != counts[c]:
                raise RuntimeError(f"client {c}: partition drew "
                                   f"{len(taken)} samples, wanted {counts[c]}")
            x[c, :len(taken)] = pool_x[taken]
            y[c, :len(taken)] = pool_y[taken]

    return FederatedData(x, y, counts.astype(np.int64), test_x, test_y)
