"""kNN feature probe of the representation (unite_tpu/utils/knn.py), with
the ECE metric re-exported beside it."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from unite_torch.utils.metrics import compute_ece  # noqa: F401  (re-export)


def knn_classifier(
    train_features: np.ndarray,
    train_labels: np.ndarray,
    test_features: np.ndarray,
    test_labels: np.ndarray,
    k: int = 20,
    temperature: float = 0.07,
    num_classes: int = 0,
) -> Tuple[float, float]:
    """Weighted-vote cosine kNN (the DINO/UMT probe): features L2-normed,
    each of the k nearest neighbours votes for its label with weight
    exp(sim / T). Returns (top1, top5) in percent."""
    train = np.asarray(train_features, np.float32)
    test = np.asarray(test_features, np.float32)
    train = train / (np.linalg.norm(train, axis=1, keepdims=True) + 1e-8)
    test = test / (np.linalg.norm(test, axis=1, keepdims=True) + 1e-8)
    train_labels = np.asarray(train_labels)
    test_labels = np.asarray(test_labels)
    c = num_classes or int(train_labels.max()) + 1
    k = min(k, train.shape[0])

    top1 = top5 = 0
    for i in range(0, test.shape[0], 256):
        chunk = test[i: i + 256]
        sim = chunk @ train.T  # [b, Ntrain]
        idx = np.argpartition(-sim, k - 1, axis=1)[:, :k]
        rows = np.arange(chunk.shape[0])[:, None]
        w = np.exp(sim[rows, idx] / temperature)
        votes = np.zeros((chunk.shape[0], c), np.float64)
        for j in range(k):
            np.add.at(votes, (np.arange(chunk.shape[0]),
                              train_labels[idx[:, j]]), w[:, j])
        order = np.argsort(-votes, axis=1)
        labels = test_labels[i: i + 256]
        top1 += int((order[:, 0] == labels).sum())
        top5 += int((order[:, :5] == labels[:, None]).any(1).sum())
    n = test.shape[0]
    return 100.0 * top1 / n, 100.0 * top5 / n
