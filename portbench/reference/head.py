"""The MLP head both sides use, drawn from the run's seed.

Glorot-normal weights (std sqrt(2 / (fan in + fan out))), zero biases, float32: a
``feature size → hidden → labels`` ReLU MLP. The harness writes it into the program's
head artifact; the reference draws it again from the same seed.
"""

from __future__ import annotations

import numpy as np


def draw_head(seed: int, feature_size: int, hidden: list[int], labels: list[str]) -> dict:
    """{"weights": [...], "biases": [...], "labels": [...]} for ``seed``."""
    rng = np.random.default_rng(seed)
    dims = [feature_size, *hidden, len(labels)]
    return {
        "weights": [(rng.standard_normal((a, b)) * np.sqrt(2.0 / (a + b))).astype(np.float32)
                    for a, b in zip(dims[:-1], dims[1:])],
        "biases": [np.zeros(b, dtype=np.float32) for b in dims[1:]],
        "labels": list(labels),
    }
