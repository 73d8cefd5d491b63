"""MLP classifier head, inference half, with a scikit-learn-shaped API.

Counterpart of ``ser_tpu/models/mlp_head.py::JaxMLPClassifier`` (``from_state``,
``decision_function``, ``predict_proba``, ``predict``). It loads the same
``ser_tpu_mlp`` state, computes the ReLU MLP's logits on its device in
float32, and the probabilities in numpy exactly as the JAX head does. ``fit``
waits for the training slice (``ROADMAP.md``).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from ser_tpu_torch.models.convert import mlp_head_layers


class TorchMLPClassifier:
    """A fitted ReLU MLP head; ``classes_`` orders the probability columns."""

    def __init__(
        self,
        layers: list[tuple[torch.Tensor, torch.Tensor]],
        classes: np.ndarray,
        *,
        device: torch.device | str = "cpu",
    ) -> None:
        self.device = torch.device(device)
        self.classes_ = np.asarray(classes)
        self._layers = [(w.to(self.device), b.to(self.device)) for w, b in layers]

    @classmethod
    def from_state(
        cls, state: Mapping, *, device: torch.device | str = "cpu"
    ) -> "TorchMLPClassifier":
        """Rebuilds a fitted head from a ``ser_tpu_mlp`` state (``get_state()`` output)."""
        return cls(mlp_head_layers(state), np.asarray(state["classes"]), device=device)

    @torch.inference_mode()
    def decision_function(self, X: np.ndarray) -> np.ndarray:
        """Logits (n, n_classes), float32, computed on the head's device."""
        x = torch.as_tensor(np.asarray(X, dtype=np.float32), device=self.device)
        for weight, bias in self._layers[:-1]:
            x = torch.relu(x @ weight + bias)
        weight, bias = self._layers[-1]
        return (x @ weight + bias).cpu().numpy()

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        """Class probabilities, columns ordered like ``classes_``."""
        logits = self.decision_function(X)
        exp = np.exp(logits - logits.max(axis=1, keepdims=True))
        return exp / exp.sum(axis=1, keepdims=True)

    def predict(self, X: np.ndarray) -> np.ndarray:
        """Predicted class labels."""
        return self.classes_[np.argmax(self.decision_function(X), axis=1)]


__all__ = ["TorchMLPClassifier"]
