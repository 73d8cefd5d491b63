"""MLP classifier head with a scikit-learn-shaped API: training and inference.

Counterpart of ``ser_tpu/models/mlp_head.py::JaxMLPClassifier``
(``from_config``, ``fit``, ``get_state``, ``from_state``,
``decision_function``, ``predict_proba``, ``predict``). The state is the same
``ser_tpu_mlp`` dict, so a head either package fits loads in the other.

``fit`` keeps the JAX head's semantics, which are scikit-learn's adam
solver: Glorot-uniform weights and zero biases; minibatches of a fixed size
(``"auto"``: min(200, n)), the last ones padded with masked rows, the rows
permuted each epoch; the loss the masked mean log-loss plus
``alpha / 2 · Σ‖W‖²`` over the batch's valid count (not the dataset's);
``optax.adam`` (``parallel/optim.py::adam``, eps from the config); and
scikit-learn's stall rule on the epoch's mean loss (``tol``,
``n_iter_no_change``). It runs on the head's device in float32, with TF32
off on the card; ``from_config`` takes that device from the settings
(``SER_TORCH_DEVICE``: the card unless the settings ask for the CPU).

The random numbers differ: the JAX head draws its weights and its epoch
permutations from ``jax.random``, which the port cannot reproduce. ``fit``
draws the same distributions from ``torch.Generator``s seeded with
``random_state`` (weights) and ``random_state + 1`` (permutations), and
hands them to the training loop proper, which :meth:`TorchMLPClassifier.fit_from`
exposes with the initial layers and the permutations as arguments: given the
JAX head's, it computes what the JAX head computes.
"""

from __future__ import annotations

from collections.abc import Callable, Mapping, Sequence

import numpy as np
import torch

from ser_tpu_torch._internal.config.bootstrap import reload_settings
from ser_tpu_torch._internal.repr.runtime_policy import resolve_device
from ser_tpu_torch._internal.utils.torch_runtime import honor_platform_env
from ser_tpu_torch.models.convert import mlp_head_layers
from ser_tpu_torch.ops.dsp import _float32_products
from ser_tpu_torch.parallel import optim

type Layers = list[tuple[torch.Tensor, torch.Tensor]]
#: Epoch index → a permutation of the padded rows (numpy or tensor).
type PermutationSource = Callable[[int], np.ndarray | torch.Tensor]


def _as_tensor(value, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A copy of ``value`` (a tensor, or anything numpy reads) on ``device``."""
    if not isinstance(value, torch.Tensor):
        value = torch.from_numpy(np.array(value))
    return value.to(device=device, dtype=dtype, copy=True)


def _forward(layers: Sequence[tuple[torch.Tensor, torch.Tensor]], x: torch.Tensor) -> torch.Tensor:
    """ReLU MLP logits."""
    for weight, bias in layers[:-1]:
        x = torch.relu(x @ weight + bias)
    weight, bias = layers[-1]
    return x @ weight + bias


class TorchMLPClassifier:
    """A ReLU MLP head; ``classes_`` orders the probability columns once it is fitted."""

    def __init__(
        self,
        *,
        hidden_layer_sizes: tuple[int, ...] = (300,),
        alpha: float = 0.01,
        batch_size: int | str = 256,
        learning_rate_init: float = 1e-3,
        epsilon: float = 1e-8,
        max_iter: int = 500,
        tol: float = 1e-4,
        n_iter_no_change: int = 10,
        random_state: int = 42,
        device: torch.device | str | None = None,
    ) -> None:
        """``device`` None is the device ``SER_TORCH_DEVICE`` names (``honor_platform_env``)."""
        self.hidden_layer_sizes = tuple(hidden_layer_sizes)
        self.alpha = alpha
        self.batch_size = batch_size
        self.learning_rate_init = learning_rate_init
        self.epsilon = epsilon
        self.max_iter = max_iter
        self.tol = tol
        self.n_iter_no_change = n_iter_no_change
        self.random_state = random_state
        self.device = honor_platform_env() if device is None else torch.device(device)
        self.classes_: np.ndarray | None = None
        self._layers: Layers | None = None
        self.n_iter_ = 0
        self.loss_ = float("inf")
        #: The epochs' mean losses (scikit-learn's ``loss_curve_``), filled by a fit:
        #: a fit on the card is held against one on the CPU epoch by epoch, not
        #: only at its last epoch.
        self.loss_curve_: list[float] = []

    @classmethod
    def from_config(cls, config, *, device: torch.device | str | None = None) -> "TorchMLPClassifier":
        """An unfitted head from the settings' ``NeuralNetConfig``, on ``device``.

        ``device`` None is the settings' device (``SER_TORCH_DEVICE``), resolved
        as every entry point resolves it: with no card, ``auto`` raises.
        """
        if device is None:
            device = resolve_device(reload_settings().torch_runtime.device)
        return cls(
            hidden_layer_sizes=tuple(config.hidden_layer_sizes),
            alpha=config.alpha,
            batch_size=config.batch_size,
            epsilon=config.epsilon,
            max_iter=config.max_iter,
            random_state=config.random_state,
            device=device,
        )

    @classmethod
    def from_state(cls, state: Mapping, *, device: torch.device | str | None = None) -> "TorchMLPClassifier":
        """A fitted head from a ``ser_tpu_mlp`` state (``get_state()`` of either package).

        ``device`` None is the device ``SER_TORCH_DEVICE`` names: the card,
        the CPU only when asked for; with neither, it raises.
        """
        layers = mlp_head_layers(state)
        model = cls(
            hidden_layer_sizes=tuple(state["hidden_layer_sizes"]),
            alpha=state["alpha"],
            batch_size=state["batch_size"],
            epsilon=state["epsilon"],
            max_iter=state["max_iter"],
            random_state=state["random_state"],
            device=device,
        )
        model.classes_ = np.asarray(state["classes"])
        model._layers = [(w.to(model.device), b.to(model.device)) for w, b in layers]
        model.n_iter_ = int(state.get("n_iter", 0))
        model.loss_ = float(state.get("loss", float("inf")))
        return model

    # ------------------------------------------------------------------ #
    # Training
    # ------------------------------------------------------------------ #

    def _labels(self, X: np.ndarray, y) -> tuple[np.ndarray, np.ndarray]:
        """Checks the inputs, sets ``classes_`` and returns (X float32, class indices)."""
        X = np.asarray(X, dtype=np.float32)
        if X.ndim != 2 or X.shape[0] == 0:
            raise ValueError("X must be a non-empty 2D array.")
        y_arr = np.asarray([str(label) for label in np.asarray(y).ravel()])
        if y_arr.shape[0] != X.shape[0]:
            raise ValueError("X and y must have the same number of samples.")
        self.classes_ = np.array(sorted(set(y_arr.tolist())))
        if len(self.classes_) < 2:
            raise ValueError(
                f"This solver needs samples of at least 2 classes in the data; got {len(self.classes_)}."
            )
        index = {label: i for i, label in enumerate(self.classes_)}
        return X, np.asarray([index[label] for label in y_arr], dtype=np.int64)

    def batch_rows(self, n_samples: int) -> tuple[int, int]:
        """(rows a minibatch, padded rows an epoch) for ``n_samples``."""
        batch = min(200, n_samples) if self.batch_size == "auto" else int(self.batch_size)
        batch = max(1, min(batch, n_samples))
        return batch, -(-n_samples // batch) * batch

    def layer_dims(self, n_features: int, n_classes: int) -> list[int]:
        return [n_features, *self.hidden_layer_sizes, n_classes]

    def fit(self, X: np.ndarray, y) -> "TorchMLPClassifier":
        """Fits the head from seeded initial layers and permutations; returns self."""
        X, y_idx = self._labels(X, y)
        dims = self.layer_dims(X.shape[1], len(self.classes_))
        weights = torch.Generator().manual_seed(self.random_state)
        layers = []
        for fan_in, fan_out in zip(dims[:-1], dims[1:]):
            bound = float(np.sqrt(6.0 / (fan_in + fan_out)))
            weight = torch.rand(fan_in, fan_out, generator=weights) * (2 * bound) - bound
            layers.append((weight, torch.zeros(fan_out)))
        _, padded = self.batch_rows(X.shape[0])
        shuffles = torch.Generator().manual_seed(self.random_state + 1)
        return self._train(X, y_idx, layers, lambda _: torch.randperm(padded, generator=shuffles))

    def fit_from(
        self, X: np.ndarray, y, *, layers: Sequence[tuple], permutation: PermutationSource
    ) -> "TorchMLPClassifier":
        """The training loop from given initial layers ((in, out) weights, biases) and epoch permutations."""
        return self._train(*self._labels(X, y), layers, permutation)

    def _train(
        self, X: np.ndarray, y_idx: np.ndarray, layers: Sequence[tuple], permutation: PermutationSource
    ) -> "TorchMLPClassifier":
        """The training loop on checked inputs: float32 ``X`` and class indices ``y_idx``."""
        n_samples, n_features = X.shape
        batch, padded = self.batch_rows(n_samples)
        n_batches = padded // batch
        device = self.device
        x_dev = torch.zeros(padded, n_features, device=device)
        x_dev[:n_samples] = torch.from_numpy(X).to(device)
        y_dev = torch.zeros(padded, dtype=torch.int64, device=device)
        y_dev[:n_samples] = torch.from_numpy(y_idx).to(device)
        mask_dev = torch.zeros(padded, device=device)
        mask_dev[:n_samples] = 1.0
        params = {}
        for i, (weight, bias) in enumerate(layers):
            # Copies: the optimizer updates its parameters in place.
            params[f"w{i}"] = _as_tensor(weight, torch.float32, device).requires_grad_()
            params[f"b{i}"] = _as_tensor(bias, torch.float32, device).requires_grad_()
        n_layers = len(layers)
        pairs = [(params[f"w{i}"], params[f"b{i}"]) for i in range(n_layers)]
        adam = optim.adam(self.learning_rate_init, eps=self.epsilon)
        opt_state = adam.init(params)
        alpha = self.alpha

        def loss_fn(xb: torch.Tensor, yb: torch.Tensor, mb: torch.Tensor) -> torch.Tensor:
            log_probs = torch.log_softmax(_forward(pairs, xb), dim=-1)
            nll = -log_probs.gather(1, yb[:, None])[:, 0]
            count = torch.clamp(mb.sum(), min=1.0)
            l2 = sum((weight * weight).sum() for weight, _ in pairs)
            # The L2 term over the batch's valid count, as scikit-learn's _backprop.
            return (nll * mb).sum() / count + 0.5 * alpha * l2 / count

        best_loss, stall = float("inf"), 0
        self.loss_curve_ = []
        with _float32_products(device):
            for epoch in range(self.max_iter):
                order = _as_tensor(permutation(epoch), torch.int64, device)
                xs = x_dev[order].reshape(n_batches, batch, n_features)
                ys = y_dev[order].reshape(n_batches, batch)
                ms = mask_dev[order].reshape(n_batches, batch)
                losses = []
                for step in range(n_batches):
                    loss = loss_fn(xs[step], ys[step], ms[step])
                    grads = torch.autograd.grad(loss, list(params.values()))
                    opt_state = adam.apply(params, dict(zip(params, grads)), opt_state)
                    losses.append(loss.detach())
                loss_value = float(torch.stack(losses).mean())
                self.n_iter_ = epoch + 1
                self.loss_ = loss_value
                self.loss_curve_.append(loss_value)
                # scikit-learn's _update_no_improvement_count: the count resets only on
                # an improvement above tol, best_loss follows any improvement, and
                # training stops after more than n_iter_no_change stalled epochs.
                stall = stall + 1 if loss_value > best_loss - self.tol else 0
                best_loss = min(best_loss, loss_value)
                if stall > self.n_iter_no_change:
                    break
        self._layers = [(params[f"w{i}"].detach(), params[f"b{i}"].detach()) for i in range(n_layers)]
        return self

    # ------------------------------------------------------------------ #
    # Inference
    # ------------------------------------------------------------------ #

    def _require_fitted(self) -> Layers:
        if self._layers is None or self.classes_ is None:
            raise RuntimeError("TorchMLPClassifier is not fitted.")
        return self._layers

    @torch.inference_mode()
    def decision_function(self, X: np.ndarray) -> np.ndarray:
        """Logits (n, n_classes), float32, computed on the head's device."""
        layers = self._require_fitted()
        x = torch.as_tensor(np.asarray(X, dtype=np.float32), device=self.device)
        return _forward(layers, x).cpu().numpy()

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        """Class probabilities, columns ordered like ``classes_``."""
        logits = self.decision_function(X)
        exp = np.exp(logits - logits.max(axis=1, keepdims=True))
        return exp / exp.sum(axis=1, keepdims=True)

    def predict(self, X: np.ndarray) -> np.ndarray:
        """Predicted class labels."""
        self._require_fitted()
        return self.classes_[np.argmax(self.decision_function(X), axis=1)]

    # ------------------------------------------------------------------ #
    # Serialization
    # ------------------------------------------------------------------ #

    def get_state(self) -> dict:
        """The ``ser_tpu_mlp`` state: plain Python values and float32 numpy arrays."""
        layers = self._require_fitted()
        return {
            "kind": "ser_tpu_mlp",
            "hidden_layer_sizes": list(self.hidden_layer_sizes),
            "alpha": self.alpha,
            "batch_size": self.batch_size,
            "epsilon": self.epsilon,
            "max_iter": self.max_iter,
            "random_state": self.random_state,
            "classes": self.classes_.tolist(),
            "weights": [w.detach().cpu().numpy() for w, _ in layers],
            "biases": [b.detach().cpu().numpy() for _, b in layers],
            "n_iter": self.n_iter_,
            "loss": self.loss_,
        }


__all__ = ["TorchMLPClassifier"]
