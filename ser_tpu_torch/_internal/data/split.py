"""The train/test split of ``loader.load_data``, drawn as scikit-learn 1.9 draws it.

The JAX package splits with ``sklearn.model_selection.train_test_split``,
which the port does not import. These functions draw the same indices from
``np.random.RandomState(random_state)`` in the same order:

- the sizes as ``_validate_shuffle_split`` gives them (``n_test`` the ceiling
  of a float share, ``n_train`` the rest), with the same ``ValueError``s;
- unstratified, ``ShuffleSplit``'s one permutation: the first ``n_test``
  indices are the test set, the next ``n_train`` the train set;
- stratified, ``StratifiedShuffleSplit``'s: the classes as ``np.unique``
  sorts them, each class's share of the train and then of the test draws by
  ``_approximate_mode`` (ties of the remainders broken by ``rng.choice``),
  one permutation per class in class order, then a permutation of the train
  and of the test set. A class of one member, or fewer train or test draws
  than classes, raises ``ValueError`` as there.
"""

from __future__ import annotations

import math
from collections.abc import Sequence

import numpy as np
from numpy.typing import NDArray


def split_sizes(n_samples: int, test_size: float | int) -> tuple[int, int]:
    """``(n_train, n_test)`` for ``test_size`` (a share in (0, 1), or a count), as scikit-learn sizes them."""
    kind = np.asarray(test_size).dtype.kind
    if (kind == "i" and (test_size >= n_samples or test_size <= 0)) or (
        kind == "f" and (test_size <= 0 or test_size >= 1)
    ):
        raise ValueError(
            f"test_size={test_size} should be either positive and smaller than the number of "
            f"samples {n_samples} or a float in the (0, 1) range"
        )
    if kind not in ("i", "f"):
        raise ValueError(f"Invalid value for test_size: {test_size}")
    n_test = math.ceil(test_size * n_samples) if kind == "f" else int(test_size)
    n_train = n_samples - n_test
    if n_train == 0:
        raise ValueError(
            f"With n_samples={n_samples}, test_size={test_size} and train_size=None, the resulting "
            "train set will be empty. Adjust any of the aforementioned parameters."
        )
    return n_train, n_test


def approximate_mode(class_counts: NDArray[np.int64], n_draws: int, rng: np.random.RandomState) -> NDArray:
    """Per class, how many of ``n_draws`` fall to it: floors, then the largest remainders, ties drawn by ``rng``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def train_test_indices(
    n_samples: int,
    *,
    test_size: float | int,
    random_state: int,
    stratify: Sequence | None = None,
) -> tuple[NDArray[np.int64], NDArray[np.int64]]:
    """``(train, test)`` row indices, in the order ``train_test_split`` returns the rows."""
    n_train, n_test = split_sizes(n_samples, test_size)
    rng = np.random.RandomState(random_state)
    if stratify is None:
        permutation = rng.permutation(n_samples)
        return permutation[n_test : n_test + n_train], permutation[:n_test]

    classes, y_indices, class_counts = np.unique(np.asarray(stratify), return_inverse=True, return_counts=True)
    if np.min(class_counts) < 2:
        raise ValueError(
            "The least populated classes in y have only 1 member, which is too few. The minimum number "
            f"of groups for any class cannot be less than 2. Classes with too few members are: "
            f"{classes[class_counts < 2].tolist()}"
        )
    if n_train < classes.shape[0]:
        raise ValueError(
            f"The train_size = {n_train} should be greater or equal to the number of classes = {classes.shape[0]}"
        )
    if n_test < classes.shape[0]:
        raise ValueError(
            f"The test_size = {n_test} should be greater or equal to the number of classes = {classes.shape[0]}"
        )
    class_indices = np.split(np.argsort(y_indices, kind="stable"), np.cumsum(class_counts)[:-1])
    n_i = approximate_mode(class_counts, n_train, rng)
    t_i = approximate_mode(class_counts - n_i, n_test, rng)
    train: list[int] = []
    test: list[int] = []
    for i in range(classes.shape[0]):
        members = class_indices[i].take(rng.permutation(class_counts[i]), mode="clip")
        train.extend(members[: n_i[i]])
        test.extend(members[n_i[i] : n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


__all__ = ["approximate_mode", "split_sizes", "train_test_indices"]
