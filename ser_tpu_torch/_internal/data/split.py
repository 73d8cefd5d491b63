"""The train/test splits of the training paths, drawn as scikit-learn 1.9 draws them.

The JAX package splits with ``sklearn.model_selection.train_test_split``,
``GroupShuffleSplit`` and ``StratifiedGroupKFold``, which the port does not
import. These functions draw the same indices from
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
  than classes, raises ``ValueError`` as there;
- grouped (``GroupShuffleSplit``): the unstratified draw over the groups as
  ``np.unique`` sorts them, each side the rows of its groups in row order;
- grouped folds (``StratifiedGroupKFold`` with shuffle): the groups shuffled
  once, then taken in order of falling spread of their class counts, each to
  the fold whose class shares it evens most (ties to the smaller fold).
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


def group_shuffle_indices(
    groups: Sequence, *, test_size: float, random_state: int
) -> tuple[NDArray[np.int64], NDArray[np.int64]]:
    """``(train, test)`` row indices of ``GroupShuffleSplit(n_splits=1)``: ``test_size`` is a share of the groups."""
    classes, group_indices = np.unique(np.asarray(groups), return_inverse=True)
    group_train, group_test = train_test_indices(len(classes), test_size=test_size, random_state=random_state)
    return np.flatnonzero(np.isin(group_indices, group_train)), np.flatnonzero(np.isin(group_indices, group_test))


def _best_fold(y_counts_per_fold: NDArray, y_cnt: NDArray, group_y_counts: NDArray) -> int:
    best_fold = -1
    min_eval = np.inf
    min_samples_in_fold = np.inf
    for i in range(y_counts_per_fold.shape[0]):
        y_counts_per_fold[i] += group_y_counts
        std_per_class = np.std(y_counts_per_fold / y_cnt.reshape(1, -1), axis=0)
        y_counts_per_fold[i] -= group_y_counts
        fold_eval = np.mean(std_per_class)
        samples_in_fold = np.sum(y_counts_per_fold[i])
        if fold_eval < min_eval or (np.isclose(fold_eval, min_eval) and samples_in_fold < min_samples_in_fold):
            min_eval = fold_eval
            min_samples_in_fold = samples_in_fold
            best_fold = i
    return best_fold


def stratified_group_kfold_indices(
    labels: Sequence, groups: Sequence, *, n_splits: int, random_state: int
) -> list[tuple[NDArray[np.int64], NDArray[np.int64]]]:
    """``(train, test)`` row indices of each fold of ``StratifiedGroupKFold(n_splits, shuffle=True)``."""
    n_samples = len(labels)
    if n_splits > n_samples:
        raise ValueError(
            f"Cannot have number of splits n_splits={n_splits} greater than the number of samples: "
            f"n_samples={n_samples}."
        )
    rng = np.random.RandomState(random_state)
    _, y_inv, y_cnt = np.unique(np.asarray(labels), return_inverse=True, return_counts=True)
    if np.all(n_splits > y_cnt):
        raise ValueError(f"n_splits={n_splits} cannot be greater than the number of members in each class.")
    _, groups_inv, groups_cnt = np.unique(np.asarray(groups), return_inverse=True, return_counts=True)
    if n_splits > len(groups_cnt):
        raise ValueError(
            f"Cannot have number of splits n_splits={n_splits} greater than the number of groups: {len(groups_cnt)}."
        )
    y_counts_per_group = np.zeros((len(groups_cnt), len(y_cnt)))
    for class_idx, group_idx in zip(y_inv, groups_inv):
        y_counts_per_group[group_idx, class_idx] += 1
    perm = np.arange(len(groups_cnt))
    rng.shuffle(perm)
    y_counts_per_group = y_counts_per_group[perm]
    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(perm.size)
    groups_inv = inv_perm[groups_inv]
    y_counts_per_fold = np.zeros((n_splits, len(y_cnt)))
    groups_per_fold: list[set[int]] = [set() for _ in range(n_splits)]
    for group_idx in np.argsort(-np.std(y_counts_per_group, axis=1), kind="stable"):
        best = _best_fold(y_counts_per_fold, y_cnt, y_counts_per_group[group_idx])
        y_counts_per_fold[best] += y_counts_per_group[group_idx]
        groups_per_fold[best].add(group_idx)
    indices = np.arange(n_samples)
    folds = []
    for fold in groups_per_fold:
        test_mask = np.isin(groups_inv, list(fold))
        folds.append((indices[~test_mask], indices[test_mask]))
    return folds


__all__ = [
    "approximate_mode",
    "group_shuffle_indices",
    "split_sizes",
    "stratified_group_kfold_indices",
    "train_test_indices",
]
