"""GroupKFold splitting matching sklearn's deterministic assignment (the JAX
package's ``calib/groupkfold.py``, copied).

The temperature trainers select polynomial degree by GroupKFold CV grouped
by temperature (``temperature_color_model.py:344-369``).  sklearn assigns
groups to folds greedily: groups sorted by decreasing sample count, each
placed into the currently lightest fold.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def group_kfold_indices(groups: np.ndarray, n_splits: int) -> np.ndarray:
    """Fold id per sample, reproducing sklearn.GroupKFold."""
    groups = np.asarray(groups)
    unique_groups, group_idx = np.unique(groups, return_inverse=True)
    n_groups = len(unique_groups)
    if n_splits > n_groups:
        raise ValueError("n_splits greater than number of groups")
    n_samples_per_group = np.bincount(group_idx)
    # sort groups by number of samples, descending (stable)
    indices = np.argsort(n_samples_per_group, kind="mergesort")[::-1]
    n_samples_per_group = n_samples_per_group[indices]
    n_samples_per_fold = np.zeros(n_splits)
    group_to_fold = np.zeros(n_groups, dtype=int)
    for group_index, weight in enumerate(n_samples_per_group):
        lightest_fold = np.argmin(n_samples_per_fold)
        n_samples_per_fold[lightest_fold] += weight
        group_to_fold[indices[group_index]] = lightest_fold
    return group_to_fold[group_idx]


def group_kfold_split(X, y, groups, n_splits: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    folds = group_kfold_indices(np.asarray(groups), n_splits)
    for f in range(n_splits):
        te = np.where(folds == f)[0]
        tr = np.where(folds != f)[0]
        yield tr, te
