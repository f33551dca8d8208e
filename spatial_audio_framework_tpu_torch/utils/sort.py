"""Sorting & grid-search helpers (counterpart of
``spatial_audio_framework_tpu/utils/sort.py``, ``saf_utility_sort``):
host numpy, the port's own copy."""
from __future__ import annotations

import numpy as np


def sort_with_indices(x, descending: bool = False):
    """sortf/sorti/sortd equivalents: returns (sorted, indices)."""
    idx = np.argsort(x, kind="stable")
    if descending:
        idx = idx[::-1]
    return np.asarray(x)[idx], idx


def sortc(x, descending: bool = False):
    """Sort complex values (sortc): by real part, then imaginary."""
    x = np.asarray(x)
    idx = np.lexsort((x.imag, x.real))
    if descending:
        idx = idx[::-1]
    return x[idx], idx


def cmplx_pair_up(x):
    """Pair up conjugate pairs, reals last (cmplxPairUp)."""
    from spatial_audio_framework_tpu_torch.utils.misc import sort_cmplx_pairs

    return sort_cmplx_pairs(x)


def find_closest_grid_points(grid_dirs_rad: np.ndarray,
                             target_dirs_rad: np.ndarray):
    """k-NN on the sphere (saf_utility_sort.h ``findClosestGridPoints``):
    both args (N, 2) [azi, elev] radians → indices (nTargets,)."""
    def u(d):
        return np.stack([np.cos(d[:, 1]) * np.cos(d[:, 0]),
                         np.cos(d[:, 1]) * np.sin(d[:, 0]),
                         np.sin(d[:, 1])], -1)

    sim = u(np.atleast_2d(target_dirs_rad)) @ u(np.atleast_2d(grid_dirs_rad)).T
    return np.argmax(sim, axis=-1)
