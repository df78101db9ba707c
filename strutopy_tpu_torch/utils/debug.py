"""Debug-mode numerical sanitizers (twin of ``strutopy_tpu/utils/debug.py``).

Host-side validations of an EM iteration's outputs, run per iteration
when ``STMConfig.debug_checks`` is on: beta non-negative, finite and
row-normalized; theta finite and on the simplex; sigma finite, symmetric
and positive semi-definite; the bound finite.  Same checks, thresholds
and messages as the JAX package's.
"""

from __future__ import annotations

import numpy as np


class NumericalCheckError(AssertionError):
    pass


def validate_state(state, iteration: int) -> None:
    """Host-side checks of an STMState after an EM iteration."""
    beta = state.beta.cpu().numpy()
    theta = state.theta.cpu().numpy()
    sigma = state.sigma.cpu().numpy()
    bound = float(state.bound)

    if not np.all(beta >= 0):
        raise NumericalCheckError(
            f"iter {iteration}: beta has negative entries (min {beta.min()})"
        )
    if not np.all(np.isfinite(beta)):
        raise NumericalCheckError(f"iter {iteration}: beta has non-finite entries")
    row_sums = beta.sum(axis=-1)
    if not np.allclose(row_sums[row_sums > 0], 1.0, atol=1e-3):
        raise NumericalCheckError(
            f"iter {iteration}: beta rows do not sum to 1 (range "
            f"{row_sums.min()}..{row_sums.max()})"
        )
    if not np.all(np.isfinite(theta)):
        raise NumericalCheckError(f"iter {iteration}: theta has non-finite entries")
    if not np.allclose(theta.sum(axis=1), 1.0, atol=1e-3):
        raise NumericalCheckError(f"iter {iteration}: theta rows do not sum to 1")
    if not np.all(np.isfinite(sigma)):
        raise NumericalCheckError(f"iter {iteration}: sigma has non-finite entries")
    if not np.allclose(sigma, sigma.T, atol=1e-4):
        raise NumericalCheckError(f"iter {iteration}: sigma is not symmetric")
    eig = np.linalg.eigvalsh(sigma)
    if eig.min() < -1e-4:
        raise NumericalCheckError(
            f"iter {iteration}: sigma has negative eigenvalue {eig.min()}"
        )
    if not np.isfinite(bound):
        raise NumericalCheckError(f"iter {iteration}: bound is {bound}")
