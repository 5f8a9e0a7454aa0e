"""Damped normal-equation (ICCV) solver for the inverse-RPC fit.

Counterpart of `satmvs_tpu/geo/solver.py`.  Host-side numpy float64: it runs
once per camera while data is prepared.  The iteration solves
(AᵀA + kI) x_{t+1} = Aᵀl + k x_t, which converges to the normal-equation
solution while each linear solve stays well conditioned.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as sla


def solve_iccv(ata: np.ndarray, atl: np.ndarray, damping: float = 1.0,
               tol: float = 1e-10, max_iter: int = 1000) -> tuple[np.ndarray, int]:
    """Returns (x, iterations) for the damped normal equations."""
    ata = np.asarray(ata, dtype=np.float64)
    atl = np.asarray(atl, dtype=np.float64)
    n = ata.shape[0]
    if ata.shape != (n, n):
        raise ValueError(f"normal matrix must be square, got {ata.shape}")

    # the damped matrix is constant across iterations: factor it once
    lu_piv = sla.lu_factor(ata + damping * np.eye(n))
    x = np.zeros(n, dtype=np.float64)
    rhs = atl.copy()
    iterations = 0
    for iterations in range(1, max_iter + 1):
        x_next = sla.lu_solve(lu_piv, rhs)
        if np.max(np.abs(x_next - x)) < tol:
            x = x_next
            break
        x = x_next
        rhs = atl + damping * x
    return x, iterations
