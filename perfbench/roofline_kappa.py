"""The least time of the content model's kappa regression, from shapes
alone: the damped Newton of ``ops/mstep.py::_poisson_newton_batch``,
one chunk step of Vc words against the (R, P) kappa design.

Every term of a chunk step scales with Vc, so a regression's least time
is one word slot's least time times ``kappa.slot_steps`` (the chunk
width summed over the chunks' steps).  A slot step's operations, in
float32 outside the tensor cores (the program's entry points run with
TF32 off): the linear predictor X w and the gradient Xᵀ(λ - y)/n; the
Hessian's P(P+1)/2 distinct entries, 2R operations each; its Cholesky,
P³/3; the two triangular solves, 2P²; the 6-point line search's X (w +
t d); the full step's decrease, X d.  Bytes: the word's counts y, its
intercept and w read once, w and its objective and done flag written
once.  Peaks and the rule are ``roofline.py``'s.
"""

from __future__ import annotations

from perfbench import roofline

LINE_SEARCH = 6  # step sizes 1 ... 1/32


def slot_step(R: int, P: int, T: int = LINE_SEARCH):
    """(bytes, ops) of one word slot's Newton step."""
    ops = (2 * R * P  # z = m + offset + X w
           + 2 * R * P  # g = X^T (lam - y) / n + alpha w
           + R * P * (P + 1)  # H's distinct entries
           + P ** 3 // 3  # Cholesky
           + 2 * P * P  # forward and back substitution
           + 2 * T * R * P  # the candidates' X (w + t d)
           + 2 * R * P)  # the full step's decrease: X d
    n_bytes = roofline.F32 * (R + 1 + P + P + 1 + 1)
    return n_bytes, {"f32": ops}


def least_s(R: int, P: int, slot_steps: int) -> float:
    """Least seconds of ``slot_steps`` slot steps."""
    return slot_steps * roofline.least_s(*slot_step(R, P))[0]
