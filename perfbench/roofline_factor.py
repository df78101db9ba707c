"""The least time of the finalize's factor F (``csrc/factor.cu``,
``stages.chol_pd_inverse``) from shapes alone: for each document the
PD-repair ladder's Cholesky of its Hessian H (P, P) and nu = (L Lᵀ)⁻¹.

Bytes: H read once, L and nu written once (3 P² floats a document).
Operations: P³ float32 a document (P³/3 for the factor, P³/3 for L⁻¹ and
P³/3 for L⁻ᵀL⁻¹), outside the tensor cores.  Peaks and the rule are
``roofline.py``'s: at P=99, B=256 that is 30 MB (9.0 µs at 3.35 TB/s)
against 0.25 GFLOP (3.7 µs at 67 TFLOP/s), so bytes bound it; at P=399
the operations do.
"""

from __future__ import annotations

from perfbench import roofline


def cost(B: int, P: int):
    """(bytes, ops) of one factor call on B documents of P free topics."""
    return roofline.F32 * 3 * B * P * P, {"f32": B * P ** 3}


def least_s(B: int, P: int) -> float:
    """Least seconds of one call on B documents (linear in B)."""
    return roofline.least_s(*cost(B, P))[0]
