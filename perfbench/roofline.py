"""The least time of the Newton stage kernels' work, from shapes alone: a
frozen copy of ``chip_smoke.py``'s ``roofline``, ``hessian_ops``,
``stage_bounds`` and ``step_ops`` arithmetic, per call.

Peaks are NVIDIA's published ones for one H100 SXM at its 700 W limit
(dense): 3.35 TB/s of device memory, 989 TFLOP/s in bf16 on the tensor
cores, 67 TFLOP/s in float32 outside them.  Bytes count each input read
once and each output written once; the kernels compute every document
of their chunk at every step (done documents included), so the whole
chunk counts.
"""

from __future__ import annotations

PEAK_BYTES = 3.35e12
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}
F32 = 4


def least_s(n_bytes: float, ops: dict):
    """(least seconds, "bytes" or "operations"): the larger of the bytes
    over the memory rate and the operations over their types' peaks."""
    t_bytes = n_bytes / PEAK_BYTES
    t_ops = sum(n / PEAK_OPS[kind] for kind, n in ops.items())
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def hessian_ops(K: int, L: int) -> int:
    """One document's B·Bᵀ: H's (K-1)K/2 distinct entries, 2L operations
    each."""
    return 2 * ((K - 1) * K // 2) * L


def fgh(B: int, K: int, L: int, beta_bytes: int = F32, bf16: bool = True):
    """(bytes, ops) of one f/g/H call: eta, beta_doc, counts, mu, siginv
    read; f, g, H written; B·Bᵀ in bf16 (float32 without ``bf16``), s,
    phi and its operand ~6KL in float32 a document."""
    Km1 = K - 1
    n_bytes = (B * (Km1 * F32 + K * L * beta_bytes + L * F32 + Km1 * F32) + Km1 * Km1 * F32
               + F32 * B * (1 + Km1 + Km1 * Km1))
    hess = {"bf16" if bf16 else "f32": B * hessian_ops(K, L)}
    return n_bytes, _add(hess, {"f32": 6 * B * K * L})


def cg(B: int, Km1: int, iters: int):
    """(bytes, ops) of one CG call: H and g read, the direction written;
    2(K-1)² operations a step."""
    return (F32 * (B * Km1 * Km1 + B * Km1) + F32 * B * Km1,
            {"f32": 2 * B * iters * Km1 * Km1})


def ls(B: int, K: int, L: int, T: int, beta_bytes: int = F32):
    """(bytes, ops) of one Armijo sweep: eta, p, the T step sizes,
    beta_doc, counts, mu, siginv read; T objectives a document written;
    T mixtures (2TKL) and prior terms (2T(K-1)²) in float32."""
    Km1 = K - 1
    n_bytes = (F32 * (2 * B * Km1 + T + B * L + B * Km1 + Km1 * Km1) + B * K * L * beta_bytes
               + F32 * B * T)
    return n_bytes, {"f32": 2 * B * T * (K * L + Km1 * Km1)}


def finalize_ops(B: int, K: int, L: int) -> dict:
    """Operations of one finalize call: each document's float32 Hessian
    (its B·Bᵀ and ~6KL) and its (K-1)³/3 Cholesky."""
    return {"f32": B * (hessian_ops(K, L) + 6 * K * L + (K - 1) ** 3 // 3)}


def _add(a: dict, b: dict) -> dict:
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0) + v
    return out


def _beta_bytes(dtype: str) -> int:
    return 2 if "bfloat16" in dtype else F32


def call_cost(name: str, args: list, kwargs: dict):
    """(bytes, ops) of one recorded call (``trace.recorded_calls``'s
    entry) of ``fgh``, ``cg``, ``linesearch`` or ``_finalize_chunk``;
    bytes 0 for the finalize, whose operations alone are counted."""
    if name == "fgh":
        (B, K, L), dt = args[1]
        return fgh(B, K, L, _beta_bytes(dt), bool(kwargs.get("bf16", True)))
    if name == "cg":
        (B, Km1, _), _dt = args[0]
        return cg(B, Km1, int(args[2]))
    if name == "linesearch":
        (T,), _ = args[2]
        (B, K, L), dt = args[3]
        return ls(B, K, L, T, _beta_bytes(dt))
    if name == "_finalize_chunk":
        (B, K, L), _ = args[1]
        return 0, finalize_ops(B, K, L)
    raise ValueError(f"no cost for {name}")


def total(calls: list, names) -> tuple:
    """(least seconds summed over the calls named, their ops by type)."""
    secs, ops = 0.0, {}
    for name, args, kw in calls:
        if name in names:
            b, o = call_cost(name, args, kw)
            secs += least_s(b, o)[0]
            ops = _add(ops, o)
    return secs, ops


def compute_s(ops: dict) -> float:
    """Least compute time of ``ops`` at the peaks."""
    return sum(n / PEAK_OPS[k] for k, n in ops.items())
