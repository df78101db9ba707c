"""The damped-Newton iteration of the E-step, the beta row gather, the
ordered phi scatter and the finalize.

Each function has a plain PyTorch version and a CUDA kernel
(``csrc/stages.cu``, ``csrc/newton.cu``, ``csrc/scatter.cu``,
``csrc/factor.cu``), with the same signature:

  ===========  ==============================  ==========================================
  function     plain version                   kernel wrapper (launch counter)
  ===========  ==============================  ==========================================
  f, g, H      :func:`fgh_plain`               :func:`fgh` (``LAUNCHES["fgh"]``)
  CG           :func:`cg_plain`                :func:`cg` (``LAUNCHES["cg"]``)
  Armijo       :func:`linesearch_plain`        :func:`linesearch` (``"ls"``)
  direction    :func:`newton_direction_plain`  :func:`newton_direction` (``"direction"``)
  step choice  :func:`newton_accept_plain`     :func:`newton_accept` (``"accept"``)
  iteration    :func:`newton_iter_plain`       :func:`newton_iter` (``"iter"``)
  Newton loop  :func:`newton_loop_plain`       :func:`newton_loop` (``"newton"``)
  row gather   :func:`gather_rows_plain`       :func:`gather_rows` (``"gather"``)
  phi scatter  :func:`scatter_phi_plain`       :func:`scatter_phi` (``"scatter"``)
  factor, nu   :func:`chol_pd_inverse_plain`   :func:`chol_pd_inverse` (``"factor"``)
  finalize     :func:`finalize_terms_plain`    :func:`finalize_terms` (``"finalize"``)
  its bound    :func:`finalize_bound_plain`    :func:`finalize_bound` (``"finalize_bound"``)
  ===========  ==============================  ==========================================

:func:`stage_step` is the default Newton iteration: the three stage
kernels and, between and after them, the two glue kernels that do what
:func:`newton_iter_plain` does around its stages (the direction's
fallback, the step choice, the flags and the chunk's "all done").

A wrapper given CPU tensors runs the plain version; given CUDA tensors
it launches the kernel or raises.  There is no fallback from one to the
other.  Every wrapper launches through :func:`_launch`, on the stream
current at the call; each launch adds one to its counter, so a run can
show that its main path went through the kernels.  Where a kernel has two
plans by size, its wrapper counts the documents of each launch under the
plan the C side chose, in the open trace record (``plan.cg.*``,
``plan.factor.*``, ``plan.finalize.*``; nothing on CPU tensors or while
recording is off).

:func:`fgh`, :func:`linesearch` and :func:`newton_iter` take beta_doc as
float32 or bfloat16 (the Newton search under ``STMConfig.newton_bf16_beta``;
``bf16`` everywhere else means the Hessian operand).  A bf16 beta_doc
launches the kernel's bf16-input mode and counts under its own name
(``"fgh_bf16_beta"``, ``"ls_bf16_beta"``, ``"iter_bf16_beta"``); the plain
versions upcast it once, which is exactly the JAX promotion, so either
mode computes the float32 function of the rounded beta_doc.

The plain versions carry the math of ``strutopy_tpu/ops/estep.py``'s
``_f_g_H_batched``, ``_f_multi`` and of the Pallas ``_cg_kernel``; the
finalize's plain version reuses :func:`f_g_H_batched` at float32 for the
model quantities, and its kernel B1's body in float32 (``_finalize_chunk``
runs :func:`finalize_terms`, :func:`chol_pd_inverse` and
:func:`finalize_bound`, three launches a chunk on the card).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from strutopy_tpu_torch.ops import build
from strutopy_tpu_torch.ops.linalg import cholesky_checked, make_pd
from strutopy_tpu_torch.utils import trace

LAUNCHES = {"fgh": 0, "cg": 0, "ls": 0, "iter": 0, "newton": 0, "gather": 0, "scatter": 0,
            "fgh_bf16_beta": 0, "ls_bf16_beta": 0, "iter_bf16_beta": 0, "direction": 0,
            "accept": 0, "factor": 0, "finalize": 0, "finalize_bound": 0}
BETA_DTYPES = (torch.float32, torch.bfloat16)  # the beta_doc fgh, ls and iter take


# ---------------------------------------------------------------------------
# plain PyTorch math
# ---------------------------------------------------------------------------


def pad_eta(eta: torch.Tensor) -> torch.Tensor:
    """(B, K-1) -> (B, K) with the pinned last coordinate."""
    return torch.cat([eta, eta.new_zeros(eta.shape[0], 1)], dim=1)


def _beta_f32(beta_doc: torch.Tensor) -> torch.Tensor:
    """A bf16 beta_doc upcast (exact); any other returned as it is.
    ``torch.bmm`` takes no mixed dtypes, and the upcast is what JAX's
    promotion of bf16 against float32 does."""
    return beta_doc.float() if beta_doc.dtype == torch.bfloat16 else beta_doc


def _bf16_round(x: torch.Tensor) -> torch.Tensor:
    # round the operand and multiply in float32: on the CPU a bf16
    # matmul would also return bf16, which the JAX code never does
    return x.to(torch.bfloat16).to(torch.float32)


def f_g_H_batched(eta, beta_doc, counts, mu, siginv, Nd, bf16: bool):
    """Objective, gradient, Hessian for a chunk of documents (twin of
    ``strutopy_tpu/ops/estep.py::_f_g_H_batched``).

    eta/mu (B, K-1); beta_doc (B, K, L), float32 or bf16; counts (B, L);
    Nd (B,).  Returns (f (B,), g (B, K-1), H (B, K-1, K-1), theta (B, K),
    phi_hat (B, K, L)).  With ``bf16`` the B·Bᵀ operand is rounded to
    bfloat16 and the product accumulates in float32.
    """
    beta_doc = _beta_f32(beta_doc)
    K = beta_doc.shape[1]
    eta_full = pad_eta(eta)
    m = torch.amax(eta_full, dim=1, keepdim=True)
    e = torch.exp(eta_full - m)
    sum_e = torch.sum(e, dim=1, keepdim=True)
    theta = e / sum_e

    a = e[:, :, None] * beta_doc
    s = torch.sum(a, dim=1)
    s_safe = torch.clamp_min(s, 1e-35)
    cmask = counts > 0
    ll = torch.sum(torch.where(cmask, counts * (torch.log(s_safe) + m), 0.0), dim=1)
    lse = (m + torch.log(sum_e))[:, 0]
    diff = eta - mu
    sdiff = diff @ siginv
    f = 0.5 * torch.sum(diff * sdiff, dim=1) - ll + Nd * lse

    phi_hat = a / s_safe[:, None, :]
    phi_hat = torch.where(cmask[:, None, :], phi_hat, 0.0)
    q = torch.sum(phi_hat * counts[:, None, :], dim=2)
    g_full = Nd[:, None] * theta - q
    g = sdiff + g_full[:, :-1]

    # H = B Bᵀ - Nd θθᵀ + diag(Nd θ - q) + Σ⁻¹ on the free coordinates
    Bmat = phi_hat * torch.sqrt(torch.clamp_min(counts, 0.0))[:, None, :]
    if bf16:
        Bmat = _bf16_round(Bmat)
    Hll = torch.bmm(Bmat, Bmat.transpose(1, 2))
    Hll = Hll - (Nd[:, None, None] * theta[:, :, None]) * theta[:, None, :]
    Hll = Hll + torch.diag_embed(g_full)
    H = Hll[:, : K - 1, : K - 1] + siginv[None]
    return f, g, H, theta, phi_hat


def linesearch_plain(eta, p, ts, beta_doc, counts, mu, siginv):
    """Plain version of :func:`linesearch`: f(eta + t p) for all T step
    sizes at once -> (B, T) (twin of ``strutopy_tpu/ops/estep.py::_f_multi``)."""
    beta_doc = _beta_f32(beta_doc)
    Nd = torch.sum(counts, dim=1)
    cand = eta[:, None, :] + ts[None, :, None] * p[:, None, :]
    B, T, P = cand.shape
    cand_full = torch.cat([cand, cand.new_zeros(B, T, 1)], dim=2)
    m = torch.amax(cand_full, dim=2, keepdim=True)
    e = torch.exp(cand_full - m)
    s = torch.clamp_min(torch.bmm(e, beta_doc), 1e-35)
    cmask = counts > 0
    ll = torch.sum(
        torch.where(cmask[:, None, :], counts[:, None, :] * (torch.log(s) + m), 0.0),
        dim=2,
    )
    lse = m[:, :, 0] + torch.log(torch.sum(e, dim=2))
    diff = cand - mu[:, None, :]
    dsig = (diff.reshape(B * T, P) @ siginv).reshape(B, T, P)
    quad = 0.5 * torch.sum(diff * dsig, dim=2)
    return quad - ll + Nd[:, None] * lse


def cg_plain(H, g, iters: int, bf16: bool):
    """Plain version of :func:`cg`: Jacobi-preconditioned Steihaug CG
    for H x = -g, ``iters`` steps.

    Twin of ``strutopy_tpu/ops/pallas_stages.py::_cg_kernel``: with
    ``bf16`` the Hessian is rounded to bfloat16 and the search vector p
    stays float32.  (The XLA path ``estep._cg_batched`` also rounds p;
    the port follows the kernel it ports.)  Each document freezes at its
    first direction with pᵀHp <= 1e-30.
    """
    dinv = 1.0 / torch.clamp_min(torch.abs(torch.diagonal(H, dim1=1, dim2=2)), 1e-20)
    Hm = _bf16_round(H) if bf16 else H
    r = -g
    z = dinv * r
    p = z
    rz = torch.sum(r * z, dim=1)
    x = torch.zeros_like(g)
    active = torch.ones(g.shape[0], dtype=torch.bool, device=g.device)
    for _ in range(iters):
        Ap = torch.bmm(p[:, None, :], Hm)[:, 0]
        pAp = torch.sum(p * Ap, dim=1)
        pos = pAp > 1e-30
        active = active & pos
        alpha = rz / torch.where(pos, pAp, 1.0)
        am = active[:, None]
        x = torch.where(am, x + alpha[:, None] * p, x)
        r = torch.where(am, r - alpha[:, None] * Ap, r)
        z = dinv * r
        rz_new = torch.sum(r * z, dim=1)
        beta = rz_new / torch.clamp_min(rz, 1e-30)
        p = torch.where(am, z + beta[:, None] * p, p)
        rz = torch.where(active, rz_new, rz)
    return x


def fgh_plain(eta, beta_doc, counts, mu, siginv, bf16: bool):
    """Plain version of :func:`fgh`: (f (B,), g (B, K-1), H (B, K-1, K-1))."""
    f, g, H, _, _ = f_g_H_batched(
        eta, beta_doc, counts, mu, siginv, torch.sum(counts, dim=1), bf16)
    return f, g, H


def newton_direction_plain(g, x, grad_tol: float):
    """Plain version of :func:`newton_direction`: (p, gTp, conv).  conv is
    max|g| <= grad_tol (a NaN in g is not converged); p is CG's x where it
    descends (gᵀx < 0), else -g, with gTp = gᵀp."""
    conv = torch.amax(torch.abs(g), dim=1) <= grad_tol
    gTp = torch.sum(g * x, dim=1)
    bad = gTp >= 0
    p = torch.where(bad[:, None], -g, x)
    gTp = torch.where(bad, -torch.sum(g * g, dim=1), gTp)
    return p, gTp, conv


def newton_accept_plain(eta, p, fs, f, gTp, ts, done, conv, n_iters=None):
    """Plain version of :func:`newton_accept`: (eta, done, advance, any_ok,
    all_done).  The parallel Armijo sweep's first (largest) passing step
    size moves each document that advances (not done, not converged);
    done takes conv and the documents where no step size passes; n_iters,
    when given, adds advance in place; all_done is torch.all(done)."""
    ok = fs <= f[:, None] + 1e-4 * ts[None, :] * gTp[:, None]
    any_ok = torch.any(ok, dim=1)
    t = torch.amax(torch.where(ok, ts[None, :], 0.0), dim=1)
    advance = ~done & ~conv
    step = advance & any_ok
    eta = torch.where(step[:, None], eta + t[:, None] * p, eta)
    done = done | conv | ~any_ok
    if n_iters is not None:
        n_iters += advance.to(torch.int32)
    return eta, done, advance, any_ok, torch.all(done)


def _step(fgh_fn, cg_fn, ls_fn, direction_fn, accept_fn, eta, beta_doc, counts, mu, siginv, ts,
          done, n_iters, grad_tol: float, cg_iters: int, bf16: bool):
    """One damped-Newton iteration of a chunk on the given stage and glue
    functions (the body of ``strutopy_tpu/ops/estep.py::_batched_newton``):
    (eta, done, advance, all_done), n_iters (or None) advanced in place.

    Done documents keep their eta; a document advances unless it was done
    or has converged (max|g| <= grad_tol), and is done after a step when
    no step size passes the Armijo test.  Inside ``trace.recording()``, a
    document that advances with no step size passing counts in
    ``newton.stalled``.
    """
    f, g, H = fgh_fn(eta, beta_doc, counts, mu, siginv, bf16=bf16)
    x = cg_fn(H, g, cg_iters, bf16=bf16)
    p, gTp, conv = direction_fn(g, x, grad_tol)
    # parallel Armijo sweep: the first (largest) acceptable step
    fs = ls_fn(eta, p, ts, beta_doc, counts, mu, siginv)
    eta, done, advance, any_ok, all_done = accept_fn(eta, p, fs, f, gTp, ts, done, conv,
                                                     n_iters)
    if trace.full():
        trace.count("newton.stalled", advance, any_ok, op=torch.gt)
    return eta, done, advance, all_done


def newton_iter_plain(eta, beta_doc, counts, mu, siginv, ts, done, grad_tol: float,
                      cg_iters: int, bf16: bool = True):
    """Plain version of :func:`newton_iter`: the step on the plain stages
    and the plain glue, (eta, done, advance)."""
    beta_doc = _beta_f32(beta_doc)
    return _step(fgh_plain, cg_plain, linesearch_plain, newton_direction_plain,
                 newton_accept_plain, eta, beta_doc, counts, mu, siginv, ts, done, None,
                 grad_tol, cg_iters, bf16)[:3]


def stage_step(eta, beta_doc, counts, mu, siginv, ts, done, n_iters, grad_tol: float,
               cg_iters: int, bf16: bool = True):
    """One Newton iteration on the stage kernels (:func:`fgh`, :func:`cg`,
    :func:`linesearch`) and the two glue kernels (:func:`newton_direction`,
    :func:`newton_accept`): five launches, no host sync; the default path.
    Returns (eta, done, advance, all_done), all_done a 0-dim bool tensor on
    the device; ``n_iters`` (int32 (B,), or None) adds advance in place.
    On CPU tensors it is :func:`newton_iter_plain` with those two extras."""
    return _step(fgh, cg, linesearch, newton_direction, newton_accept, eta, beta_doc, counts,
                 mu, siginv, ts, done, n_iters, grad_tol, cg_iters, bf16)


def newton_loop_plain(beta_doc, counts, mu, eta0, siginv, ts, max_iters: int,
                      grad_tol: float, cg_iters: int, bf16: bool = True):
    """Plain version of :func:`newton_loop`: :func:`newton_iter_plain` from
    ``eta0`` until every document is done or ``max_iters`` iterations ran.
    Returns (eta (B, K-1), n_iters (B,) int32), n_iters counting advances."""
    eta = eta0
    done = torch.zeros(eta0.shape[0], dtype=torch.bool, device=eta0.device)
    n_iters = torch.zeros(eta0.shape[0], dtype=torch.int32, device=eta0.device)
    for _ in range(max_iters):
        if bool(torch.all(done)):
            break
        eta, done, advance = newton_iter_plain(eta, beta_doc, counts, mu, siginv, ts, done,
                                               grad_tol, cg_iters, bf16)
        n_iters = n_iters + advance.to(torch.int32)
    return eta, n_iters


def gather_rows_plain(beta_T, words):
    """Plain version of :func:`gather_rows`: beta_T[words] -> (B, L, K)."""
    B, L = words.shape
    return torch.index_select(beta_T, 0, words.reshape(-1).long()).reshape(B, L, -1)


class ScatterPlan(NamedTuple):
    """The order of an ordered scatter (:func:`scatter_plan`): key j's
    entries are ``perm[offsets[j]:offsets[j + 1]]``, in ascending flat
    position; the entries left out sit after ``offsets[-1]``."""

    perm: torch.Tensor  # (n_entries,) int32, every flat position once
    offsets: torch.Tensor  # (n_keys + 1,) int32, non-decreasing


def scatter_plan(keys: torch.Tensor, live: Optional[torch.Tensor], n_keys: int) -> ScatterPlan:
    """The plan of a scatter of ``keys`` (any shape, flattened in row-major
    order: the flat position) into ``n_keys`` keys: a stable sort of the
    keys, and every key's first place in it by ``searchsorted``.  Fixed
    shapes and no host sync, on the device of ``keys``.  Entries outside
    ``live`` (a bool mask of ``keys``' shape, or None for all) and keys
    outside ``[0, n_keys)`` are left out, as the XLA scatter drops an index
    out of range."""
    k = keys.reshape(-1).to(torch.int32)
    if live is not None:
        k = torch.where(live.reshape(-1), k, n_keys)
    sorted_k, perm = torch.sort(k, stable=True)
    first = torch.arange(n_keys + 1, dtype=torch.int32, device=k.device)
    offsets = torch.searchsorted(sorted_k, first, out_int32=True)
    return ScatterPlan(perm.to(torch.int32), offsets)


def scatter_phi_plain(beta_ss, phi, plan: ScatterPlan, V: int):
    """Plain version of :func:`scatter_phi`, in the kernel's order: each
    touched key's column of ``beta_ss`` takes its entries' rows one at a
    time in the plan's order, one vectorized add a segment depth (in place,
    returned)."""
    n_keys, K = plan.offsets.shape[0] - 1, phi.shape[1]
    start = plan.offsets[:-1].long()
    depth = plan.offsets[1:].long() - start
    perm = plan.perm.long()
    hit = torch.nonzero(depth > 0).squeeze(1)
    cols = beta_ss.view(-1, K, V)
    acc = torch.zeros(n_keys, K, dtype=phi.dtype, device=phi.device)
    acc[hit] = cols[hit // V, :, hit % V]
    for d in range(int(depth.max()) if n_keys else 0):
        keys = torch.nonzero(depth > d).squeeze(1)
        acc[keys] += phi[perm[start[keys] + d]]
    cols[hit // V, :, hit % V] = acc[hit]
    return beta_ss


def chol_pd_plain(H, jitter: float = 1e-5, rel_jitter: float = 1e-3):
    """Batched PD-repair Cholesky ladder -> (L, rung (B,) int8).

    Rungs: 1 the raw factor, 2 the make_pd repair, 3 the repair plus a
    fixed ``jitter``, 4 the repair plus ``rel_jitter`` x max|H| (the
    JAX package's scale-aware terminal rung).  A rung is taken when its
    factorization reports ``info == 0`` with a finite factor, which is
    the JAX ladder's ``isfinite`` test: ``cholesky_ex`` may leave finite
    garbage behind a failure.  A document that fails all four rungs gets
    a NaN factor, as in JAX.  The repair rungs run only when some
    document fails rung 1 (one host sync, the JAX ``lax.cond``; counted
    while recording, with the chunks that ran them).
    """
    B, P, _ = H.shape
    L1, ok1 = cholesky_checked(H)
    rung = torch.ones(B, dtype=torch.int8, device=H.device)
    if trace.read("finalize.rung", bool, torch.all(ok1)):
        trace.count("finalize.repair_chunks", 0)
        return L1, rung
    trace.count("finalize.repair_chunks", 1)
    eye = torch.eye(P, dtype=H.dtype, device=H.device)[None]
    H2 = make_pd(H)
    L2, ok2 = cholesky_checked(H2)
    L3, ok3 = cholesky_checked(H2 + jitter * eye)
    j4 = rel_jitter * torch.amax(torch.abs(H2), dim=(1, 2))
    L4, ok4 = cholesky_checked(H2 + j4[:, None, None] * eye)
    L4 = torch.where(ok4[:, None, None], L4, float("nan"))
    fixed = torch.where(ok2[:, None, None], L2, torch.where(ok3[:, None, None], L3, L4))
    L = torch.where(ok1[:, None, None], L1, fixed)
    rung = torch.where(ok1, 1, torch.where(ok2, 2, torch.where(ok3, 3, 4))).to(torch.int8)
    return L, rung


def chol_pd_inverse_plain(H, inverse: bool = True, jitter: float = 1e-5,
                          rel_jitter: float = 1e-3):
    """Plain version of :func:`chol_pd_inverse`: :func:`chol_pd_plain`, then
    ``torch.cholesky_inverse`` (a host sync on the card: its info array is
    read back).  nu is None unless ``inverse``."""
    L, rung = chol_pd_plain(H, jitter, rel_jitter)
    nu = trace.read("finalize.cholesky_inverse", torch.cholesky_inverse, L) if inverse else None
    return L, nu, rung


def _repaired(top_rung):
    """The chunks whose highest rung is above 1 (``finalize.repair_chunks``)."""
    return top_rung > 1


def finalize_terms_plain(eta, beta_doc, counts, mu, doc_w, siginv, Nd):
    """Plain version of :func:`finalize_terms`: :func:`f_g_H_batched` in
    float32, then the bound's terms at theta and the weighted phi (the
    reference's lower_bound; twin of ``strutopy_tpu/ops/estep.py::
    _finalize_chunk`` up to its factor).  Returns (g (B, K-1), H (B, K-1,
    K-1), theta (B, K), phi (B, K, L) with (B, L, K) memory, terms (B, 2)):
    phi = phi_hat · counts · doc_w, terms = (loglik, quad) with loglik =
    Σ_l c_l (log t_l + m) at the mixture t_l = Σ_k θ_k e_k β_kl and quad =
    ½ (eta-mu)ᵀ Σ⁻¹ (eta-mu)."""
    _f, g, H, theta, phi_hat = f_g_H_batched(eta, beta_doc, counts, mu, siginv, Nd, bf16=False)
    eta_full = pad_eta(eta)
    m = torch.amax(eta_full, dim=1, keepdim=True)
    e = torch.exp(eta_full - m)
    t_l = torch.bmm((theta * e)[:, None, :], beta_doc)[:, 0]
    t_l = torch.clamp_min(t_l, 1e-35)
    cmask = counts > 0
    loglik = torch.sum(torch.where(cmask, counts * (torch.log(t_l) + m), 0.0), dim=1)
    diff = eta - mu
    quad = 0.5 * torch.sum((diff @ siginv) * diff, dim=1)
    # phi (B, K, L) laid out entry-major, (B, L, K) in memory: the rows the
    # ordered scatter reads (one slot's K values contiguous)
    B, K, L = phi_hat.shape
    phi = torch.empty(B, L, K, dtype=phi_hat.dtype, device=phi_hat.device).transpose(1, 2)
    torch.mul(phi_hat, counts[:, None, :], out=phi)
    phi.mul_(doc_w[:, None, None])
    return g, H, theta, phi, torch.stack((loglik, quad), dim=1)


def finalize_bound_plain(L, nu, terms, sigmaentropy, doc_w):
    """Plain version of :func:`finalize_bound`: (doc_w · nu, doc_w · bound)
    with bound = loglik + det - quad - sigmaentropy, det = -Σ log diag L."""
    det = -torch.sum(torch.log(torch.diagonal(L, dim1=1, dim2=2)), dim=1)
    bound = terms[:, 0] + det - terms[:, 1] - sigmaentropy
    return doc_w[:, None, None] * nu, doc_w * bound


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _use_plain(name: str, *tensors: torch.Tensor, dtypes=None) -> bool:
    """True for CPU inputs; False for CUDA inputs that the kernel takes.

    Raises on any other device, on mixed devices, and on CUDA inputs
    that are not contiguous or not of their dtype (``dtypes``, one per
    tensor, a dtype or a tuple of the dtypes taken; float32 by default).
    """
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: inputs on several devices")
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    for t, dt in zip(tensors, dtypes or [torch.float32] * len(tensors)):
        if t.dtype not in (dt if isinstance(dt, tuple) else (dt,)) or not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous {dt}, got "
                             f"{t.dtype} contiguous={t.is_contiguous()}")
    return False


def _beta_mode(name: str, beta_doc: torch.Tensor):
    """(beta_bf16 flag for the C entry point, the launch counter's key)."""
    bf = beta_doc.dtype == torch.bfloat16
    return int(bf), f"{name}_bf16_beta" if bf else name


def _expect(name: str, **shapes) -> None:
    for arg, (t, shape) in shapes.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def _check_steps(name: str, T: int) -> None:
    if not 1 <= T <= 16:
        raise ValueError(f"{name}: the kernel takes 1 to 16 step sizes, got {T}")


def _on(index: int):
    """The guard that makes CUDA device ``index`` current for a call; none
    where it already is."""
    if torch.cuda.current_device() == index:
        return contextlib.nullcontext()
    return torch.cuda.device(index)


def _launch(entry: str, counter: str, device: torch.device, *args) -> None:
    """Launch the C entry point ``stm_<entry>`` on ``device``, on the stream
    current there at the time of the call, and count it in
    ``LAUNCHES[counter]``.  A tensor argument is passed as its data pointer
    and None as 0 (a buffer the kernel does not take), any other as it is;
    the stream is appended.  Raises on a non-zero return."""
    fn = getattr(build.load(), f"stm_{entry}")
    argv = [0 if a is None else a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args]
    with _on(device.index):
        rc = fn(*argv, torch._C._cuda_getCurrentRawStream(device.index))
    build.check(rc, f"stm_{entry}")
    LAUNCHES[counter] += 1


def fgh(eta, beta_doc, counts, mu, siginv, bf16: bool = True):
    """Objective, gradient and Hessian of every document in the chunk.

    Replaces ``strutopy_tpu/ops/pallas_stages.py::_fgh_kernel`` (wrapper
    ``pallas_fgh_impl``).  On the H100 it is bound by device memory: it
    reads beta_doc (K·L·4 bytes a document) and writes H ((K-1)²·4), 50 MB
    for B=256, K=100, L=384, while the bf16 B·Bᵀ product (2·(K-1)²·L
    flops a document) is ~0.04 flop a byte.  Design: one block per
    document streams beta_doc once, in slabs of 32 word slots through a
    cp.async ring in shared memory; each slab gives its s_l, its
    log-likelihood and q terms and its operand phi·sqrt(c) (rounded to
    bf16 as the plain version rounds it), and H += operand·operandᵀ runs on
    the tensor cores (``mma.sync`` bf16 -> float32, upper triangle,
    accumulators in registers across slabs).  Above K ~115 the output
    tiles split over tile groups that each re-stream the document.  With
    ``bf16=False`` the operand stays float32 and the product runs in
    float32 FMAs.  A bf16 beta_doc rides the ring as bf16 slabs (half the
    bytes: 30 MB at the shapes above) and is read into float32 at the
    ring, so the arithmetic is the float32 path's on the rounded values.
    """
    if _use_plain("fgh", eta, beta_doc, counts, mu, siginv,
                  dtypes=[torch.float32, BETA_DTYPES] + [torch.float32] * 3):
        return fgh_plain(eta, beta_doc, counts, mu, siginv, bf16)
    beta_bf16, counter = _beta_mode("fgh", beta_doc)
    B, K, L = beta_doc.shape
    _expect("fgh", eta=(eta, (B, K - 1)), mu=(mu, (B, K - 1)),
            counts=(counts, (B, L)), siginv=(siginv, (K - 1, K - 1)))
    f = torch.empty(B, dtype=torch.float32, device=eta.device)
    g = torch.empty(B, K - 1, dtype=torch.float32, device=eta.device)
    H = torch.empty(B, K - 1, K - 1, dtype=torch.float32, device=eta.device)
    _launch("fgh", counter, eta.device, siginv, eta, mu, beta_doc, counts, f, g, H, B, K, L,
            int(bool(bf16)), beta_bf16)
    return f, g, H


_CG_PLAN_FIELDS = ("bytes", "h_smem")


@functools.lru_cache(maxsize=None)
def cg_plan(Km1: int, bf16: bool = True, device_index: int = 0):
    """The plan of :func:`cg` at K-1 on a card: shared-memory bytes a block
    and whether H sits in shared memory (else the matvecs read it from L2);
    None outside K-1 = 1..512."""
    out = (ctypes.c_int * len(_CG_PLAN_FIELDS))()
    with _on(device_index):
        if build.load().stm_cg_plan(int(Km1), int(bool(bf16)), out) != 0:
            return None
    plan = dict(zip(_CG_PLAN_FIELDS, out))
    plan["h_smem"] = bool(plan["h_smem"])
    return plan


def cg(H, g, iters: int, bf16: bool = True):
    """Newton direction x ≈ -H⁻¹g by ``iters`` steps of Steihaug CG.

    Replaces ``strutopy_tpu/ops/pallas_stages.py::_cg_kernel`` (wrapper
    ``pallas_cg_impl``).  On the H100 it is bound by reading H once (39 KB
    a document at K=100) and, beyond that, by the latency of its steps.
    Design (``csrc/newton_doc.cuh::cg_body``): one block per document
    brings H in with 16-byte loads and keeps it in shared memory as the
    values the matvec uses (bf16 when ``bf16``, else float32; read from L2
    and rounded on the fly where it does not fit, K above ~330, as
    :func:`cg_plan` says), with the unrounded diagonal apart for the
    preconditioner.  Each matvec spreads the rows of H over all eight
    warps and adds their partial rows in warp order; every warp then runs
    the recurrences in registers, so a step takes one barrier.  p stays
    float32, as in the TPU kernel.  K-1 is at most 512.
    """
    if _use_plain("cg", H, g):
        return cg_plain(H, g, iters, bf16)
    B, Km1 = g.shape
    _expect("cg", H=(H, (B, Km1, Km1)))
    x = torch.empty(B, Km1, dtype=torch.float32, device=g.device)
    _launch("cg", "cg", g.device, H, g, x, B, Km1, int(iters), int(bool(bf16)))
    if trace.active() is not None:
        in_smem = cg_plan(Km1, bool(bf16), g.device.index)["h_smem"]
        trace.count("plan.cg.h_smem" if in_smem else "plan.cg.h_l2", B)
    return x


def linesearch(eta, p, ts, beta_doc, counts, mu, siginv):
    """Armijo sweep objectives fs[b, t] = f_b(eta_b + ts[t] p_b), (B, T).

    Replaces ``strutopy_tpu/ops/pallas_stages.py::_ls_kernel`` (wrapper
    ``pallas_linesearch_impl``).  On the H100 it is bound by reading
    beta_doc once (K·L·4 bytes a document, 39 MB for B=256, K=100,
    L=384); the T mixtures are 2·T·K·L flops, in float32.  Design: one
    block per document streams beta_doc in slabs of 64 word slots (32 at
    large K) through a cp.async ring; each thread forms 4 step sizes by 4
    slots of partial mixtures from 16-byte shared-memory reads, the
    partials add in a fixed order, and the T ≤ 16 candidate softmax rows
    sit in shared memory.  The prior term reads each column of siginv
    once for 4 step sizes.  A bf16 beta_doc rides the ring as bf16 slabs
    (8-byte shared-memory reads of 4 slots), as in :func:`fgh`.
    """
    if _use_plain("ls", eta, p, ts, beta_doc, counts, mu, siginv,
                  dtypes=[torch.float32] * 3 + [BETA_DTYPES] + [torch.float32] * 3):
        return linesearch_plain(eta, p, ts, beta_doc, counts, mu, siginv)
    beta_bf16, counter = _beta_mode("ls", beta_doc)
    B, K, L = beta_doc.shape
    T = ts.shape[0]
    _expect("ls", eta=(eta, (B, K - 1)), p=(p, (B, K - 1)), mu=(mu, (B, K - 1)),
            counts=(counts, (B, L)), siginv=(siginv, (K - 1, K - 1)), ts=(ts, (T,)))
    _check_steps("ls", T)
    fs = torch.empty(B, T, dtype=torch.float32, device=eta.device)
    _launch("ls", counter, eta.device, siginv, ts, eta, p, mu, beta_doc, counts, fs, B, K, L, T,
            beta_bf16)
    return fs


def newton_direction(g, x, grad_tol: float):
    """The step's glue between :func:`cg` and :func:`linesearch`: (p (B,
    K-1), gTp (B,), conv (B,) bool), as :func:`newton_direction_plain`.

    The JAX package leaves this to XLA, which fuses it.  On the H100 it is
    bound by its launch (it reads g and x once, 0.2 MB at B=256, K=100).
    Design (``csrc/stages.cu::step_direction_kernel``): one block per
    document, the max and the two dot products as the fused step
    (``newton.cu``) reduces them (``newton_doc.cuh``: ``grad_converged``,
    ``descent_direction``), so conv and p are torch's exactly and gTp
    differs from torch's only in its summation order.  Any K-1.
    """
    if _use_plain("direction", g, x):
        return newton_direction_plain(g, x, grad_tol)
    B, Km1 = g.shape
    _expect("direction", x=(x, (B, Km1)))
    p = torch.empty_like(g)
    gTp = torch.empty(B, dtype=torch.float32, device=g.device)
    conv = torch.empty(B, dtype=torch.bool, device=g.device)
    _launch("newton_direction", "direction", g.device, g, x, p, gTp, conv, B, Km1,
            float(grad_tol))
    return p, gTp, conv


def newton_accept(eta, p, fs, f, gTp, ts, done, conv, n_iters=None):
    """The step's glue after :func:`linesearch`: (eta, done, advance,
    any_ok, all_done) with n_iters (int32 (B,), or None) advanced in
    place, as :func:`newton_accept_plain`; all_done is a 0-dim bool tensor,
    every document's new done flag ANDed on the device, for the Newton
    loop's one host read a step.

    The JAX package leaves the step choice to XLA and tests its loop's
    condition inside ``lax.while_loop``.  On the H100 it is bound by its
    launch (eta, p and the sweep read once, eta written: 0.3 MB at B=256,
    K=100).  Design (``csrc/stages.cu::step_accept_kernel``): one block
    per document takes the Armijo step as the fused step does
    (``newton_doc.cuh::armijo_step``, rounded as PyTorch rounds it) and
    updates eta with the same roundings, so every output equals the plain
    version's for the same inputs; one more block tests every document's
    new done flag and ANDs them with ``__syncthreads_and``, so the flag
    takes no atomics, no second launch and no order.  1 to 16 step sizes.
    """
    extra = () if n_iters is None else (n_iters,)
    if _use_plain("accept", eta, p, fs, f, gTp, ts, done, conv, *extra,
                  dtypes=[torch.float32] * 6 + [torch.bool] * 2 + [torch.int32]):
        return newton_accept_plain(eta, p, fs, f, gTp, ts, done, conv, n_iters)
    B, Km1 = eta.shape
    T = ts.shape[0]
    _expect("accept", p=(p, (B, Km1)), fs=(fs, (B, T)), f=(f, (B,)), gTp=(gTp, (B,)),
            ts=(ts, (T,)), done=(done, (B,)), conv=(conv, (B,)),
            **({} if n_iters is None else {"n_iters": (n_iters, (B,))}))
    _check_steps("accept", T)
    eta_out = torch.empty_like(eta)
    done_out = torch.empty_like(done)
    advance = torch.empty_like(done)
    any_ok = torch.empty_like(done)
    all_done = torch.empty((), dtype=torch.bool, device=eta.device)
    _launch("newton_accept", "accept", eta.device, eta, p, fs, f, gTp, ts, done, conv, eta_out,
            done_out, advance, any_ok, n_iters, all_done, B, Km1, T)
    return eta_out, done_out, advance, any_ok, all_done


_PLAN_FIELDS = ("bytes", "W", "stages", "blocks_per_sm", "groups", "H", "siginv_in_smem",
                "resident")


def newton_plan(K: int, L: int, bf16: bool = True, loop: bool = True,
                beta_bf16: bool = False):
    """The fused kernel's shared-memory plan at (K, L) on the current card,
    for the whole loop (:func:`newton_loop`) or one step
    (:func:`newton_iter`, ``loop=False``), with beta_doc in float32 or
    (``beta_bf16``, one step only) bf16: bytes a block, slab width W,
    ring depth, blocks an SM, B1's tile groups, where H lives ("ring",
    "shared" or "global"), whether siginv stays in shared memory and
    whether beta_doc stays resident in it for the whole loop; None where
    no plan fits."""
    out = (ctypes.c_int * len(_PLAN_FIELDS))()
    if build.load().stm_newton_plan(int(K), int(L), int(bool(bf16)), int(bool(beta_bf16)),
                                    int(bool(loop)), out) != 0:
        return None
    plan = dict(zip(_PLAN_FIELDS, out))
    plan["H"] = ("ring", "shared", "global")[plan["H"]]
    return plan


def _h_scratch(B: int, K: int, L: int, bf16: bool, loop: bool, device,
               beta_bf16: bool = False):
    """The (B, K-1, K-1) global scratch the fused kernel needs for H where
    it does not fit in shared memory (K above ~250), else None."""
    plan = newton_plan(K, L, bf16, loop, beta_bf16)
    if plan is None:
        raise ValueError(f"fused Newton kernels: K={K}, L={L} exceed a block's shared memory")
    if plan["H"] != "global":
        return None
    return torch.empty(B, K - 1, K - 1, dtype=torch.float32, device=device)


def newton_iter(eta, beta_doc, counts, mu, siginv, ts, done, grad_tol: float,
                cg_iters: int, bf16: bool = True):
    """One fused damped-Newton iteration: (eta, done, advance).

    Replaces ``strutopy_tpu/ops/pallas_stages.py::_iter_kernel`` (wrapper
    ``pallas_iter_impl``).  The kernel of :func:`newton_loop` with one
    step: one block per document runs the f/g/H, CG and sweep bodies of
    the stage kernels (``csrc/newton_doc.cuh``) in turn with H, g, the
    direction and the sweep values in shared memory, then chooses the step
    as :func:`newton_iter_plain` does and updates eta; a done document
    keeps its eta.  ``done`` is a bool (B,) tensor.  A bf16 beta_doc
    streams as bf16 slabs on the streaming plans (:func:`fgh`).
    """
    if _use_plain("iter", eta, beta_doc, counts, mu, siginv, ts, done,
                  dtypes=[torch.float32, BETA_DTYPES] + [torch.float32] * 4 + [torch.bool]):
        return newton_iter_plain(eta, beta_doc, counts, mu, siginv, ts, done, grad_tol,
                                 cg_iters, bf16)
    beta_bf16, counter = _beta_mode("iter", beta_doc)
    B, K, L = beta_doc.shape
    T = ts.shape[0]
    _expect("iter", eta=(eta, (B, K - 1)), mu=(mu, (B, K - 1)), counts=(counts, (B, L)),
            siginv=(siginv, (K - 1, K - 1)), ts=(ts, (T,)), done=(done, (B,)))
    _check_steps("iter", T)
    scratch = _h_scratch(B, K, L, bf16, False, eta.device, bool(beta_bf16))
    eta_out = torch.empty_like(eta)
    done_out = torch.empty_like(done)
    adv_out = torch.empty_like(done)
    _launch("iter", counter, eta.device, siginv, ts, eta, mu, done, beta_doc, counts, scratch,
            eta_out, done_out, adv_out, B, K, L, T, float(grad_tol), int(cg_iters),
            int(bool(bf16)), beta_bf16)
    return eta_out, done_out, adv_out


def newton_loop(beta_doc, counts, mu, eta0, siginv, ts, max_iters: int, grad_tol: float,
                cg_iters: int, bf16: bool = True):
    """The whole damped-Newton loop of a chunk: (eta, n_iters int32).

    Replaces ``strutopy_tpu/ops/pallas_estep.py::_newton_kernel`` (wrapper
    ``pallas_newton_impl``).  A loop is bound by its longest chain: the
    chunk costs about its slowest document's Newton count times one step
    of one block.  Design: one block per document keeps its state on chip
    and runs the stage kernels' f/g/H, CG and sweep bodies
    (``csrc/newton_doc.cuh``) in turn, at most ``max_iters`` steps, leaving
    the loop once its document is done (a done document is frozen and
    counts no iteration, so this is exact), with no host synchronisation.
    The bodies share one cp.async ring; H is assembled in it for CG where
    it fits (see :func:`newton_plan`).  beta_doc is float32 only, on any
    device: the whole-loop path reads float32 whatever
    ``newton_bf16_beta`` says, as in the JAX package.
    """
    if beta_doc.dtype != torch.float32:
        raise ValueError(f"newton: beta_doc must be float32 (the whole loop takes no bf16 "
                         f"beta_doc), got {beta_doc.dtype}")
    if _use_plain("newton", beta_doc, counts, mu, eta0, siginv, ts):
        return newton_loop_plain(beta_doc, counts, mu, eta0, siginv, ts, max_iters, grad_tol,
                                 cg_iters, bf16)
    B, K, L = beta_doc.shape
    T = ts.shape[0]
    _expect("newton", eta0=(eta0, (B, K - 1)), mu=(mu, (B, K - 1)), counts=(counts, (B, L)),
            siginv=(siginv, (K - 1, K - 1)), ts=(ts, (T,)))
    _check_steps("newton", T)
    scratch = _h_scratch(B, K, L, bf16, max_iters > 1, eta0.device)
    eta = torch.empty_like(eta0)
    n_iters = torch.empty(B, dtype=torch.int32, device=eta0.device)
    _launch("newton", "newton", eta0.device, siginv, ts, beta_doc, counts, mu, eta0, scratch, eta,
            n_iters, B, K, L, T, int(max_iters), float(grad_tol), int(cg_iters),
            int(bool(bf16)))
    return eta, n_iters


def gather_rows(beta_T, words):
    """Row gather beta_T[words]: (V, K) float32 and (B, L) int32 -> (B, L, K).

    Replaces ``strutopy_tpu/ops/pallas_stages.py::_gather_rows_kernel``
    (wrapper ``pallas_gather_beta``).  A pure copy, bound by device-memory
    bandwidth: B·L·K·4 bytes written (39 MB for B=256, L=384, K=100).
    Design: one warp per output row reads its own word id, then copies
    the row with 16-byte loads and stores where K % 4 == 0.  Bit for bit
    the same as :func:`gather_rows_plain`; an id outside [0, V) gives a
    row of NaN.  Not wired into the E-step (as in the JAX package).
    """
    if _use_plain("gather", beta_T, words, dtypes=[torch.float32, torch.int32]):
        return gather_rows_plain(beta_T, words)
    V, K = beta_T.shape
    B, L = words.shape
    out = torch.empty(B, L, K, dtype=torch.float32, device=beta_T.device)
    _launch("gather_rows", "gather", beta_T.device, beta_T, words, out, B * L, V, K)
    return out


def scatter_phi(beta_ss, phi, plan: ScatterPlan, V: int):
    """Ordered scatter: for each key j of ``plan``, its entries' rows of
    ``phi`` (n_entries, K) added into ``beta_ss`` at key j one at a time,
    in the plan's order, in float32 (in place, returned): the order of the
    XLA scatter and of ``index_add_`` on the CPU.  ``beta_ss`` holds
    ``n_keys`` keys of V an aspect block: (K, V), or (A, K, V) with key
    a·V + w.

    Replaces the XLA scatter ``beta_ss.at[:, idx].add(phi)`` of
    ``strutopy_tpu/ops/estep.py::_scatter_phi`` (no Pallas kernel: an
    ordered XLA scatter, deterministic on the TPU), where PyTorch's
    ``index_add_`` adds with atomics in no fixed order on the card.  Bound
    by bytes: the live entries' rows read once and the touched columns of
    beta_ss read and written once (~32 MB at B=256, K=100, L=384).  Design
    (``csrc/scatter.cu``): one warp a key and K tile of 128, the entries'
    rows read as coalesced 128-byte loads, eight entries' loads in flight
    before they are added in order to a running sum in registers, and the
    block's columns of beta_ss read and written through shared memory a
    32-byte sector at a time.  Bit for bit :func:`scatter_phi_plain`.
    """
    if _use_plain("scatter", beta_ss, phi, plan.perm, plan.offsets,
                  dtypes=[torch.float32, torch.float32, torch.int32, torch.int32]):
        return scatter_phi_plain(beta_ss, phi, plan, V)
    n_keys, K = plan.offsets.shape[0] - 1, phi.shape[1]
    _expect("scatter", perm=(plan.perm, (phi.shape[0],)))
    if phi.ndim != 2 or beta_ss.numel() != n_keys * K or n_keys % V != 0:
        raise ValueError(f"scatter: beta_ss {tuple(beta_ss.shape)} does not hold {n_keys} keys "
                         f"of {K} topics, {V} an aspect block, for phi {tuple(phi.shape)}")
    _launch("scatter_phi", "scatter", phi.device, phi, plan.perm, plan.offsets, beta_ss, n_keys, K,
            V)
    return beta_ss


_FACTOR_PLAN_FIELDS = ("threads", "bytes", "in_smem")


@functools.lru_cache(maxsize=None)
def factor_plan(P: int, device_index: int = 0):
    """The plan of :func:`chol_pd_inverse` at P on a card: threads a block,
    shared-memory bytes a block, and whether the two packed triangles sit in
    shared memory (the smem plan; else the blocked plan, with a scratch of
    P(P+1) floats a document the wrapper allocates); None outside P =
    1..512."""
    out = (ctypes.c_int * len(_FACTOR_PLAN_FIELDS))()
    with _on(device_index):
        if build.load().stm_factor_plan(int(P), out) != 0:
            return None
    plan = dict(zip(_FACTOR_PLAN_FIELDS, out))
    plan["in_smem"] = bool(plan["in_smem"])
    return plan


def chol_pd_inverse(H, inverse: bool = True, jitter: float = 1e-5, rel_jitter: float = 1e-3):
    """The finalize's factor of a chunk's Hessians H (B, P, P): (L, nu, rung)
    with L the PD-repair ladder's Cholesky factor (:func:`chol_pd_plain`:
    lower, zeros above, NaN where all four rungs fail), nu = (L Lᵀ)⁻¹ (None
    unless ``inverse``) and rung (B,) int8, as :func:`chol_pd_inverse_plain`.
    While recording in full, a chunk with a rung above 1 counts in
    ``finalize.repair_chunks``, on the device.

    Replaces no TPU kernel: the JAX twin is the finalize's factor in
    ``strutopy_tpu/ops/estep.py::_finalize_chunk`` (``_chol_pd_batched``,
    then ``cho_inverse``), which XLA lowers; on the card it takes the place
    of ``cholesky_ex`` rung by rung and ``cholesky_inverse``, two host syncs
    a chunk.  Design (``csrc/factor.cu``), two plans chosen by P
    (:func:`factor_plan`), one block a document, one launch a chunk; every
    pivot is read by every thread of the block (or lane of the warp) that
    tests it, so a failed rung reloads H and retries on the device with no
    host read; every sum starts from 0, not from H, and takes its terms in
    ascending order (the blocked plan sums each chunk of 16 from 0 and adds
    the chunks' sums in order), with no atomics, so every output is a
    function of H alone and nu (written to both triangles from one sum) is
    symmetric.
    The smem plan (P up to ~240): bound by latency (at B=256, P=99 ~30 MB
    and ~P³/2 multiply-adds a document, but each document's P pivots form a
    chain); the two packed lower triangles, the rung's matrix and the
    running sums, sit in shared memory (39.6 KB at P=99: the chunk resident
    in one wave); one right-looking pass factors and inverts in place (a
    rank-1 update a step), then one thread sums each entry of nu = L⁻ᵀL⁻¹.
    The blocked plan (P above ~240, up to 512): bound by operations (at
    B=256, P=399 16.3 GFLOP, 0.243 ms, against 490 MB, 0.15 ms); panels of
    32, left-looking: the factor takes a panel's columns as register tiles
    of 32 rows by 32 columns (4 x 8 a lane, the rows above staged a chunk
    of 16 by cp.async), warp 0 factors the diagonal block by shuffles and
    the rows below solve against it in registers; then X = L⁻¹ a panel of
    32 rows and nu = XᵀX a 32 x 32 tile at a time, each warp taking its
    own tiles, the longest first.  Each panel reads the rows above it once
    (~4 MB a document at P=399, X in the scratch the wrapper allocates, L
    in Lᵀ), so nothing streams the triangles a step at a time.  L comes
    back as the transposed view of the kernel's coalesced Lᵀ, the
    column-major layout ``cholesky_ex`` returns.
    """
    if _use_plain("factor", H):
        return chol_pd_inverse_plain(H, inverse, jitter, rel_jitter)
    if H.ndim != 3 or H.shape[1] != H.shape[2]:
        raise ValueError(f"factor: H must be (B, P, P), got {tuple(H.shape)}")
    B, P, _ = H.shape
    plan = factor_plan(P, H.device.index)
    if plan is None:
        raise ValueError(f"factor: the kernel takes P from 1 to 512, got {P}")
    Lt = torch.empty_like(H)
    nu = torch.empty_like(H) if inverse else None
    rung = torch.empty(B, dtype=torch.int8, device=H.device)
    scratch = (None if plan["in_smem"]
               else torch.empty(B, P * (P + 1), dtype=torch.float32, device=H.device))
    _launch("chol_pd_inverse", "factor", H.device, H, Lt, nu, rung, scratch, B, P,
            int(bool(inverse)), float(jitter), float(rel_jitter))
    if trace.active() is not None:
        trace.count("plan.factor.smem" if plan["in_smem"] else "plan.factor.global", B)
    if trace.full() and B:
        trace.count("finalize.repair_chunks", torch.amax(rung).reshape(1), op=_repaired)
    return Lt.transpose(1, 2), nu, rung


_FINALIZE_PLAN_FIELDS = ("bytes", "W", "stages", "blocks_per_sm", "stage")


@functools.lru_cache(maxsize=None)
def finalize_plan(K: int, device_index: int = 0):
    """The plan of :func:`finalize_terms` at K on a card: bytes a block, slab
    width W, ring depth, blocks an SM and whether a slab's phi is staged in
    shared memory (else stored element by element); None where no plan
    fits (K above ~561, past B1's default mode's ~481)."""
    out = (ctypes.c_int * len(_FINALIZE_PLAN_FIELDS))()
    with _on(device_index):
        if build.load().stm_finalize_plan(int(K), out) != 0:
            return None
    plan = dict(zip(_FINALIZE_PLAN_FIELDS, out))
    plan["stage"] = bool(plan["stage"])
    return plan


def finalize_terms(eta, beta_doc, counts, mu, doc_w, siginv, Nd):
    """The E-step finalize's per-document terms at the converged eta, all
    float32: (g, H, theta, phi, terms) as :func:`finalize_terms_plain`, phi
    (B, K, L) with (B, L, K) memory, terms (B, 2) = (loglik, quad).

    Replaces no TPU kernel: its JAX twin is the math of
    ``strutopy_tpu/ops/estep.py::_finalize_chunk`` around the factor, which
    XLA fuses; on the card it takes the place of ~75 PyTorch launches a
    chunk.  Bound by bytes: it reads beta_doc once and writes phi and H,
    ~89 MB at B=256, K=100, L=384 (~27 µs); H's float32 B·Bᵀ is ~1 GFLOP
    (~15 µs at 67 TFLOP/s).  Design (Z, ``csrc/stages.cu::finalize_kernel``
    on ``newton_doc.cuh::fgh_body``'s float32 mode): one block a document
    streams beta_doc once through B1's cp.async ring; each slab gives s_l
    and, from the same loads, the mixture t_l, their log-likelihood terms,
    phi_hat and B·Bᵀ's float32 operand, and each slab's phi for all K topics
    is staged in shared memory and written as one contiguous run while the
    product runs.  q is summed a slab at a time, so Z holds none of B1's
    per-lane partials.  Every sum has a fixed order, no atomics: the
    outputs are a function of the inputs.  B1's tile groups past K ~115;
    the phi stage up to K ~428; K up to ~561 (:func:`finalize_plan`).
    """
    if _use_plain("finalize", eta, counts, mu, doc_w, siginv, Nd):
        return finalize_terms_plain(eta, beta_doc, counts, mu, doc_w, siginv, Nd)
    beta_doc = beta_doc.contiguous()  # any layout, as the plain version takes (the E-step's are)
    _use_plain("finalize", eta, beta_doc)
    B, K, L = beta_doc.shape
    _expect("finalize", eta=(eta, (B, K - 1)), mu=(mu, (B, K - 1)), counts=(counts, (B, L)),
            doc_w=(doc_w, (B,)), siginv=(siginv, (K - 1, K - 1)), Nd=(Nd, (B,)))
    plan = finalize_plan(K, eta.device.index)
    if plan is None:
        raise ValueError(f"finalize: K={K} exceeds a block's shared memory")
    dev = eta.device
    g = torch.empty(B, K - 1, dtype=torch.float32, device=dev)
    H = torch.empty(B, K - 1, K - 1, dtype=torch.float32, device=dev)
    theta = torch.empty(B, K, dtype=torch.float32, device=dev)
    phi = torch.empty(B, L, K, dtype=torch.float32, device=dev)
    terms = torch.empty(B, 2, dtype=torch.float32, device=dev)
    _launch("finalize", "finalize", dev, siginv, eta, mu, beta_doc, counts, Nd, doc_w, g, H,
            theta, phi, terms, B, K, L)
    if trace.active() is not None:
        trace.count("plan.finalize.staged" if plan["stage"] else "plan.finalize.unstaged", B)
    return g, H, theta, phi.transpose(1, 2), terms


def finalize_bound(L, nu, terms, sigmaentropy, doc_w):
    """The finalize after its factor: (doc_w · nu, doc_w · bound) as
    :func:`finalize_bound_plain`, from :func:`chol_pd_inverse`'s L and nu,
    :func:`finalize_terms`' terms and a 0-dim sigmaentropy.  On the card nu
    is weighted in place and returned.

    Replaces no TPU kernel (the JAX twin's XLA epilogue).  Bound by its
    launch and by nu, read and written once (20 MB at B=256, P=99).
    Design (``csrc/stages.cu::finalize_bound_kernel``): one block a
    document sums its log L_ii in the block's fixed order, forms the bound
    in the plain version's order of operations and scales nu.
    """
    Lt = L if L.is_contiguous() else L.transpose(1, 2)  # the diagonal either way
    if _use_plain("finalize_bound", Lt, nu, terms, sigmaentropy, doc_w):
        return finalize_bound_plain(L, nu, terms, sigmaentropy, doc_w)
    B, P, _ = nu.shape
    _expect("finalize_bound", L=(Lt, (B, P, P)), terms=(terms, (B, 2)),
            sigmaentropy=(sigmaentropy, ()), doc_w=(doc_w, (B,)))
    bound = torch.empty(B, dtype=torch.float32, device=nu.device)
    _launch("finalize_bound", "finalize_bound", nu.device, Lt, nu, terms, sigmaentropy, doc_w,
            bound, B, P)
    return nu, bound
