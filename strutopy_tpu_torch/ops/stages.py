"""The damped-Newton iteration of the E-step, the beta row gather and the
ordered phi scatter.

Each function has a plain PyTorch version and a CUDA kernel
(``csrc/stages.cu``, ``csrc/newton.cu``, ``csrc/scatter.cu``), with the
same signature:

  ===========  ===========================  ==================================
  function     plain version                kernel wrapper (launch counter)
  ===========  ===========================  ==================================
  f, g, H      :func:`fgh_plain`            :func:`fgh` (``LAUNCHES["fgh"]``)
  CG           :func:`cg_plain`             :func:`cg` (``LAUNCHES["cg"]``)
  Armijo       :func:`linesearch_plain`     :func:`linesearch` (``"ls"``)
  iteration    :func:`newton_iter_plain`    :func:`newton_iter` (``"iter"``)
  Newton loop  :func:`newton_loop_plain`    :func:`newton_loop` (``"newton"``)
  row gather   :func:`gather_rows_plain`    :func:`gather_rows` (``"gather"``)
  phi scatter  :func:`scatter_phi_plain`    :func:`scatter_phi` (``"scatter"``)
  ===========  ===========================  ==================================

:func:`stage_iter` is the default Newton iteration: the step glue of
:func:`newton_iter_plain` around the three stage kernels.

A wrapper given CPU tensors runs the plain version; given CUDA tensors
it launches the kernel or raises.  There is no fallback from one to the
other.  Each launch adds one to its counter, so a run can show that its
main path went through the kernels.

:func:`fgh`, :func:`linesearch` and :func:`newton_iter` take beta_doc as
float32 or bfloat16 (the Newton search under ``STMConfig.newton_bf16_beta``;
``bf16`` everywhere else means the Hessian operand).  A bf16 beta_doc
launches the kernel's bf16-input mode and counts under its own name
(``"fgh_bf16_beta"``, ``"ls_bf16_beta"``, ``"iter_bf16_beta"``); the plain
versions upcast it once, which is exactly the JAX promotion, so either
mode computes the float32 function of the rounded beta_doc.

The plain versions carry the math of ``strutopy_tpu/ops/estep.py``'s
``_f_g_H_batched``, ``_f_multi`` and of the Pallas ``_cg_kernel``; the
finalize pass reuses :func:`f_g_H_batched` at float32 for the model
quantities.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from strutopy_tpu_torch.ops import build
from strutopy_tpu_torch.utils import trace

LAUNCHES = {"fgh": 0, "cg": 0, "ls": 0, "iter": 0, "newton": 0, "gather": 0, "scatter": 0,
            "fgh_bf16_beta": 0, "ls_bf16_beta": 0, "iter_bf16_beta": 0}
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


def _newton_step(fgh_fn, cg_fn, ls_fn, eta, beta_doc, counts, mu, siginv, ts, done,
                 grad_tol: float, cg_iters: int, bf16: bool):
    """One damped-Newton iteration of a chunk on the given stage functions
    (the body of ``strutopy_tpu/ops/estep.py::_batched_newton``).

    Returns (eta, done, advance): done documents keep their eta; a
    document advances unless it was done or has converged (max|g| <=
    grad_tol), and is done after a step when no step size passes the
    Armijo test.  Inside ``trace.recording()``, a document that advances
    with no step size passing counts in ``newton.stalled``.
    """
    f, g, H = fgh_fn(eta, beta_doc, counts, mu, siginv, bf16=bf16)
    conv = torch.amax(torch.abs(g), dim=1) <= grad_tol
    p = cg_fn(H, g, cg_iters, bf16=bf16)
    gTp = torch.sum(g * p, dim=1)
    bad = gTp >= 0
    p = torch.where(bad[:, None], -g, p)
    gTp = torch.where(bad, -torch.sum(g * g, dim=1), gTp)

    # parallel Armijo sweep: the first (largest) acceptable step
    fs = ls_fn(eta, p, ts, beta_doc, counts, mu, siginv)
    ok = fs <= f[:, None] + 1e-4 * ts[None, :] * gTp[:, None]
    any_ok = torch.any(ok, dim=1)
    t = torch.amax(torch.where(ok, ts[None, :], 0.0), dim=1)

    advance = ~done & ~conv
    if trace.full():
        trace.count("newton.stalled", advance, any_ok, op=torch.gt)
    step = advance & any_ok
    eta = torch.where(step[:, None], eta + t[:, None] * p, eta)
    done = done | conv | ~any_ok
    return eta, done, advance


def newton_iter_plain(eta, beta_doc, counts, mu, siginv, ts, done, grad_tol: float,
                      cg_iters: int, bf16: bool = True):
    """Plain version of :func:`newton_iter`: the step on the plain stages."""
    beta_doc = _beta_f32(beta_doc)
    return _newton_step(fgh_plain, cg_plain, linesearch_plain, eta, beta_doc, counts, mu,
                        siginv, ts, done, grad_tol, cg_iters, bf16)


def stage_iter(eta, beta_doc, counts, mu, siginv, ts, done, grad_tol: float,
               cg_iters: int, bf16: bool = True):
    """One Newton iteration on the three stage kernels (:func:`fgh`,
    :func:`cg`, :func:`linesearch`) with the step glue in PyTorch: the
    default path.  On CPU tensors it is :func:`newton_iter_plain`."""
    return _newton_step(fgh, cg, linesearch, eta, beta_doc, counts, mu, siginv, ts, done,
                        grad_tol, cg_iters, bf16)


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


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


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
    lib = build.load()
    with torch.cuda.device(eta.device):
        rc = lib.stm_fgh(*(t.data_ptr() for t in (siginv, eta, mu, beta_doc, counts, f, g, H)),
                         B, K, L, int(bool(bf16)), beta_bf16, _stream(eta))
    build.check(rc, "stm_fgh")
    LAUNCHES[counter] += 1
    return f, g, H


def cg(H, g, iters: int, bf16: bool = True):
    """Newton direction x ≈ -H⁻¹g by ``iters`` steps of Steihaug CG.

    Replaces ``strutopy_tpu/ops/pallas_stages.py::_cg_kernel`` (wrapper
    ``pallas_cg_impl``).  On the H100 it is bound by reading H once (39 KB
    a document at K=100) and, beyond that, by the latency of its steps.
    Design (``csrc/newton_doc.cuh::cg_body``): one block per document
    brings H in with 16-byte loads and keeps it in shared memory as the
    values the matvec uses (bf16 when ``bf16``, else float32; read from L2
    and rounded on the fly where it does not fit, K above ~330), with the
    unrounded diagonal apart for the preconditioner.  Each matvec spreads
    the rows of H over all eight warps and adds their partial rows in warp
    order; every warp then runs the recurrences in registers, so a step
    takes one barrier.  p stays float32, as in the TPU kernel.  K-1 is at
    most 512.
    """
    if _use_plain("cg", H, g):
        return cg_plain(H, g, iters, bf16)
    B, Km1 = g.shape
    _expect("cg", H=(H, (B, Km1, Km1)))
    x = torch.empty(B, Km1, dtype=torch.float32, device=g.device)
    lib = build.load()
    with torch.cuda.device(g.device):
        rc = lib.stm_cg(H.data_ptr(), g.data_ptr(), x.data_ptr(), B, Km1, int(iters),
                        int(bool(bf16)), _stream(g))
    build.check(rc, "stm_cg")
    LAUNCHES["cg"] += 1
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
    if not 1 <= T <= 16:
        raise ValueError(f"ls: the kernel takes 1 to 16 step sizes, got {T}")
    fs = torch.empty(B, T, dtype=torch.float32, device=eta.device)
    lib = build.load()
    with torch.cuda.device(eta.device):
        rc = lib.stm_ls(*(t.data_ptr() for t in (siginv, ts, eta, p, mu, beta_doc, counts, fs)),
                        B, K, L, T, beta_bf16, _stream(eta))
    build.check(rc, "stm_ls")
    LAUNCHES[counter] += 1
    return fs


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


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


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
    if not 1 <= T <= 16:
        raise ValueError(f"iter: the kernel takes 1 to 16 step sizes, got {T}")
    scratch = _h_scratch(B, K, L, bf16, False, eta.device, bool(beta_bf16))
    lib = build.load()
    eta_out = torch.empty_like(eta)
    done_out = torch.empty_like(done)
    adv_out = torch.empty_like(done)
    with torch.cuda.device(eta.device):
        rc = lib.stm_iter(*(_ptr(t) for t in (siginv, ts, eta, mu, done, beta_doc, counts,
                                              scratch, eta_out, done_out, adv_out)),
                          B, K, L, T, float(grad_tol), int(cg_iters), int(bool(bf16)),
                          beta_bf16, _stream(eta))
    build.check(rc, "stm_iter")
    LAUNCHES[counter] += 1
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
    if not 1 <= T <= 16:
        raise ValueError(f"newton: the kernel takes 1 to 16 step sizes, got {T}")
    scratch = _h_scratch(B, K, L, bf16, max_iters > 1, eta0.device)
    lib = build.load()
    eta = torch.empty_like(eta0)
    n_iters = torch.empty(B, dtype=torch.int32, device=eta0.device)
    with torch.cuda.device(eta0.device):
        rc = lib.stm_newton(*(_ptr(t) for t in (siginv, ts, beta_doc, counts, mu, eta0,
                                                scratch, eta, n_iters)),
                            B, K, L, T, int(max_iters), float(grad_tol), int(cg_iters),
                            int(bool(bf16)), _stream(eta0))
    build.check(rc, "stm_newton")
    LAUNCHES["newton"] += 1
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
    lib = build.load()
    with torch.cuda.device(beta_T.device):
        rc = lib.stm_gather_rows(beta_T.data_ptr(), words.data_ptr(), out.data_ptr(), B * L,
                                 V, K, _stream(beta_T))
    build.check(rc, "stm_gather_rows")
    LAUNCHES["gather"] += 1
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
    lib = build.load()
    with torch.cuda.device(phi.device):
        rc = lib.stm_scatter_phi(phi.data_ptr(), plan.perm.data_ptr(), plan.offsets.data_ptr(),
                                 beta_ss.data_ptr(), n_keys, K, V, _stream(phi))
    build.check(rc, "stm_scatter_phi")
    LAUNCHES["scatter"] += 1
    return beta_ss
