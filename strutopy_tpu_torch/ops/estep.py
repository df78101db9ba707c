"""Batched variational E-step (twin of ``strutopy_tpu/ops/estep.py``).

For every document, minimize over the variational mean ``eta`` (K-1
free coordinates, the K-th pinned to 0)

    f(eta) = 0.5 (eta-mu)ᵀ Σ⁻¹ (eta-mu)
             - Σ_l c_l log( Σ_k e^{eta_k} beta_{k, w_l} )
             + N_d · logsumexp(eta~)

by a batched damped Newton solve, on one of three paths, all CUDA
kernels of ``ops/stages.py``:

  * the default: each iteration runs the three stage kernels (f/g/H, the
    CG direction, the Armijo sweep) and two glue kernels (the direction's
    fallback; the step choice, the flags and the chunk's "all done");
  * ``NewtonConfig.pallas_iter``: each iteration is one fused kernel;
  * ``run_estep(use_pallas=True)``: the whole loop is one kernel per
    chunk (single pass only);

then finalize at the converged eta: float32 Hessian, PD-repair Cholesky
and ``nu = H⁻¹``, the per-document ELBO and the token-topic statistics
phi (``stages.finalize_terms``, ``chol_pd_inverse``, ``finalize_bound``:
three kernels a chunk on the card), accumulated as

    sigma_ss += nu        beta_ss[(a_d,) :, w_d] += phi_d      bound += bound_d

the phi scatter in a fixed order (``stages.scatter_phi``, a kernel on the
card), so the statistics, and the fit, are a function of the inputs.

Documents go through in chunks of ``batch_size``, in one pass or in the
two-pass straggler schedule, whose finalize either re-gathers beta_doc
in a third pass or rides passes 1 and 2 (``fused_finalize``).  With
``NewtonConfig.bf16_beta`` the Newton search of the first two paths reads
beta_doc rounded to bf16; the finalize reads float32.  Under a
vocabulary-sharded mesh (``vocab``) beta is this rank's block of words:
each chunk's beta_doc is assembled by one all-reduce over the vocab axis,
the E-step's one collective, and phi scatters into the local block with
none.  Plain functions on tensors: everything runs on the device of its
inputs.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from strutopy_tpu_torch.models.config import refuse_tpu_only
from strutopy_tpu_torch.ops import stages
from strutopy_tpu_torch.parallel.mesh import MeshAxis, all_sum
from strutopy_tpu_torch.utils import trace


class NewtonConfig(NamedTuple):
    max_iters: int = 24
    grad_tol: float = 1e-5
    max_backtracks: int = 12
    cg_iters: int = 6  # inner CG steps (capped at K-1)
    bf16_hessian: bool = True  # bf16 B·Bᵀ operand and CG matvec for the in-loop Hessian
    # run exactly max_iters Newton steps instead of stopping once every
    # document is done (done documents are frozen either way)
    fixed_iters: bool = False
    # one fused kernel per Newton iteration (stages.newton_iter) in place
    # of the three stage kernels and their two glue kernels
    pallas_iter: bool = False
    # < 1 tempers the likelihood of the eta SEARCH objective; the
    # finalize always evaluates the true model (see the JAX twin)
    likelihood_temper: float = 1.0
    # the Newton search reads beta_doc rounded to bf16 (half the bytes of
    # its dominant read); the finalize (bound, phi, nu) always reads the
    # float32 gather.  The whole-loop path (use_pallas) ignores it, as in JAX
    bf16_beta: bool = False


class EStepResult(NamedTuple):
    beta_ss: torch.Tensor  # (K, V) or (A, K, V)
    sigma_ss: torch.Tensor  # (K-1, K-1)
    bound: torch.Tensor  # scalar
    eta: torch.Tensor  # (N, K-1)
    theta: torch.Tensor  # (N, K)
    newton_iters: torch.Tensor  # (N,) int32
    # unconverged docs the two-pass straggler budget could not admit
    # (left at their pass-1 eta); 0 on the single-pass path
    straggler_overflow: torch.Tensor


# ---------------------------------------------------------------------------
# Newton solve
# ---------------------------------------------------------------------------


def _search_beta(beta_doc, cfg: NewtonConfig):
    """The beta_doc the Newton search reads: rounded to bf16 once after
    the gather under ``bf16_beta`` (a plain cast, as the JAX package
    leaves it to XLA), else the float32 gather itself."""
    return beta_doc.to(torch.bfloat16) if cfg.bf16_beta else beta_doc


def _search_counts(counts, cfg: NewtonConfig):
    """The counts the Newton search sees: f, g, H and the sweep are
    linear in counts, so scaling them once tempers the whole search
    objective (``likelihood_temper``)."""
    return counts * cfg.likelihood_temper if cfg.likelihood_temper != 1.0 else counts


def _step_sizes(cfg: NewtonConfig, like: torch.Tensor):
    """The Armijo ladder 1, 1/2, 1/4, ... (``max_backtracks`` sizes)."""
    return torch.exp2(-torch.arange(cfg.max_backtracks, dtype=like.dtype, device=like.device))


def _batched_newton(beta_doc, counts, mu, eta0, siginv, cfg: NewtonConfig,
                    done0: Optional[torch.Tensor] = None):
    """Damped Newton for a chunk, one iteration per kernel call(s).

    Returns (eta (B, K-1), n_iters (B,) int32, done (B,) bool).  ``done``
    is False only for documents that hit ``max_iters`` while still
    improving; each step is a pure per-document function of eta, so such
    documents resume exactly in a later call (the two-pass schedule),
    with ``done0`` carrying the earlier call's flags.

    The loop stops once every document is done, which costs a host sync
    per iteration (the JAX ``while_loop`` condition): a read of the flag
    the stage path's step computes on the device (``stages.stage_step``,
    which also advances n_iters there), or of ``torch.all(done)`` before
    the first step and on the fused path.  While recording
    (``utils/trace.py``) it counts its steps and the documents' advances;
    inside ``trace.recording()`` the stage path's steps count stalls, the
    fused iteration's none.
    """
    B, K, _ = beta_doc.shape
    counts = _search_counts(counts, cfg)
    cg_iters = min(cfg.cg_iters, K - 1)
    ts = _step_sizes(cfg, eta0)
    eta = eta0
    done = (torch.zeros(B, dtype=torch.bool, device=eta0.device)
            if done0 is None else done0)
    n_iters = torch.zeros(B, dtype=torch.int32, device=eta0.device)
    all_done = None  # the step's "every document done" flag, on the device
    steps = 0
    for _ in range(cfg.max_iters):
        if not cfg.fixed_iters and trace.read(
                "newton.done", bool, torch.all(done) if all_done is None else all_done):
            break
        if cfg.pallas_iter:
            eta, done, advance = stages.newton_iter(eta, beta_doc, counts, mu, siginv, ts, done,
                                                    cfg.grad_tol, cg_iters, cfg.bf16_hessian)
            n_iters = n_iters + advance.to(torch.int32)
        else:
            eta, done, _advance, all_done = stages.stage_step(
                eta, beta_doc, counts, mu, siginv, ts, done, n_iters, cfg.grad_tol, cg_iters,
                cfg.bf16_hessian)
        steps += 1
    if trace.active():
        trace.count("newton.chunk_steps", steps)
        trace.count("newton.row_steps", steps * B)
        trace.count("newton.doc_steps", n_iters)
        if cfg.pallas_iter:
            trace.count("newton.stalled", None)
    return eta, n_iters, done


def _newton_loop(beta_doc, counts, mu, eta0, siginv, cfg: NewtonConfig):
    """The whole Newton loop of a chunk in one kernel (``use_pallas``):
    (eta, n_iters).  Each document leaves the loop when it is done, so
    ``fixed_iters`` changes nothing.  Its steps and stalls are not
    counted (None while recording); the documents' advances are."""
    eta, n_iters = stages.newton_loop(beta_doc, _search_counts(counts, cfg), mu, eta0, siginv,
                                      _step_sizes(cfg, eta0), cfg.max_iters, cfg.grad_tol,
                                      min(cfg.cg_iters, beta_doc.shape[1] - 1),
                                      cfg.bf16_hessian)
    if trace.active():
        for name in ("newton.chunk_steps", "newton.row_steps", "newton.stalled",
                     "newton.capped"):
            trace.count(name, None)
        trace.count("newton.doc_steps", n_iters)
    return eta, n_iters


# ---------------------------------------------------------------------------
# finalize
# ---------------------------------------------------------------------------


def _by_rung(rung, doc_w):
    """(B, 4): the weighted documents by the rung of their factor."""
    rungs = torch.arange(1, 5, dtype=rung.dtype, device=rung.device)
    return (rung[:, None] == rungs) & (doc_w > 0)[:, None]


def _over_tol(grad_tol: float, g_max, doc_w):
    """(B,): the weighted documents whose max|g| exceeds ``grad_tol``."""
    return (g_max > grad_tol) & (doc_w > 0)


def _finalize_chunk(eta, beta_doc, counts, mu, doc_w, siginv, sigmaentropy, Nd,
                    grad_tol: Optional[float] = None):
    """Per-document theta, nu, bound and phi at the converged eta, all
    float32 (reference lower_bound / optimize_nu).  phi is (B, K, L) with
    (B, L, K) memory, the layout :func:`_scatter_phi` reads.  On the card
    three launches and no host read: the terms (``stages.finalize_terms``),
    the factor, the bound (``stages.finalize_bound``); on CPU tensors their
    plain versions.  Inside ``trace.recording()`` it times the factor on
    the device and counts the weighted documents by the rung of their
    factor and, given ``grad_tol``, those whose gradient here exceeds it."""
    g, H, theta, phi, terms = stages.finalize_terms(eta, beta_doc, counts, mu, doc_w, siginv,
                                                    Nd)
    full = trace.full()
    with trace.span("finalize.factor", H.device if full else None):
        L, nu, rung = stages.chol_pd_inverse(H)
    if full:
        trace.count("finalize.rungs", rung, doc_w, op=_by_rung)
        if grad_tol is not None:
            # max|g| (B,) is held to the record's end, not g (B, K-1)
            trace.count("finalize.unconverged",
                        torch.linalg.vector_norm(g, float("inf"), dim=1), doc_w,
                        op=functools.partial(_over_tol, grad_tol))
    nu, bound = stages.finalize_bound(L, nu, terms, sigmaentropy, doc_w)
    return theta, nu, bound, phi


# ---------------------------------------------------------------------------
# chunked E-step
# ---------------------------------------------------------------------------


def _local_word_ids(words, V_local: int, vocab: MeshAxis):
    """Global word ids on this rank's vocab block ``[r·V_local,
    (r+1)·V_local)`` -> (local ids, clamped into range, and the mask of
    the words the block owns)."""
    wl = words - vocab.rank * V_local
    ok = (wl >= 0) & (wl < V_local)
    return torch.where(ok, wl, 0), ok


def _gather_beta(beta, words, aspects=None, vocab: Optional[MeshAxis] = None):
    """Per-document topic-word slices (B, K, L) from beta (K, V), or from
    a content model's beta (A, K, V) and the documents' aspect levels
    ``aspects`` (B,): one gather either way, so the (B, K, V) block of
    ``beta[aspects]`` is never formed.

    With ``vocab``, ``beta`` is this rank's block of words: each rank
    gathers the columns it owns, zeros elsewhere, and one SUM over the
    vocab axis assembles the whole (B, K, L) block on every rank of the
    axis (each entry has one non-zero term, so the sum is exact)."""
    B, L = words.shape
    ok = None
    if vocab is not None:
        words, ok = _local_word_ids(words, beta.shape[-1], vocab)
    if beta.ndim == 2:
        K = beta.shape[0]
        cols = torch.index_select(beta, 1, words.reshape(-1).long())
        bd = cols.reshape(K, B, L).permute(1, 0, 2).contiguous()
    else:
        k = torch.arange(beta.shape[1], device=beta.device)
        bd = beta[aspects.long()[:, None, None], k[None, :, None], words.long()[:, None, :]]
    if ok is not None:
        bd = all_sum(torch.where(ok[:, None, :], bd, 0.0), vocab)
    return bd


def _scatter_phi(beta_ss, phi, words, aspects=None, vocab: Optional[MeshAxis] = None,
                 counts=None):
    """beta_ss[(aspect,) :, words] += phi for a whole chunk (in place), in
    a fixed order on every device: each key (the word; ``aspect·V + word``
    in a content model's (A, K, V) beta_ss; with ``vocab``, the word's id in
    this rank's block) takes its entries' phi one at a time in ascending
    flat position b·L + l, the order of the JAX package's XLA scatter, bit
    for bit (:func:`~strutopy_tpu_torch.ops.stages.scatter_phi`, a kernel
    on the card).  So the statistics are a function of (phi, words,
    aspects), whatever the device or the run.

    Entries that carry phi = +0 by construction are left out, which changes
    no bit of a column that holds no -0: slots with ``counts`` 0 (phi =
    phi_hat · counts; all slots count when ``counts`` is None) and, with
    ``vocab``, the words another rank owns (only the words this rank owns
    are added, with no collective).  phi may be (B, K, L) of any layout;
    the finalize's is entry-major and goes to the kernel as it is."""
    B, K, L = phi.shape
    plan = _scatter_plan(beta_ss, words, aspects, vocab, counts)
    return stages.scatter_phi(beta_ss, phi.transpose(1, 2).reshape(B * L, K), plan,
                              beta_ss.shape[-1])


def _scatter_plan(beta_ss, words, aspects=None, vocab: Optional[MeshAxis] = None,
                  counts=None):
    """The order of :func:`_scatter_phi`'s sums for a chunk: its keys,
    with the slots left out, through ``stages.scatter_plan``."""
    live = None if counts is None else counts > 0
    if vocab is not None:
        words, ok = _local_word_ids(words, beta_ss.shape[-1], vocab)
        live = ok if live is None else live & ok
    V = beta_ss.shape[-1]
    keys = words if beta_ss.ndim == 2 else aspects.to(words.dtype)[:, None] * V + words
    return stages.scatter_plan(keys, live, beta_ss.numel() // beta_ss.shape[-2])


def _chunks(n: int, B: int):
    return [slice(i, i + B) for i in range(0, n, B)]


class _StatsSum:
    """The E-step's sums over chunks, added in the order they come.
    ``grad_tol`` is the Newton solve's, for the finalize's count of
    unconverged documents while recording."""

    def __init__(self, beta, vocab: Optional[MeshAxis] = None,
                 grad_tol: Optional[float] = None):
        K = beta.shape[-2]
        self.vocab = vocab
        self.grad_tol = grad_tol
        self.beta_ss = torch.zeros_like(beta)
        self.sigma_ss = torch.zeros(K - 1, K - 1, dtype=beta.dtype, device=beta.device)
        self.bound = torch.zeros((), dtype=beta.dtype, device=beta.device)

    def finalize(self, eta, beta_doc, words, counts, aspects, mu, weight, siginv,
                 sigmaentropy, at: Optional[dict] = None):
        """Finalize one chunk at its eta, add its statistics with each
        document weighted by ``weight`` (bool: its doc_ok, or the subset a
        schedule finalizes here), and return its theta.  ``at``: the
        span's attributes (pass, chunk)."""
        dev = beta_doc.device
        with trace.span("estep.finalize", dev, at):
            theta, nu, bound_d, phi = _finalize_chunk(
                eta, beta_doc, counts, mu, weight.to(beta_doc.dtype), siginv,
                sigmaentropy, torch.sum(counts, dim=1), grad_tol=self.grad_tol)
            with trace.span("finalize.scatter"):
                _scatter_phi(self.beta_ss, phi, words, aspects, self.vocab, counts)
            self.sigma_ss = self.sigma_ss + torch.sum(nu, dim=0)
            self.bound = self.bound + torch.sum(bound_d)
        return theta


def _finalize_all(acc, beta, eta, mu, siginv, sigmaentropy, words, counts, aspects,
                  weight, B, pass_name: str = "3"):
    """Finalize every document in storage order, chunk by chunk, from a
    fresh gather of beta_doc, into ``acc`` (the two-pass schedule's pass
    3, and the fused schedule's overflow sweep): the documents' theta."""
    thetas = []
    for i, sl in enumerate(_chunks(words.shape[0], B)):
        at = {"pass": pass_name, "chunk": i, "rows": B}
        with trace.span("estep.gather", attrs=at):
            bd = _gather_beta(beta, words[sl], aspects[sl], acc.vocab)
        thetas.append(acc.finalize(eta[sl], bd, words[sl], counts[sl], aspects[sl], mu[sl],
                                   weight[sl], siginv, sigmaentropy, at))
    return torch.cat(thetas)


def _single_pass_estep(beta, mu, eta0, siginv, sigmaentropy, words, counts, aspects,
                       doc_ok, cfg: NewtonConfig, B: int,
                       use_pallas: bool, vocab: Optional[MeshAxis] = None) -> EStepResult:
    """One loop over the chunks: gather beta_doc once, solve, finalize
    (the JAX ``chunk_fn``).  With ``use_pallas`` the whole Newton loop of
    a chunk is one kernel, on the float32 gather whatever ``bf16_beta``
    says (as in JAX)."""
    acc = _StatsSum(beta, vocab, cfg.grad_tol)
    etas, thetas, iters = [], [], []
    for i, sl in enumerate(_chunks(words.shape[0], B)):
        at = {"pass": "single", "chunk": i, "rows": B}
        with trace.span("estep.gather", attrs=at):
            bd = _gather_beta(beta, words[sl], aspects[sl], vocab)
        with trace.span("estep.newton", beta.device, at):
            if use_pallas:
                eta, it = _newton_loop(bd, counts[sl], mu[sl], eta0[sl], siginv, cfg)
            else:
                eta, it, done = _batched_newton(_search_beta(bd, cfg), counts[sl], mu[sl],
                                                eta0[sl], siginv, cfg)
                if trace.full():
                    trace.count("newton.capped", done, doc_ok[sl], op=torch.lt)
        thetas.append(acc.finalize(eta, bd, words[sl], counts[sl], aspects[sl], mu[sl],
                                   doc_ok[sl], siginv, sigmaentropy, at))
        etas.append(eta)
        iters.append(it)
    overflow = torch.zeros((), dtype=torch.int32, device=words.device)
    return EStepResult(acc.beta_ss, acc.sigma_ss, acc.bound, torch.cat(etas),
                       torch.cat(thetas), torch.cat(iters), overflow)


def _newton_all(beta, mu, eta0, siginv, words, counts, aspects, cfg, B, done0=None,
                fin=None, vocab: Optional[MeshAxis] = None):
    """Newton over every chunk (the two-pass schedule's passes 1 and 2):
    (eta, n_iters, done, theta) for all documents.

    With ``fin = (acc, doc_ok, siginv, sigmaentropy)`` each chunk is also
    finalized at its new eta from the same gather (the fused schedule):
    in pass 1 (``done0`` None) the documents that converged, in pass 2
    those pass 1 left (``~done0``), converged or not; theta is returned
    for every document.  Without ``fin`` theta is None."""
    etas, iters, dones, thetas = [], [], [], []
    pass_name = "1" if done0 is None else "2"
    for i, sl in enumerate(_chunks(words.shape[0], B)):
        at = {"pass": pass_name, "chunk": i, "rows": B}
        with trace.span("estep.gather", attrs=at):
            bd = _gather_beta(beta, words[sl], aspects[sl], vocab)
        d0 = None if done0 is None else done0[sl]
        with trace.span("estep.newton", beta.device, at):
            eta, it, done = _batched_newton(
                _search_beta(bd, cfg), counts[sl], mu[sl], eta0[sl], siginv, cfg, done0=d0)
        if fin is not None:
            acc, doc_ok, *sig = fin
            weight = (done if d0 is None else ~d0) & doc_ok[sl]
            thetas.append(acc.finalize(eta, bd, words[sl], counts[sl], aspects[sl], mu[sl],
                                       weight, *sig, at))
        etas.append(eta)
        iters.append(it)
        dones.append(done)
    return (torch.cat(etas), torch.cat(iters), torch.cat(dones),
            torch.cat(thetas) if thetas else None)


def _straggler_budget(done, doc_ok, N: int, B: int, straggler_frac: float):
    """Pass 2's rows: ``idx``, the first M = ``straggler_frac`` x N (whole
    chunks, at least one) of a stable ascending sort of ``done``, so the
    unconverged documents pack to the front in storage order, as
    ``jnp.argsort`` does; and the unconverged real documents it leaves
    out (``over``).  Inside ``trace.recording()`` it counts the
    unconverged real documents it admits (``estep.stragglers``) and leaves
    out (``estep.overflow``)."""
    with trace.span("estep.budget"):
        M = min(max(-(-int(straggler_frac * N) // B) * B, B), N)
        idx = torch.argsort(done.to(torch.int32), stable=True)[:M]
        selected = torch.zeros(N, dtype=torch.bool, device=done.device)
        selected[idx] = True
        over = ~done & ~selected & doc_ok
        if trace.full():
            trace.count("estep.stragglers", done, selected & doc_ok, op=torch.lt)
            trace.count("estep.overflow", over)
    return idx, over


def _count_capped(done, doc_ok, idx=None, done2=None) -> None:
    """Inside ``trace.recording()``, count the real documents still not
    done when their last Newton pass ended (``done`` after pass 1,
    ``done2`` after pass 2 for the rows ``idx``)."""
    if trace.full():
        if idx is not None:
            done = done.clone()
            done[idx] = done2
        trace.count("newton.capped", done, doc_ok, op=torch.lt)


def _two_pass_estep(beta, mu, eta0, siginv, sigmaentropy, words, counts, aspects,
                    doc_ok, cfg: NewtonConfig, B: int, pass1_iters: int,
                    straggler_frac: float, vocab: Optional[MeshAxis] = None) -> EStepResult:
    """Two-pass difficulty schedule (twin of ``_two_pass_estep``).

      pass 1  caps every chunk at ``pass1_iters`` Newton steps;
      pass 2  packs the unconverged documents densely (a budget of
              ``straggler_frac`` x N, rounded up to whole chunks) and
              runs them on with the remaining iteration budget;
      pass 3  finalizes every document in storage order.

    Each Newton step is a pure per-document function of eta, so the
    trajectories equal the single-pass ones; documents beyond the budget
    keep their pass-1 eta and are counted in ``straggler_overflow``.
    """
    N = words.shape[0]
    cfg1 = cfg._replace(max_iters=min(pass1_iters, cfg.max_iters))
    eta, iters, done, _ = _newton_all(beta, mu, eta0, siginv, words, counts, aspects,
                                       cfg1, B, vocab=vocab)

    rest = cfg.max_iters - cfg1.max_iters
    overflow = torch.zeros((), dtype=torch.int32, device=words.device)
    if rest > 0:
        idx, over = _straggler_budget(done, doc_ok, N, B, straggler_frac)
        overflow = torch.sum(over).to(torch.int32)
        eta2, it2, done2, _ = _newton_all(
            beta, mu[idx], eta[idx], siginv, words[idx], counts[idx], aspects[idx],
            cfg._replace(max_iters=rest), B, done0=done[idx], vocab=vocab)
        eta[idx] = eta2  # eta and iters are fresh tensors (torch.cat)
        iters[idx] += it2
        _count_capped(done, doc_ok, idx, done2)
    else:
        _count_capped(done, doc_ok)

    acc = _StatsSum(beta, vocab, cfg.grad_tol)
    theta = _finalize_all(acc, beta, eta, mu, siginv, sigmaentropy, words, counts, aspects,
                          doc_ok, B)
    return EStepResult(acc.beta_ss, acc.sigma_ss, acc.bound, eta, theta, iters, overflow)


def _two_pass_fused_estep(beta, mu, eta0, siginv, sigmaentropy, words, counts, aspects,
                          doc_ok, cfg: NewtonConfig, B: int, pass1_iters: int,
                          straggler_frac: float,
                          vocab: Optional[MeshAxis] = None) -> EStepResult:
    """The two-pass schedule with the finalize riding the Newton gathers
    (twin of ``_two_pass_fused_estep``; ``cfg.max_iters > pass1_iters``).

      pass 1    capped Newton, then the finalize of the documents that
                converged, from the same gather; theta of every document;
      pass 2    the stragglers' Newton, then the finalize of every document
                of the budget that pass 1 did not finalize;
      overflow  if the budget left unconverged documents out, one masked
                finalize sweep over all chunks at their pass-1 eta (the JAX
                ``lax.cond``; one host read of the count here).

    Pass 3's full re-gather of beta_doc goes, at the cost of finalizing
    the budget's documents anew.  The Newton trajectories are the unfused
    schedule's bit for bit (the same chunks through the same kernels);
    only the float32 summation order of the statistics differs.
    """
    N = words.shape[0]
    cfg1 = cfg._replace(max_iters=min(pass1_iters, cfg.max_iters))
    acc = _StatsSum(beta, vocab, cfg.grad_tol)
    eta, iters, done, theta = _newton_all(beta, mu, eta0, siginv, words, counts, aspects,
                                          cfg1, B, fin=(acc, doc_ok, siginv, sigmaentropy),
                                          vocab=vocab)

    idx, over = _straggler_budget(done, doc_ok, N, B, straggler_frac)
    overflow = torch.sum(over).to(torch.int32)
    done0 = done[idx]
    eta2, it2, done2, theta2 = _newton_all(
        beta, mu[idx], eta[idx], siginv, words[idx], counts[idx], aspects[idx],
        cfg._replace(max_iters=cfg.max_iters - cfg1.max_iters), B, done0=done0,
        fin=(acc, doc_ok[idx], siginv, sigmaentropy), vocab=vocab)
    # a done document's pass-2 eta is its frozen pass-1 eta, so the set is
    # unconditional; theta only where pass 2 finalized
    eta[idx] = eta2  # eta, theta and iters are fresh tensors (torch.cat)
    theta[idx] = torch.where(done0[:, None], theta[idx], theta2)
    iters[idx] += it2
    _count_capped(done, doc_ok, idx, done2)

    if trace.read("estep.overflow", int, overflow) > 0:
        _finalize_all(acc, beta, eta, mu, siginv, sigmaentropy, words, counts, aspects, over, B,
                      "overflow")
    return EStepResult(acc.beta_ss, acc.sigma_ss, acc.bound, eta, theta, iters, overflow)


def run_estep(beta, mu, eta0, siginv, sigmaentropy, words, counts, aspects, doc_ok,
              cfg: NewtonConfig = NewtonConfig(), batch_size: int = 1024,
              use_pallas: bool = False, pallas_block: Optional[int] = None,
              vocab: Optional[MeshAxis] = None, pass1_iters: int = 0,
              straggler_frac: float = 0.3, scan_unroll: int = 1,
              fused_finalize: bool = False) -> EStepResult:
    """E-step over a corpus (twin of ``strutopy_tpu/ops/estep.py::run_estep``,
    its arguments in the same order).

    Args:
      beta: (K, V) topic-word distributions, or (A, K, V) for a content
        model.
      mu: (N, K-1) prior means; eta0: (N, K-1) warm starts.
      siginv, sigmaentropy: from :func:`~strutopy_tpu_torch.ops.linalg.precompute_sigma`.
      words/counts: (N, L) padded corpus arrays (int32 / float32).
      aspects: (N,) int32 content-covariate levels (zeros if unused).
      doc_ok: (N,) bool mask; False rows are padding documents.
      batch_size: documents per chunk; N must be a multiple.
      pass1_iters: > 0 enables the two-pass schedule.
      use_pallas: the whole Newton loop of a chunk as one kernel
        (``stages.newton_loop``); incompatible with ``pass1_iters``.
      pallas_block, scan_unroll: TPU-only (JAX's whole-loop kernel's
        block and its scan's unroll); any value but JAX's default raises.
      fused_finalize: with the two-pass schedule, finalize inside passes 1
        and 2 (:func:`_two_pass_fused_estep`), without pass 3's re-gather.
        No-op when ``pass1_iters`` is 0 or leaves no pass-2 budget.
      vocab: under a vocabulary-sharded mesh, the vocab axis; ``beta`` is
        then this rank's block of words and the returned ``beta_ss`` too.
        Every rank of the axis holds the same documents, so the Newton
        loops, the straggler budget and the overflow sweep take the same
        branches on each and the per-chunk all-reduces pair up.
    """
    if pallas_block is not None:
        refuse_tpu_only("pallas_block", pallas_block)
    refuse_tpu_only("scan_unroll", scan_unroll)
    N = words.shape[0]
    B = min(batch_size, N)
    if N % B != 0:
        raise ValueError(f"N={N} must be a multiple of batch_size={B}; pad the corpus")
    if pass1_iters and use_pallas:
        raise ValueError(
            "pass1_iters (two-pass schedule) is incompatible with "
            "use_pallas (the whole-loop kernel owns its iteration control)"
        )
    if pass1_iters:
        impl = (_two_pass_fused_estep if fused_finalize and cfg.max_iters > pass1_iters
                else _two_pass_estep)
        return impl(beta, mu, eta0, siginv, sigmaentropy, words, counts, aspects, doc_ok, cfg,
                    B, pass1_iters, straggler_frac, vocab)
    return _single_pass_estep(beta, mu, eta0, siginv, sigmaentropy, words, counts,
                              aspects, doc_ok, cfg, B, use_pallas, vocab)
