"""The E-step finalize (strutopy_tpu_torch/ops/estep.py::_finalize_chunk,
ops/stages.py::finalize_terms and finalize_bound, csrc/stages.cu's
finalize_kernel and finalize_bound_kernel): on CPU tensors the PyTorch
composition the port ran before its kernel, bit for bit; on the card Z, F and
the epilogue against the plain finalize (the ``cuda`` tests, which
chip_smoke.py's phase 2f repeats at the fit's shapes).

This file imports no JAX: on the card it runs with
``python -m pytest --noconftest tests/test_torch_finalize.py -m cuda``."""

import pytest
import torch

import chip_smoke as cs
from strutopy_tpu_torch.ops import build, estep, stages
from strutopy_tpu_torch.utils import trace
from torch_world import one_thread


@pytest.fixture(autouse=True, scope="module")
def _torch_on_one_thread():
    with one_thread():
        yield


def parent_finalize(eta, beta_doc, counts, mu, doc_w, siginv, sigmaentropy, Nd):
    """``_finalize_chunk`` as the port composed it in PyTorch before its
    kernel, frozen here: (theta, nu, bound, phi)."""
    _f, g, H, theta, phi_hat = stages.f_g_H_batched(
        eta, beta_doc, counts, mu, siginv, Nd, bf16=False)
    L, nu, rung = stages.chol_pd_inverse(H)

    eta_full = stages.pad_eta(eta)
    m = torch.amax(eta_full, dim=1, keepdim=True)
    e = torch.exp(eta_full - m)
    t_l = torch.bmm((theta * e)[:, None, :], beta_doc)[:, 0]
    t_l = torch.clamp_min(t_l, 1e-35)
    cmask = counts > 0
    loglik = torch.sum(torch.where(cmask, counts * (torch.log(t_l) + m), 0.0), dim=1)
    detTerm = -torch.sum(torch.log(torch.diagonal(L, dim1=1, dim2=2)), dim=1)
    diff = eta - mu
    quad = 0.5 * torch.sum((diff @ siginv) * diff, dim=1)
    bound = loglik + detTerm - quad - sigmaentropy

    B, K, L = phi_hat.shape
    phi = torch.empty(B, L, K, dtype=phi_hat.dtype, device=phi_hat.device).transpose(1, 2)
    torch.mul(phi_hat, counts[:, None, :], out=phi)
    nu = doc_w[:, None, None] * nu
    bound = doc_w * bound
    phi.mul_(doc_w[:, None, None])
    return theta, nu, bound, phi


CASES = {  # (B, K, L, seed, A): the toy width, and beta_doc from an (A=2, K, V) gather
    "toy": (10, 6, 40, 3, 0),
    "content": (12, 6, 40, 5, 2),
}


def _args(case, device="cpu"):
    B, K, L, seed, A = CASES[case]
    return cs.finalize_inputs(torch, B, K, L, seed, A=A, device=device)


def _same(a, b):
    return (a.shape == b.shape and a.stride() == b.stride()
            and torch.equal(a.view(torch.int32), b.view(torch.int32)))


# ---------------------------------------------------------------------------
# CPU: the plain route, bit for bit the parent's composition
# ---------------------------------------------------------------------------


def test_inputs_hold_what_the_checks_need():
    """Zero-weight documents, zero-count slots, a padding row."""
    eta, bd, c, mu, w, siginv, se, Nd = _args("content")
    assert float(c[-1].abs().sum()) == 0.0 and float(w[-1]) == 0.0
    assert 0 < int((w == 0).sum()) < w.shape[0] and bool((c[:-1] == 0).any())
    assert bd.shape == (12, 6, 40) and se.ndim == 0 and _same(Nd, c.sum(1))


@pytest.mark.parametrize("case", sorted(CASES))
def test_cpu_finalize_chunk_is_the_parent_composition(case):
    """On CPU tensors _finalize_chunk gives the parent's theta, nu, bound
    and phi bit for bit (phi's entry-major strides too), and launches
    nothing."""
    args = _args(case)
    n0 = dict(stages.LAUNCHES)
    got = estep._finalize_chunk(*args)
    assert stages.LAUNCHES == n0
    for a, b in zip(got, parent_finalize(*args)):
        assert _same(a, b)


@pytest.mark.parametrize("case", sorted(CASES))
def test_cpu_plain_pieces_are_the_parent_composition(case):
    """finalize_terms_plain, the plain factor and finalize_bound_plain: the
    parent's outputs bit for bit, and f_g_H_batched's g and H."""
    eta, bd, c, mu, w, siginv, se, Nd = args = _args(case)
    g, H, theta, phi, terms = stages.finalize_terms_plain(eta, bd, c, mu, w, siginv, Nd)
    _f, g_want, H_want, _theta, _phi = stages.f_g_H_batched(eta, bd, c, mu, siginv, Nd,
                                                            bf16=False)
    assert _same(g, g_want) and _same(H, H_want) and terms.shape == (eta.shape[0], 2)
    L, nu, _rung = stages.chol_pd_inverse_plain(H)
    nu, bound = stages.finalize_bound_plain(L, nu, terms, se, w)
    for a, b in zip((theta, nu, bound, phi), parent_finalize(*args)):
        assert _same(a, b)


@pytest.mark.parametrize("case", sorted(CASES))
def test_cpu_wrappers_take_the_plain_route(case):
    """finalize_terms and finalize_bound on CPU tensors are their plain
    versions."""
    eta, bd, c, mu, w, siginv, se, Nd = _args(case)
    for a, b in zip(stages.finalize_terms(eta, bd, c, mu, w, siginv, Nd),
                    stages.finalize_terms_plain(eta, bd, c, mu, w, siginv, Nd)):
        assert _same(a, b)
    g, H, theta, phi, terms = stages.finalize_terms_plain(eta, bd, c, mu, w, siginv, Nd)
    L, nu, _rung = stages.chol_pd_inverse_plain(H)
    for a, b in zip(stages.finalize_bound(L, nu, terms, se, w),
                    stages.finalize_bound_plain(L, nu, terms, se, w)):
        assert _same(a, b)


# ---------------------------------------------------------------------------
# CPU: chip_smoke.py's verdict passes the plain route and fails planted faults
# ---------------------------------------------------------------------------


FAULTS = ("none", "theta", "phi", "bound", "nu weight", "H", "loglik", "launch")


def _planted_route(monkeypatch, fault):
    """_finalize_chunk and finalize_terms on the CPU as the card's route
    would run them (the plain pieces, one count of each launch), with
    ``fault`` planted."""
    def terms_fn(eta, bd, c, mu, w, siginv, Nd):
        g, H, theta, phi, terms = stages.finalize_terms_plain(eta, bd, c, mu, w, siginv, Nd)
        if fault == "H":
            H = H.clone()
            H[0, 1, 0] += 1e-3 * float(H[0, 1, 0].abs()) + 1e-3
        if fault == "loglik":
            terms = terms.clone()
            terms[0, 0] *= 1.0 + 1e-3
        return g, H, theta, phi, terms

    def route(eta, bd, c, mu, w, siginv, se, Nd, grad_tol=None):
        for k in cs.FINALIZE_KEYS:
            stages.LAUNCHES[k] += 1 if (k != "finalize_bound" or fault != "launch") else 0
        g, H, theta, phi, terms = stages.finalize_terms_plain(eta, bd, c, mu, w, siginv, Nd)
        L, nu, _rung = stages.chol_pd_inverse_plain(H)
        nu, bound = stages.finalize_bound_plain(L, nu, terms, se,
                                                torch.ones_like(w) if fault == "nu weight" else w)
        if fault == "nu weight":
            bound = w * bound
        if fault == "theta":
            theta = theta.clone()
            theta[1, 2] *= 1.0 + 1e-4
        if fault == "phi":
            phi = phi.clone()
            live = torch.nonzero(phi[1] != 0)[0]
            phi[1, live[0], live[1]] *= 1.0 + 1e-4
        if fault == "bound":
            bound = bound.clone()
            bound[1] += 1e-2 * float(bound[1].abs())
        return theta, nu, bound, phi

    monkeypatch.setattr(stages, "finalize_terms", terms_fn)
    monkeypatch.setattr(estep, "_finalize_chunk", route)


@pytest.mark.parametrize("fault", FAULTS)
def test_verdict_passes_the_plain_route_and_fails_each_fault(monkeypatch, fault):
    args = _args("toy")
    _planted_route(monkeypatch, fault)
    checks, out = cs.finalize_verdict(torch, stages, estep, args)
    failed = {name for name, ok in checks.items() if not ok}
    want = {"none": set(), "theta": {"theta within its allowance"},
            "phi": {"phi within its allowance"}, "bound": {"bound within its allowance"},
            "nu weight": {"nu within its allowance"}, "H": {"H within its allowance"},
            "loglik": {"loglik within its allowance"}, "launch": {"launches"}}[fault]
    assert failed == want, (checks, out)


# ---------------------------------------------------------------------------
# the card: Z, F and the epilogue against the plain finalize
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py phase 2f runs these checks on the card)")
    return torch.device("cuda")


SHAPES = [  # (B, K, L, A): the k100 chunk, the content cell's width, an odd L, B1's tile
    (256, 100, 384, 0),  # groups (K=200) and K=400 (the largest K: its own test below)
    (64, 20, 160, 2),
    (64, 20, 201, 0),
    (16, 200, 96, 0),
    (8, 400, 64, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,L,A", SHAPES)
def test_cuda_finalize_matches_plain(card, B, K, L, A):
    """Every output within FINALIZE_RTOL of its float32 terms' magnitudes,
    one launch of Z, F and the epilogue a call, two calls bit-equal."""
    args = cs.finalize_inputs(torch, B, K, L, seed=K + L, A=A, device=card)
    checks, out = cs.finalize_verdict(torch, stages, estep, args)
    assert all(checks.values()), (checks, out)


@pytest.mark.cuda
def test_cuda_finalize_takes_beta_doc_of_any_layout(card):
    """A beta_doc of another layout gives the bits of its contiguous copy."""
    eta, bd, c, mu, w, siginv, se, Nd = cs.finalize_inputs(torch, 16, 20, 64, seed=9,
                                                           device=card)
    other = bd.transpose(1, 2).contiguous().transpose(1, 2)
    assert not other.is_contiguous()
    for a, b in zip(estep._finalize_chunk(eta, other, c, mu, w, siginv, se, Nd),
                    estep._finalize_chunk(eta, bd, c, mu, w, siginv, se, Nd)):
        assert _same(a, b)


@pytest.mark.cuda
def test_cuda_finalize_reads_nothing(card):
    """Recorded calls on the card: no sync of any site, and launch.finalize
    = launch.factor = launch.finalize_bound = the calls."""
    args = cs.finalize_inputs(torch, 64, 20, 160, seed=7, device=card)
    with trace.recording(), trace.span("test") as rec:
        for _ in range(3):
            estep._finalize_chunk(*args, grad_tol=1e-5)
    rec.resolve()
    assert not rec.syncs
    assert all(rec.counters[f"launch.{k}"] == 3 for k in cs.FINALIZE_KEYS)
    assert sum(rec.counters["finalize.rungs"]) == 3 * int((args[4] > 0).sum())


def _b1_default_max_k():
    """The largest K of B1's default mode (bf16 operand, float32 beta_doc),
    the E-step's Newton limit on this card."""
    lib = build.load()
    return max(K for K in range(2, 1025) if lib.stm_fgh_smem(K, 1, 0) > 0)


@pytest.mark.cuda
def test_cuda_finalize_runs_at_the_largest_k_of_b1s_default_mode(card):
    """Wherever B1's default mode has a plan, Z has one; at the largest such
    K (Z without its phi stage) Z, F and the epilogue pass the verdict."""
    k_max = _b1_default_max_k()
    assert all(stages.finalize_plan(K) is not None for K in range(2, k_max + 1))
    assert not stages.finalize_plan(k_max)["stage"]
    args = cs.finalize_inputs(torch, 4, k_max, 64, seed=k_max, device=card)
    checks, out = cs.finalize_verdict(torch, stages, estep, args)
    assert all(checks.values()), (checks, out)


@pytest.mark.cuda
def test_cuda_finalize_plans_and_what_the_wrappers_refuse(card):
    plan = stages.finalize_plan(100)
    assert (plan["W"], plan["stages"], plan["blocks_per_sm"], plan["stage"]) == (32, 3, 2, True)
    assert stages.finalize_plan(20)["stage"] and stages.finalize_plan(400)["stage"]
    assert stages.finalize_plan(1) is None and stages.finalize_plan(1024) is None
    eta, bd, c, mu, w, siginv, se, Nd = cs.finalize_inputs(torch, 4, 8, 32, seed=1, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        stages.finalize_terms(eta, bd, c.t().contiguous().t(), mu, w, siginv, Nd)
    with pytest.raises(ValueError, match="shape"):
        stages.finalize_terms(eta, bd, c, mu, w[:2], siginv, Nd)
    with pytest.raises(ValueError, match="float32"):
        stages.finalize_terms(eta, bd, c.double(), mu, w, siginv, Nd)
