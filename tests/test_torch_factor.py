"""The finalize's factor (strutopy_tpu_torch/ops/stages.py::chol_pd_inverse,
csrc/factor.cu): on CPU tensors the PD-repair ladder and
``torch.cholesky_inverse`` exactly as ``_finalize_chunk`` ran them before the
kernel; on the card the kernel against that plain version (the ``cuda``
tests, which chip_smoke.py's phase 2e repeats at the fit's shapes).

This file imports no JAX: on the card it runs with
``python -m pytest --noconftest tests/test_torch_factor.py -m cuda``."""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from strutopy_tpu_torch.ops import estep, stages
from strutopy_tpu_torch.utils import trace
from torch_world import one_thread


@pytest.fixture(autouse=True, scope="module")
def _torch_on_one_thread():
    with one_thread():
        yield


def _spd(rng, B, P):
    """Hessian-like SPD matrices: a Gram matrix of 2P random columns plus a
    ridge, condition numbers in the tens."""
    A = rng.normal(0, 1, (B, P, 2 * P))
    H = A @ A.transpose(0, 2, 1) / (2 * P) + 0.1 * np.eye(P)
    return H.astype(np.float32)


PLANTED_RUNGS = cs.FACTOR_PLANTED_RUNGS


def _planted(P):
    """(5, P, P) float32: chip_smoke.py's planted batch, which takes rungs
    1-4 and then fails all four (an all-NaN matrix)."""
    return cs.factor_planted(torch, P, device="cpu").numpy()


def _same(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(torch.int32) if a.dtype == torch.float32 else a,
        b.view(torch.int32) if b.dtype == torch.float32 else b)


# ---------------------------------------------------------------------------
# CPU: the plain route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["spd", "planted", "one"])
def test_cpu_route_is_the_ladder_and_cholesky_inverse(case):
    """On CPU tensors chol_pd_inverse is the ladder then torch.cholesky_inverse,
    bit for bit; the factor-only mode is its factor, twice the same; nothing
    is launched."""
    rng = np.random.default_rng(0)
    H = torch.tensor({"spd": lambda: _spd(rng, 16, 12), "planted": lambda: _planted(7),
                      "one": lambda: _spd(rng, 3, 1)}[case]())
    n0 = dict(stages.LAUNCHES)
    L, nu, rung = stages.chol_pd_inverse(H)
    L_want, rung_want = stages.chol_pd_plain(H)
    assert _same(L, L_want) and _same(rung, rung_want)
    assert _same(nu, torch.cholesky_inverse(L_want))
    L2, nu2, rung2 = stages.chol_pd_inverse(H, inverse=False)
    assert nu2 is None and _same(L2, L_want) and _same(rung2, rung_want)
    L3, _nu3, rung3 = stages.chol_pd_inverse(H, inverse=False)
    assert _same(L3, L_want) and _same(rung3, rung_want)
    assert stages.LAUNCHES == n0
    if case == "planted":
        assert rung.tolist() == PLANTED_RUNGS
        assert torch.isnan(L[4]).all() and torch.isnan(nu[4]).all()
        assert torch.isfinite(L[:4]).all() and torch.isfinite(nu[:4]).all()


@pytest.mark.parametrize("plant", [False, True])
def test_cpu_route_reads_the_rung_and_the_inverse(plant):
    """The CPU route keeps both host reads, once a call each, and counts a
    chunk in repair_chunks only where a document needed a repair rung."""
    rng = np.random.default_rng(1)
    H = _spd(rng, 8, 6)
    if plant:
        H[5] = -H[5]
    with trace.recording(), trace.span("test") as rec:
        stages.chol_pd_inverse(torch.tensor(H))
    rec.resolve()
    assert rec.syncs["finalize.rung"][0] == rec.syncs["finalize.cholesky_inverse"][0] == 1
    assert rec.counters["finalize.repair_chunks"] == int(plant)


@pytest.mark.parametrize("jitter,rel_jitter,rung,finite",
                         [(1e-5, 1e-3, 4, True), (0.5, 1e-3, 3, True), (1e-5, 0.0, 4, False)])
def test_cpu_route_passes_the_jitters_on(jitter, rel_jitter, rung, finite):
    """The ladder's two jitters reach the plain version: a fixed jitter of
    0.5 factors the 1e6 block at rung 3; with no relative one it fails all."""
    H = torch.tensor(_planted(5))
    L, _nu, got = stages.chol_pd_inverse(H, jitter=jitter, rel_jitter=rel_jitter)
    assert _same(got, stages.chol_pd_plain(H, jitter, rel_jitter)[1])
    assert int(got[3]) == rung and bool(torch.isfinite(L[3]).all()) == finite


def test_factor_wrapper_rejects_devices_without_a_kernel():
    with pytest.raises(ValueError, match="no kernel"):
        stages.chol_pd_inverse(torch.eye(3, device="meta")[None])


@pytest.mark.parametrize("fault,failed", [
    (None, set()),
    ("nu", {"nu within rtol", "nu err <= 2x plain's"}),
    ("rung", {"rungs"}),
    ("asymmetric", {"nu symmetric"}),
])
def test_phase_2e_checks_pass_plain_and_fail_a_wrong_factor(monkeypatch, fault, failed):
    """chip_smoke.py's phase 2e verdict on the CPU: the plain version in the
    kernel's place passes every check; a factor whose nu is off by 1%, whose
    rung is off by one, or whose nu is off its symmetry by one rounding fails
    just the checks that see it."""
    real = stages.chol_pd_inverse_plain

    def kernel(H, inverse=True, jitter=1e-5, rel_jitter=1e-3):
        stages.LAUNCHES["factor"] += 1
        L, nu, rung = real(H, inverse, jitter, rel_jitter)
        if nu is not None and fault == "nu":
            nu = nu * 1.01
        if nu is not None and fault == "asymmetric":
            nu = nu.clone()
            nu[0, 0, 1] = torch.nextafter(nu[0, 0, 1], torch.tensor(np.inf))
        if fault == "rung":
            rung = rung.clone()
            rung[0] += 1
        return L, nu, rung

    monkeypatch.setitem(stages.LAUNCHES, "factor", 0)
    monkeypatch.setattr(stages, "chol_pd_inverse", kernel)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    H = torch.tensor(np.concatenate([_spd(np.random.default_rng(13), 11, 9), _planted(9)]))
    checks, out = cs.factor_verdict(torch, stages, H)
    assert {name for name, ok in checks.items() if not ok} == failed
    assert out["rungs"] == [12, 1, 1, 2] if fault != "rung" else out["rungs"][0] == 11


# ---------------------------------------------------------------------------
# the card: the kernel against the plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py phase 2e runs these checks on the card)")
    return torch.device("cuda")


def _smem_boundary():
    """The largest P whose triangle the kernel keeps in shared memory."""
    return max(P for P in range(1, 513) if stages.factor_plan(P)["in_smem"])


def _check_against_plain(H):
    """The kernel's (L, nu, rung) against the plain version's on the card:
    rungs equal, NaN where plain has NaN, finite entries within float32
    rounding of a factorization in another order."""
    L, nu, rung = stages.chol_pd_inverse(H)
    Lp, nup, rungp = stages.chol_pd_inverse_plain(H)
    torch.cuda.synchronize()
    assert _same(rung, rungp)
    for got, want, rtol in ((L, Lp, 1e-4), (nu, nup, 2e-3)):
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan)
        scale = torch.where(nan, 0.0, want).abs().amax(dim=(1, 2), keepdim=True)
        err = torch.where(nan, 0.0, (got - want).abs())
        assert bool((err <= rtol * scale).all()), float((err / scale.clamp_min(1e-30)).max())
    assert torch.equal(L, L.tril()) or torch.isnan(L).any()
    return L, nu, rung


@pytest.mark.cuda
@pytest.mark.parametrize("B,P", [(256, 99), (256, 19), (16, 1), (16, 2), (16, 31), (16, 32),
                                 (16, 33), (16, 199), (16, 511), (16, "boundary"),
                                 (16, "boundary+1"), (256, 399), (16, 241), (16, 300),
                                 (64, 511)])
def test_cuda_factor_matches_plain(card, B, P):
    if isinstance(P, str):
        P = _smem_boundary() + (P == "boundary+1")
    rng = np.random.default_rng(P)
    H = torch.tensor(_spd(rng, B, P), device=card)
    n0 = stages.LAUNCHES["factor"]
    _L, nu, rung = _check_against_plain(H)
    assert stages.LAUNCHES["factor"] == n0 + 1
    assert (rung == 1).all() and torch.equal(nu, nu.transpose(1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("P", [3, 19, 99, 400])
def test_cuda_factor_takes_the_planted_rungs(card, P):
    _L, _nu, rung = _check_against_plain(torch.tensor(_planted(P), device=card))
    assert rung.tolist() == PLANTED_RUNGS


@pytest.mark.cuda
@pytest.mark.parametrize("P", [99, 399])
def test_cuda_factor_is_bit_equal_run_to_run(card, P):
    """Two launches give the same bits: the smem plan (P=99) and the blocked
    plan (P=399), whose sums have a fixed order and no atomics."""
    H = torch.tensor(np.concatenate([_spd(np.random.default_rng(3), 251, P), _planted(P)]),
                     device=card)
    a = stages.chol_pd_inverse(H)
    b = stages.chol_pd_inverse(H)
    assert all(_same(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("P", [19, 99, 399, "k400 optimum"])
def test_cuda_nu_error_at_most_twice_plain(card, P):
    """nu against the float64 inverse of the same float32 H, in relative
    Frobenius norm over the chunk: the kernel's error is at most twice the
    library pair's.  "k400 optimum": the Hessians of a K=400 chunk at its
    Newton optimum (V=50,000, 300 tokens), where summing each entry of nu
    one term at a time over ~400 terms reads ~2.6x the pair's."""
    if P == "k400 optimum":
        H = cs.content_shaped_hessians(torch, stages, B=64, K=400, V=50_000, words=300,
                                       seed=400, device=card)
    else:
        H = torch.tensor(_spd(np.random.default_rng(5), 256, P), device=card)
    want = torch.linalg.inv(H.double())
    err = {}
    for name, nu in (("kernel", stages.chol_pd_inverse(H)[1]),
                     ("plain", stages.chol_pd_inverse_plain(H)[1])):
        err[name] = float(torch.linalg.norm(nu.double() - want) / torch.linalg.norm(want))
    assert err["kernel"] <= 2 * err["plain"], err


@pytest.mark.cuda
@pytest.mark.parametrize("P", [99, 399])
def test_cuda_factor_only_mode(card, P):
    H = torch.tensor(np.concatenate([_spd(np.random.default_rng(7), 27, P), _planted(P)]),
                     device=card)
    L, nu, rung = stages.chol_pd_inverse(H, inverse=False)
    Lp, rungp = stages.chol_pd_plain(H)
    assert nu is None and _same(rung, rungp)
    assert torch.equal(torch.isnan(L), torch.isnan(Lp))
    assert _same(L, stages.chol_pd_inverse(H)[0])  # the same factor as with nu
    L2, _nu2, rung2 = stages.chol_pd_inverse(H, inverse=False)  # a second launch: the same bits
    assert _same(L2, L) and _same(rung2, rung)


@pytest.mark.cuda
def test_cuda_finalize_chunk_reads_nothing_for_its_factor(card):
    """A recorded _finalize_chunk on the card: no finalize.rung or
    finalize.cholesky_inverse sync, one factor launch a call, and
    repair_chunks counted on the device."""
    rng = np.random.default_rng(11)
    B, K, L = 32, 20, 64
    beta = rng.dirichlet(np.ones(300), size=K)
    words = np.stack([rng.choice(300, L, replace=False) for _ in range(B)])
    T = lambda a: torch.tensor(np.asarray(a, np.float32), device=card)  # noqa: E731
    bd = T(np.stack([beta[:, w] for w in words]))
    counts = T(rng.integers(0, 4, (B, L)))
    eta, mu = T(rng.normal(0, 0.5, (B, K - 1))), T(rng.normal(0, 0.3, (B, K - 1)))
    siginv = torch.eye(K - 1, device=card)
    n0 = stages.LAUNCHES["factor"]
    with trace.recording(), trace.span("test") as rec:
        for _ in range(3):
            estep._finalize_chunk(eta, bd, counts, mu, torch.ones(B, device=card), siginv,
                                  torch.zeros((), device=card), counts.sum(1))
    rec.resolve()
    assert stages.LAUNCHES["factor"] - n0 == rec.counters["launch.factor"] == 3
    assert "finalize.rung" not in rec.syncs and "finalize.cholesky_inverse" not in rec.syncs
    rungs = rec.counters["finalize.rungs"]
    assert sum(rungs) == 3 * B
    assert rec.counters["finalize.repair_chunks"] == (3 if sum(rungs[1:]) else 0)


@pytest.mark.cuda
def test_cuda_factor_wrapper_rejects_what_the_kernel_does_not_take(card):
    H = torch.eye(8, device=card).repeat(2, 1, 1)
    with pytest.raises(ValueError, match="contiguous"):
        stages.chol_pd_inverse(H.transpose(0, 1))
    with pytest.raises(ValueError, match="float32"):
        stages.chol_pd_inverse(H.double())
    with pytest.raises(ValueError, match=r"\(B, P, P\)"):
        stages.chol_pd_inverse(H[:, :, :4].contiguous())
    with pytest.raises(ValueError, match="1 to 512"):
        stages.chol_pd_inverse(torch.eye(513, device=card)[None])
