"""The port's three Newton stages (strutopy_tpu_torch/ops/stages.py)
against the JAX package: the XLA twins in ops/estep.py and the Pallas
kernels in ops/pallas_stages.py run in interpret mode, as
tests/test_pallas_stages.py runs them.  On CPU tensors the port's
wrappers run their plain PyTorch versions; the CUDA kernels themselves
are compared with those plain versions on the card (the ``cuda`` test
below, and chip_smoke.py)."""

import contextlib

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from strutopy_tpu.ops import estep as jax_estep
from strutopy_tpu.ops.pallas_stages import (
    pallas_cg_impl,
    pallas_fgh_impl,
    pallas_linesearch_impl,
)
import chip_smoke as cs
from strutopy_tpu_torch.ops import build, stages


def _chunk(seed=0, B=16, K=13, L=128):
    """One chunk of documents as numpy float32 (the inputs of
    tests/test_pallas_stages.py::_chunk)."""
    rng = np.random.default_rng(seed)
    beta = rng.dirichlet(np.ones(400), size=K)
    words = np.stack([rng.choice(400, L, replace=False) for _ in range(B)])
    beta_doc = np.stack([beta[:, w] for w in words]).astype(np.float32)
    counts = np.zeros((B, L), np.float32)
    n = min(40, L)
    counts[:, :n] = rng.integers(1, 5, (B, n))
    eta = rng.normal(0, 0.4, (B, K - 1)).astype(np.float32)
    mu = rng.normal(0, 0.3, (B, K - 1)).astype(np.float32)
    sig = np.diag(np.full(K - 1, 2.0)) + 0.3
    siginv = np.linalg.inv(sig).astype(np.float32)
    return dict(eta=eta, beta_doc=beta_doc, counts=counts, mu=mu, siginv=siginv)


def _jax(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _torch(d):
    return {k: torch.tensor(np.asarray(v)) for k, v in d.items()}


@pytest.mark.parametrize("bf16", [False, True])
def test_fgh_matches_jax(bf16):
    x = _chunk()
    j, t = _jax(x), _torch(x)
    Nd = jnp.sum(j["counts"], axis=1)
    xla = jax_estep._f_g_H_batched(j["eta"], j["beta_doc"], j["counts"], j["mu"],
                                   j["siginv"], Nd, bf16=bf16)[:3]
    pallas = pallas_fgh_impl(j["eta"], j["beta_doc"], j["counts"], j["mu"],
                             j["siginv"], bf16=bf16, interpret=True)
    f, g, H = stages.fgh(t["eta"], t["beta_doc"], t["counts"], t["mu"], t["siginv"],
                         bf16=bf16)
    # the tolerances of tests/test_pallas_stages.py: float32 sums in
    # another order; with bf16 a one-ulp difference before the operand
    # rounding can flip a bf16 rounding (relative 2^-8).  g's atol is
    # 1e-5, not 1e-6: g = sdiff + Nd·θ - q cancels terms of size Nd ~ 100,
    # whose float32 rounding in another summation order is ~1e-5 absolute
    # (measured 3.8e-6 on a component of 0.015)
    tol_H = 2e-2 if bf16 else 1e-5
    for f0, g0, H0 in (xla, pallas):
        np.testing.assert_allclose(f.numpy(), np.asarray(f0), rtol=1e-6)
        np.testing.assert_allclose(g.numpy(), np.asarray(g0), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(H.numpy(), np.asarray(H0), rtol=tol_H, atol=tol_H)


@pytest.mark.parametrize("bf16", [False, True])
def test_cg_matches_jax(bf16):
    x = _chunk(seed=1)
    j = _jax(x)
    Nd = jnp.sum(j["counts"], axis=1)
    _f, g, H, _, _ = jax_estep._f_g_H_batched(
        j["eta"], j["beta_doc"], j["counts"], j["mu"], j["siginv"], Nd, bf16=False)
    got = stages.cg(torch.tensor(np.asarray(H)), torch.tensor(np.asarray(g)), 6,
                    bf16=bf16).numpy()
    # CG tolerance of tests/test_pallas_stages.py: reduction-order noise
    # amplified over the 6 steps
    want = pallas_cg_impl(H, g, iters=6, bf16=bf16, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=1e-5)
    if not bf16:
        # the XLA twin also rounds the search vector p in bf16, so it is
        # the reference only with bf16 off
        want = jax_estep._cg_batched(H, g, 6, bf16=False)
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=1e-5)


def test_linesearch_matches_jax():
    x = _chunk(seed=2)
    j, t = _jax(x), _torch(x)
    Nd = jnp.sum(j["counts"], axis=1)
    _f, g, _H, _, _ = jax_estep._f_g_H_batched(
        j["eta"], j["beta_doc"], j["counts"], j["mu"], j["siginv"], Nd, bf16=False)
    p = -g
    ts = jnp.exp2(-jnp.arange(12, dtype=jnp.float32))
    fs = stages.linesearch(t["eta"], torch.tensor(np.asarray(p)),
                           torch.tensor(np.asarray(ts)), t["beta_doc"], t["counts"],
                           t["mu"], t["siginv"]).numpy()
    xla = jax_estep._f_multi(j["eta"], p, ts, j["beta_doc"], j["counts"], j["mu"],
                             j["siginv"], Nd)
    pallas = pallas_linesearch_impl(j["eta"], p, ts, j["beta_doc"], j["counts"],
                                    j["mu"], j["siginv"], interpret=True)
    # the sweep tolerance of tests/test_pallas_stages.py
    for want in (xla, pallas):
        np.testing.assert_allclose(fs, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_cpu_wrappers_run_plain_and_count_no_launch():
    x = _torch(_chunk(seed=3, B=4, K=5, L=16))
    before = dict(stages.LAUNCHES)
    f, g, H = stages.fgh(x["eta"], x["beta_doc"], x["counts"], x["mu"], x["siginv"])
    ref = stages.fgh_plain(x["eta"], x["beta_doc"], x["counts"], x["mu"], x["siginv"],
                           bf16=True)
    for a, b in zip((f, g, H), ref):
        assert torch.equal(a, b)
    stages.cg(H, g, 4)
    ts = torch.exp2(-torch.arange(12, dtype=torch.float32))
    stages.linesearch(x["eta"], -g, ts, x["beta_doc"], x["counts"], x["mu"], x["siginv"])
    assert stages.LAUNCHES == before


def test_cpu_wrappers_take_a_bf16_beta_doc_and_count_no_launch():
    """A bf16 beta_doc on the CPU runs the plain versions on its (exact)
    float32 values and launches nothing; the whole loop refuses it, on
    any device, since no path sends it one."""
    x = _torch(_chunk(seed=6, B=4, K=5, L=16))
    bd = x["beta_doc"].to(torch.bfloat16)
    args = (x["eta"], bd, x["counts"], x["mu"], x["siginv"])
    rounded = (x["eta"], bd.float(), x["counts"], x["mu"], x["siginv"])
    ts = torch.exp2(-torch.arange(12, dtype=torch.float32))
    done = torch.zeros(4, dtype=torch.bool)
    before = dict(stages.LAUNCHES)
    for bf16 in (False, True):
        for a, b in zip(stages.fgh(*args, bf16=bf16), stages.fgh_plain(*rounded, bf16=bf16)):
            assert torch.equal(a, b)
        for a, b in zip(stages.newton_iter(*args, ts, done, 1e-5, 4, bf16),
                        stages.newton_iter_plain(*rounded, ts, done, 1e-5, 4, bf16)):
            assert torch.equal(a, b)
    p = -stages.fgh_plain(*rounded, bf16=False)[1]
    assert torch.equal(stages.linesearch(x["eta"], p, ts, *args[1:]),
                       stages.linesearch_plain(x["eta"], p, ts, *rounded[1:]))
    assert stages.LAUNCHES == before
    with pytest.raises(ValueError, match="float32"):
        stages.newton_loop(bd, x["counts"], x["mu"], x["mu"], x["siginv"], ts, 4, 1e-5, 4)


def _wrapper_case(name):
    """(wrapper, plain twin, a function making fresh inputs) of one kernel
    wrapper, on a small CPU chunk; fresh, since accept's n_iters and the
    scatter's beta_ss are updated in place."""
    x = _torch(_chunk(seed=7, B=8, K=6, L=16))
    eta, bd, c, mu, siginv = x["eta"], x["beta_doc"], x["counts"], x["mu"], x["siginv"]
    ts = torch.exp2(-torch.arange(12, dtype=torch.float32))
    done = torch.arange(8) % 3 == 0
    f, g, H = stages.fgh_plain(eta, bd, c, mu, siginv, bf16=True)
    x_cg = stages.cg_plain(H, g, 4, bf16=True)
    p, gTp, conv = stages.newton_direction_plain(g, x_cg, 1e-5)
    fs = stages.linesearch_plain(eta, p, ts, bd, c, mu, siginv)
    gen = torch.Generator().manual_seed(7)
    words = torch.randint(0, 20, (8, 16), generator=gen, dtype=torch.int32)
    beta_T, phi = torch.rand(20, 6, generator=gen), torch.rand(8 * 16, 6, generator=gen)
    plan = stages.scatter_plan(words, c > 0, 20)
    return {
        "fgh": (stages.fgh, stages.fgh_plain, lambda: (eta, bd, c, mu, siginv, True)),
        "cg": (stages.cg, stages.cg_plain, lambda: (H, g, 4, True)),
        "linesearch": (stages.linesearch, stages.linesearch_plain,
                       lambda: (eta, p, ts, bd, c, mu, siginv)),
        "newton_direction": (stages.newton_direction, stages.newton_direction_plain,
                             lambda: (g, x_cg, 1e-5)),
        "newton_accept": (stages.newton_accept, stages.newton_accept_plain,
                          lambda: (eta, p, fs, f, gTp, ts, done, conv,
                                   torch.arange(8, dtype=torch.int32))),
        "newton_iter": (stages.newton_iter, stages.newton_iter_plain,
                        lambda: (eta, bd, c, mu, siginv, ts, done, 1e-5, 4, True)),
        "newton_loop": (stages.newton_loop, stages.newton_loop_plain,
                        lambda: (bd, c, mu, eta, siginv, ts, 5, 1e-5, 4, True)),
        "gather_rows": (stages.gather_rows, stages.gather_rows_plain,
                        lambda: (beta_T, words)),
        "scatter_phi": (stages.scatter_phi, stages.scatter_phi_plain,
                        lambda: (torch.ones(6, 20), phi, plan, 20)),
        "chol_pd_inverse": (stages.chol_pd_inverse, stages.chol_pd_inverse_plain,
                            lambda: (H, True)),
    }[name]


WRAPPERS = ("fgh", "cg", "linesearch", "newton_direction", "newton_accept", "newton_iter",
            "newton_loop", "gather_rows", "scatter_phi", "chol_pd_inverse")


@pytest.mark.parametrize("name", WRAPPERS)
def test_cpu_wrapper_is_its_plain_twin_bit_for_bit(name):
    """Every kernel wrapper given CPU tensors returns its plain version's
    outputs bit for bit, in-place updates included, and launches nothing."""
    wrapper, plain, inputs = _wrapper_case(name)
    before = dict(stages.LAUNCHES)
    got_in, want_in = inputs(), inputs()
    got, want = wrapper(*got_in), plain(*want_in)
    assert stages.LAUNCHES == before
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for u, v in zip(got + got_in, want + want_in):
        if isinstance(u, torch.Tensor):
            assert cs.same_bits(torch, u, v), name
        else:
            assert u == v, name


@pytest.mark.parametrize("current", [True, False])
def test_launch_passes_pointers_and_the_stream_then_checks_and_counts(monkeypatch, current):
    """The launch protocol on a stand-in library: a tensor goes as its data
    pointer, None as 0, a number as it is, and the device's current stream
    comes last; the device guard is entered only where the device is not
    current; a launch counts once, and a non-zero return raises and counts
    nothing."""
    calls, guards, rc = [], [], [0]

    class Lib:
        def stm_cg(self, *argv):
            calls.append(argv)
            return rc[0]

        def stm_error_string(self, code):
            return b"planted"

    @contextlib.contextmanager
    def guard(index):
        guards.append(index)
        yield

    monkeypatch.setattr(build, "load", Lib)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0 if current else 1)
    monkeypatch.setattr(torch.cuda, "device", guard)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 1000 + index,
                        raising=False)
    monkeypatch.setitem(stages.LAUNCHES, "cg", 0)
    H = torch.zeros(2, 3, 3)
    stages._launch("cg", "cg", torch.device("cuda", 0), H, None, 5, 1.5)
    assert calls == [(H.data_ptr(), 0, 5, 1.5, 1000)]
    assert guards == ([] if current else [0]) and stages.LAUNCHES["cg"] == 1
    rc[0] = 7
    with pytest.raises(RuntimeError, match=r"stm_cg: CUDA error 7 \(planted\)"):
        stages._launch("cg", "cg", torch.device("cuda", 0), H, None, 5, 1.5)
    assert len(calls) == 2 and stages.LAUNCHES["cg"] == 1


def test_wrappers_reject_devices_without_a_kernel():
    x = {k: v.to("meta") for k, v in _torch(_chunk(seed=4, B=2, K=4, L=8)).items()}
    with pytest.raises(ValueError, match="no kernel"):
        stages.fgh(x["eta"], x["beta_doc"], x["counts"], x["mu"], x["siginv"])
    with pytest.raises(ValueError, match="several devices"):
        stages.cg(torch.zeros(2, 3, 3), torch.zeros(2, 3, device="meta"), 2)


def test_ctypes_signatures_match_the_cuda_source():
    """Each C entry point's parameters against the argtypes the loader
    declares: a miscount would pass garbage to the kernel, and only the
    card could show it."""
    import re

    src = "\n".join(p.read_text() for p in build.SOURCES)
    kind = {build.ctypes.c_void_p: "p", build.ctypes.c_int: "i", build.ctypes.c_float: "f"}
    found = {}
    for name, params in re.findall(r"^int (stm_\w+)\(([^)]*)\)", src, flags=re.M):
        kinds = [p.strip().rsplit(" ", 1)[0] for p in params.split(",")]
        found[name] = ["p" if k.endswith("*") else "f" if k == "float" else "i"
                       for k in kinds]
    declared = {name: [kind[t] for t in types] for name, types in build._SIGNATURES.items()}
    assert found == declared


def test_build_without_nvcc_fails_loudly(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build.shutil, "which", lambda _name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda _path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
    assert not (tmp_path / "kernels").exists()


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_cuda_kernels_match_plain(bf16):
    """The CUDA kernels against their plain versions on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py runs this check on the card)")
    t = {k: v.cuda() for k, v in _torch(_chunk(seed=5, B=32, K=13, L=256)).items()}
    args = (t["eta"], t["beta_doc"], t["counts"], t["mu"], t["siginv"])
    n0 = dict(stages.LAUNCHES)
    got = stages.fgh(*args, bf16=bf16)
    want = stages.fgh_plain(*args, bf16=bf16)
    for a, b, tol in zip(got, want, (1e-5, 1e-4, 2e-2 if bf16 else 1e-4)):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=tol, atol=tol)
    _f, g, H = want
    np.testing.assert_allclose(stages.cg(H, g, 6, bf16=bf16).cpu().numpy(),
                               stages.cg_plain(H, g, 6, bf16=bf16).cpu().numpy(),
                               rtol=1e-3, atol=1e-4)
    ts = torch.exp2(-torch.arange(12, dtype=torch.float32, device="cuda"))
    np.testing.assert_allclose(
        stages.linesearch(t["eta"], -g, ts, *args[1:]).cpu().numpy(),
        stages.linesearch_plain(t["eta"], -g, ts, *args[1:]).cpu().numpy(),
        rtol=1e-5, atol=1e-4)
    assert {k: stages.LAUNCHES[k] - n0[k] for k in n0} == {"fgh": 1, "cg": 1, "ls": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
def test_cuda_bf16_beta_doc_modes_match_plain(bf16):
    """B1, B3 and B4 given a bf16 beta_doc on the card against their plain
    versions on the same beta_doc, each counted under its own mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py phase 12 runs this check on the card)")
    t = {k: v.cuda() for k, v in _torch(_chunk(seed=7, B=32, K=13, L=256)).items()}
    bd = t["beta_doc"].to(torch.bfloat16)
    args = (t["eta"], bd, t["counts"], t["mu"], t["siginv"])
    n0 = dict(stages.LAUNCHES)
    got, want = stages.fgh(*args, bf16=bf16), stages.fgh_plain(*args, bf16=bf16)
    for a, b, tol in zip(got, want, (1e-5, 1e-4, 2e-2 if bf16 else 1e-4)):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=tol, atol=tol)
    ts = torch.exp2(-torch.arange(12, dtype=torch.float32, device="cuda"))
    g = want[1]
    np.testing.assert_allclose(
        stages.linesearch(t["eta"], -g, ts, *args[1:]).cpu().numpy(),
        stages.linesearch_plain(t["eta"], -g, ts, *args[1:]).cpu().numpy(),
        rtol=1e-5, atol=1e-4)
    done = torch.zeros(32, dtype=torch.bool, device="cuda")
    eta, _done, _adv = stages.newton_iter(*args, ts, done, 1e-5, 6, bf16)
    assert torch.isfinite(eta).all()
    assert {k: stages.LAUNCHES[k] - n0[k] for k in n0 if stages.LAUNCHES[k] != n0[k]} == {
        "fgh_bf16_beta": 1, "ls_bf16_beta": 1, "iter_bf16_beta": 1}
