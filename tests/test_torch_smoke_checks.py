"""The checks that chip_smoke.py holds each CUDA kernel to, run on the
CPU: an independent implementation of the same functions (the JAX Pallas
kernels in interpret mode) passes them, and kernels that are wrong in
small ways fail them.  Each wrong kernel is simulated by the plain
versions with the fault put in."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import chip_smoke as cs
from strutopy_tpu.ops import estep as jax_estep
from strutopy_tpu.ops.pallas_estep import pallas_newton
from strutopy_tpu.ops.pallas_stages import (
    pallas_cg_impl,
    pallas_fgh_impl,
    pallas_gather_beta,
    pallas_iter_impl,
    pallas_linesearch_impl,
)
from strutopy_tpu_torch.ops import stages
from torch_world import one_thread


@pytest.fixture(autouse=True, scope="module")
def _torch_on_one_thread():
    """torch's CPU ops on one thread for every test of this file and its
    fixtures (tests/torch_world.py::one_thread): under parallel test
    workers a toy fit on torch's default pool waits on busy cores."""
    with one_thread():
        yield


def _chunk(bf16, K=13, B=16, L=128, seed=5):
    """A chunk as chip_smoke.py builds it (bench-sized vocabulary), its
    plain outputs and the kernels' inputs."""
    rng = np.random.default_rng(seed)
    words = np.stack([rng.choice(cs.V_BENCH, L, replace=False) for _ in range(B)])
    counts = np.zeros((B, L), np.float32)
    counts[:, :100] = rng.integers(1, 5, (B, 100))
    inputs = cs.stage_inputs(torch, words.astype(np.int32), counts, K, seed, device="cpu")
    want, aux = cs.plain_outputs(torch, stages, inputs, bf16)
    return inputs, want, aux


def _worst(inputs, got, want, aux, bf16):
    verdict = cs.judge(torch, stages, inputs, got, want, aux, bf16)
    assert all(finite for _abs, _worst, finite in verdict.values())
    return {name: worst for name, (_abs, worst, _fin) in verdict.items()}


@pytest.mark.parametrize("bf16", [False, True])
def test_pallas_kernels_pass_the_smoke_checks(bf16):
    inputs, want, aux = _chunk(bf16)
    eta, bd, c, mu, siginv = (jnp.asarray(t.numpy()) for t in inputs)
    j = {k: jnp.asarray(aux[k].numpy()) for k in ("H", "g", "p", "ts")}
    f, g, H = pallas_fgh_impl(eta, bd, c, mu, siginv, bf16=bf16, interpret=True)
    x = pallas_cg_impl(j["H"], j["g"], iters=aux["iters"], bf16=bf16, interpret=True)
    fs = pallas_linesearch_impl(eta, j["p"], j["ts"], bd, c, mu, siginv, interpret=True)
    got = {k: torch.tensor(np.asarray(v)) for k, v in
           {"fgh.f": f, "fgh.g": g, "fgh.H": H, "cg": x, "ls": fs}.items()}
    worst = _worst(inputs, got, want, aux, bf16)
    assert max(worst.values()) <= 1.0, worst


def _sweep_reads_8_step_sizes(inputs, want, aux, bf16):
    # t >= 2^-8 evaluated at eta instead of eta + t p
    eta, bd, c, mu, siginv = inputs
    ts = aux["ts"].clone()
    ts[8:] = 0.0
    return {"ls": stages.linesearch_plain(eta, aux["p"], ts, bd, c, mu, siginv)}


def _fgh_drops_a_word(inputs, want, aux, bf16):
    eta, bd, c, mu, siginv = inputs
    c = c.clone()
    c[0, int(torch.argmax(c[0]))] = 0.0
    return dict(zip(("fgh.f", "fgh.g", "fgh.H"),
                    stages.fgh_plain(eta, bd, c, mu, siginv, bf16=bf16)))


def _hessian_in_the_other_rounding(inputs, want, aux, bf16):
    return {"fgh.H": aux["other"]["fgh.H"]}


def _cg_one_step_short(inputs, want, aux, bf16):
    return {"cg": stages.cg_plain(aux["H"], aux["g"], aux["iters"] - 1, bf16=bf16)}


def _cg_rounds_p_too(inputs, want, aux, bf16):
    # the XLA twin's rounding (ROADMAP Queue C), not the kernel's
    x = jax_estep._cg_batched(jnp.asarray(aux["H"].numpy()), jnp.asarray(aux["g"].numpy()),
                              aux["iters"], bf16=True)
    return {"cg": torch.tensor(np.asarray(x))}


def _cg(H, g, iters, bf16, dinv_from_bf16=False, dropped_warp=None, round_p=False):
    """cg_plain with one of the CUDA CG's hazards put in: the
    preconditioner from the bf16-rounded diagonal, one warp's partial Ap
    rows left out (warp w holds rows w·R .. w·R + R - 1, R = ceil((K-1)/8)),
    or p rounded to bf16 in the matvec."""
    Hm = stages._bf16_round(H) if bf16 else H
    dinv = 1.0 / torch.clamp_min(torch.abs(torch.diagonal(Hm if dinv_from_bf16 else H,
                                                          dim1=1, dim2=2)), 1e-20)
    if dropped_warp is not None:
        rows = -(-H.shape[1] // 8)
        Hm = Hm.clone()
        Hm[:, dropped_warp * rows:(dropped_warp + 1) * rows] = 0.0
    r = -g
    z = dinv * r
    p = z
    rz = torch.sum(r * z, dim=1)
    x = torch.zeros_like(g)
    active = torch.ones(g.shape[0], dtype=torch.bool)
    for _ in range(iters):
        pm = stages._bf16_round(p) if round_p else p
        Ap = torch.bmm(pm[:, None, :], Hm)[:, 0]
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


def test_the_cg_fault_model_without_a_fault_is_cg_plain():
    _inputs, want, aux = _chunk(True)
    assert torch.equal(_cg(aux["H"], aux["g"], aux["iters"], True), want["cg"])


def _cg_dinv_from_the_rounded_diagonal(inputs, want, aux, bf16):
    return {"cg": _cg(aux["H"], aux["g"], aux["iters"], bf16, dinv_from_bf16=True)}


def _cg_drops_one_warps_partial_rows(inputs, want, aux, bf16):
    return {"cg": _cg(aux["H"], aux["g"], aux["iters"], bf16, dropped_warp=3)}


def _cg_rounds_p_in_the_matvec(inputs, want, aux, bf16):
    return {"cg": _cg(aux["H"], aux["g"], aux["iters"], bf16, round_p=True)}


@pytest.mark.parametrize("mutant, bf16", [
    (_sweep_reads_8_step_sizes, False),
    (_fgh_drops_a_word, False),
    (_fgh_drops_a_word, True),
    (_hessian_in_the_other_rounding, False),
    (_hessian_in_the_other_rounding, True),
    (_cg_one_step_short, True),
    (_cg_rounds_p_too, True),
    (_cg_dinv_from_the_rounded_diagonal, True),
    (_cg_drops_one_warps_partial_rows, False),
    (_cg_drops_one_warps_partial_rows, True),
    (_cg_rounds_p_in_the_matvec, True),
], ids=lambda v: v.__name__.strip("_") if callable(v) else f"bf16={v}")
def test_smoke_checks_fail_a_wrong_kernel(mutant, bf16):
    inputs, want, aux = _chunk(bf16)
    wrong = mutant(inputs, want, aux, bf16)
    worst = _worst(inputs, {**want, **wrong}, want, aux, bf16)
    assert all(worst[name] > 1.0 for name in wrong), worst
    assert all(worst[name] == 0.0 for name in worst if name not in wrong), worst


# Faults the slab-streaming kernels could make.  The chunk has K=20 (the
# 19 free rows pad to 32 for the tensor cores) and L=120, which ends in a
# partial slab of the 64 word slots fgh and ls take at this K; its live
# slots are 0..99.


def _operand(inputs, bf16):
    """fgh's B·Bᵀ operand phi·sqrt(c) of every topic (B, K, L), rounded
    as the kernel rounds it."""
    eta, bd, c, mu, siginv = inputs
    *_, phi = stages.f_g_H_batched(eta, bd, c, mu, siginv, torch.sum(c, dim=1), False)
    Bm = phi * torch.sqrt(c)[:, None, :]
    return stages._bf16_round(Bm) if bf16 else Bm


def _gram(Bm):
    return torch.bmm(Bm, Bm.transpose(1, 2))


def _fgh_misses_the_partial_slab(inputs, want, aux, bf16):
    Km1 = inputs[0].shape[1]
    last = _operand(inputs, bf16)[:, :Km1, 64:]
    return {"fgh.H": want["fgh.H"] - _gram(last)}


def _fgh_padded_row_leaks_into_row_k_minus_2(inputs, want, aux, bf16):
    # the pinned topic's operand row added to the last free row
    Km1 = inputs[0].shape[1]
    Bm = _operand(inputs, bf16)
    leaky = Bm[:, :Km1].clone()
    leaky[:, -1] += Bm[:, Km1]
    return {"fgh.H": want["fgh.H"] - _gram(Bm[:, :Km1]) + _gram(leaky)}


def _fgh_mirrors_a_tile_untransposed(inputs, want, aux, bf16):
    H = want["fgh.H"].clone()
    H[:, 8:16, 0:8] = H[:, 0:8, 8:16]
    return {"fgh.H": H}


def _sweep_drops_a_slab(inputs, want, aux, bf16):
    # the log-likelihood terms of word slots 64..127 left out of every f_t
    eta, bd, c, mu, siginv = inputs
    cand = eta[:, None, :] + aux["ts"][None, :, None] * aux["p"][:, None, :]
    full = torch.cat([cand, cand.new_zeros(*cand.shape[:2], 1)], dim=2)
    m = torch.amax(full, dim=2, keepdim=True)
    s = torch.clamp_min(torch.bmm(torch.exp(full - m), bd), 1e-35)
    terms = torch.where(c[:, None, :] > 0, c[:, None, :] * (torch.log(s) + m), 0.0)
    return {"ls": want["ls"] + torch.sum(terms[:, :, 64:128], dim=2)}


@pytest.mark.parametrize("mutant, bf16", [
    (_fgh_misses_the_partial_slab, False),
    (_fgh_misses_the_partial_slab, True),
    (_fgh_padded_row_leaks_into_row_k_minus_2, False),
    (_fgh_padded_row_leaks_into_row_k_minus_2, True),
    (_fgh_mirrors_a_tile_untransposed, False),
    (_fgh_mirrors_a_tile_untransposed, True),
    (_sweep_drops_a_slab, False),
], ids=lambda v: v.__name__.strip("_") if callable(v) else f"bf16={v}")
def test_smoke_checks_fail_a_wrong_slab_kernel(mutant, bf16):
    inputs, want, aux = _chunk(bf16, K=20, L=120)
    wrong = mutant(inputs, want, aux, bf16)
    worst = _worst(inputs, {**want, **wrong}, want, aux, bf16)
    assert all(worst[name] > 1.0 for name in wrong), worst
    assert all(worst[name] == 0.0 for name in worst if name not in wrong), worst


# ---------------------------------------------------------------------------
# B4 (fused iteration), B5 (whole loop), B6 (row gather)
# ---------------------------------------------------------------------------


def _fused(bf16, K=9, B=32, seed=3):
    """A chunk of the bench recipe's documents with its true beta, as
    chip_smoke.py checks the fused kernels, and the plain step's parts
    from a point part-way along the trajectory."""
    inputs_loop = cs.dgp_chunk(torch, K, B, seed, device="cpu")
    eta, done = cs.midway(torch, stages, inputs_loop, bf16)
    bd, c, mu, siginv = inputs_loop
    inputs = (eta, bd, c, mu, siginv)
    return inputs_loop, inputs, cs.iter_plain_parts(torch, stages, inputs, done, bf16)


def _jnp(*ts):
    return [jnp.asarray(t.numpy()) for t in ts]


def _iter_verdict(inputs, parts, got, lean_other=False):
    worst, n_margin, flags_ok, kept, finite = cs.judge_iter(torch, stages, inputs, parts, got,
                                                            lean_other)
    assert finite and n_margin < len(parts["t"]) // 4
    return worst, flags_ok, kept


@pytest.mark.parametrize("bf16", [False, True])
def test_pallas_iter_kernel_passes_the_iter_check(bf16):
    _loop, inputs, parts = _fused(bf16)
    eta, bd, c, mu, siginv = _jnp(*inputs)
    e, d, a = pallas_iter_impl(eta, bd, c, mu, siginv, jnp.asarray(parts["ts"].numpy()),
                               jnp.asarray(parts["done"].numpy()), grad_tol=cs.GRAD_TOL,
                               cg_iters=parts["cg_iters"], bf16=bf16, interpret=True)
    got = tuple(torch.tensor(np.asarray(v)) for v in (e, d, a))
    worst, flags_ok, kept = _iter_verdict(inputs, parts, got)
    assert flags_ok and kept and worst <= 1.0, worst


def _pallas_newton(inputs_loop, bf16, max_iters=24):
    bd, c, mu, siginv = _jnp(*inputs_loop)
    eta, n = pallas_newton(bd, c, mu, mu, siginv, block_docs=16, interpret=True,
                           cfg=jax_estep.NewtonConfig(bf16_hessian=bf16, max_iters=max_iters))
    return torch.tensor(np.asarray(eta)), torch.tensor(np.asarray(n))


@pytest.mark.parametrize("bf16", [False, True])
def test_pallas_newton_kernel_passes_the_loop_checks(bf16):
    inputs_loop, _inputs, _parts = _fused(bf16)
    bd, c, mu, siginv = inputs_loop
    B = mu.shape[0]
    # one step, held to the iteration check from eta = mu
    parts1 = cs.iter_plain_parts(torch, stages, (mu, bd, c, mu, siginv),
                                 torch.zeros(B, dtype=torch.bool), bf16)
    e1, n1 = _pallas_newton(inputs_loop, bf16, max_iters=1)
    worst, flags_ok, _kept = _iter_verdict((mu, bd, c, mu, siginv), parts1, (e1, None, n1 > 0))
    assert flags_ok and worst <= 1.0, worst
    # the whole loop
    ts = cs.step_sizes(torch, "cpu")
    want = stages.newton_loop_plain(bd, c, mu, mu, siginv, ts, 24, cs.GRAD_TOL, 6, bf16)
    verdict = cs.judge_loop(torch, stages, inputs_loop, _pallas_newton(inputs_loop, bf16), want)
    assert cs.loop_ok(verdict, B), verdict


def test_pallas_gather_kernel_passes_the_gather_check():
    rng = np.random.default_rng(7)
    beta_T = rng.random((500, 12)).astype(np.float32)
    words = rng.integers(0, 500, (16, 40)).astype(np.int32)
    got = pallas_gather_beta(jnp.asarray(beta_T), jnp.asarray(words), rows_per_program=64,
                             interpret=True)
    want = stages.gather_rows_plain(torch.tensor(beta_T), torch.tensor(words))
    assert torch.equal(torch.tensor(np.asarray(got)), want)


def _iter_advances_done_documents(inputs, parts, bf16):
    eta, bd, c, mu, siginv = inputs
    done = parts["done"]
    free = stages.newton_iter_plain(eta, bd, c, mu, siginv, parts["ts"], torch.zeros_like(done),
                                    cs.GRAD_TOL, parts["cg_iters"], bf16)
    return tuple(torch.where(done[:, None] if w.dim() == 2 else done, f, w)
                 for f, w in zip(free, parts["want"]))


def _iter_takes_the_smallest_acceptable_step(inputs, parts, bf16):
    eta = inputs[0]
    ok = parts["fs"] <= parts["rhs"]
    t_min = torch.amin(torch.where(ok, parts["ts"][None, :], 2.0), dim=1)
    _e, done, adv = parts["want"]
    step = adv & ok.any(1)
    return torch.where(step[:, None], eta + t_min[:, None] * parts["p"], eta), done, adv


def _iter_rounds_p_in_cg(inputs, parts, bf16):
    # the XLA twin's CG (ROADMAP Queue C), not the kernel's
    def cg_xla(H, g, iters, bf16):
        x = jax_estep._cg_batched(jnp.asarray(H.numpy()), jnp.asarray(g.numpy()), iters,
                                  bf16=bf16)
        return torch.tensor(np.asarray(x))

    eta, bd, c, mu, siginv = inputs
    return stages._step(stages.fgh_plain, cg_xla, stages.linesearch_plain,
                        stages.newton_direction_plain, stages.newton_accept_plain, eta, bd, c,
                        mu, siginv, parts["ts"], parts["done"], None, cs.GRAD_TOL,
                        parts["cg_iters"], bf16)[:3]


@pytest.mark.parametrize("mutant, bf16", [
    (_iter_advances_done_documents, False),
    (_iter_takes_the_smallest_acceptable_step, False),
    (_iter_takes_the_smallest_acceptable_step, True),
    (_iter_rounds_p_in_cg, True),
], ids=lambda v: v.__name__.strip("_") if callable(v) else f"bf16={v}")
def test_iter_check_fails_a_wrong_kernel(mutant, bf16):
    _loop, inputs, parts = _fused(bf16)
    worst, flags_ok, kept = _iter_verdict(inputs, parts, mutant(inputs, parts, bf16))
    assert worst > 1.0 or not flags_ok or not kept, worst


def test_loop_check_fails_a_loop_that_stops_one_step_early():
    """Each document's eta before its last advancing step, one count less."""
    inputs_loop, _inputs, _parts = _fused(True)
    bd, c, mu, siginv = inputs_loop
    ts = cs.step_sizes(torch, "cpu")
    eta, prev = mu.clone(), mu.clone()
    done = torch.zeros(mu.shape[0], dtype=torch.bool)
    n = torch.zeros(mu.shape[0], dtype=torch.int32)
    for _ in range(24):
        new, done, adv = stages.newton_iter_plain(eta, bd, c, mu, siginv, ts, done,
                                                  cs.GRAD_TOL, 6, True)
        prev = torch.where(adv[:, None], eta, prev)
        eta, n = new, n + adv.to(torch.int32)
    verdict = cs.judge_loop(torch, stages, inputs_loop, (prev, n - 1), (eta, n))
    assert not cs.loop_ok(verdict, mu.shape[0]), verdict


def _loop_stops_one_step_early_on_every_fourth_document(inputs_loop, bf16):
    """Every fourth document's eta before its last advancing step, one
    count less; the others' as plain leaves them."""
    bd, c, mu, siginv = inputs_loop
    ts = cs.step_sizes(torch, "cpu")
    eta, prev = mu.clone(), mu.clone()
    done = torch.zeros(mu.shape[0], dtype=torch.bool)
    n = torch.zeros(mu.shape[0], dtype=torch.int32)
    for _ in range(cs.LOOP_ITERS):
        new, done, adv = stages.newton_iter_plain(eta, bd, c, mu, siginv, ts, done,
                                                  cs.GRAD_TOL, 6, bf16)
        prev = torch.where(adv[:, None], eta, prev)
        eta, n = new, n + adv.to(torch.int32)
    some = torch.zeros(mu.shape[0], dtype=torch.bool)
    some[::4] = True
    return torch.where(some[:, None], prev, eta), torch.where(some, n - 1, n)


def _loop_keeps_stepping_done_documents(inputs_loop, bf16):
    """A converged document is not left: it takes Newton steps until no
    Armijo step passes or the budget is spent."""
    bd, c, mu, siginv = inputs_loop
    ts = cs.step_sizes(torch, "cpu")
    return stages.newton_loop_plain(bd, c, mu, mu, siginv, ts, cs.LOOP_ITERS, -1.0, 6, bf16)


@pytest.mark.parametrize("mutant, bf16", [
    (_loop_stops_one_step_early_on_every_fourth_document, True),
    (_loop_keeps_stepping_done_documents, False),
    (_loop_keeps_stepping_done_documents, True),
], ids=lambda v: v.__name__.strip("_") if callable(v) else f"bf16={v}")
def test_loop_check_fails_a_wrong_whole_loop(mutant, bf16):
    inputs_loop, _inputs, _parts = _fused(bf16)
    bd, c, mu, siginv = inputs_loop
    ts = cs.step_sizes(torch, "cpu")
    want = stages.newton_loop_plain(bd, c, mu, mu, siginv, ts, cs.LOOP_ITERS, cs.GRAD_TOL, 6,
                                    bf16)
    verdict = cs.judge_loop(torch, stages, inputs_loop, mutant(inputs_loop, bf16), want)
    assert not cs.loop_ok(verdict, mu.shape[0]), verdict


def test_gather_check_fails_a_gather_that_drops_the_last_row():
    rng = np.random.default_rng(8)
    beta_T = torch.tensor(rng.random((300, 8)).astype(np.float32))
    words = torch.tensor(rng.integers(0, 300, (4, 16)).astype(np.int32))
    want = stages.gather_rows_plain(beta_T, words)
    wrong = want.clone()
    wrong[-1, -1] = 0.0
    assert not torch.equal(wrong, want)


# ---------------------------------------------------------------------------
# phase 12: B1, B3, B4 given a bf16 beta_doc
# ---------------------------------------------------------------------------


def _beta_chunk(bf16, K=13, B=16, L=121, seed=5):
    """A chunk of an odd width L whose every slot is live (the ragged copy
    path of a bf16 beta_doc: 121 is no multiple of 8): its float32 inputs,
    and the bf16 inputs and plain outputs phase 12 forms from them."""
    rng = np.random.default_rng(seed)
    words = np.stack([rng.choice(cs.V_BENCH, L, replace=False) for _ in range(B)])
    counts = rng.integers(1, 5, (B, L)).astype(np.float32)
    inputs = cs.stage_inputs(torch, words.astype(np.int32), counts, K, seed, device="cpu")
    return (inputs, *cs.beta_plain(torch, stages, inputs, bf16))


@pytest.mark.parametrize("bf16", [False, True])
def test_pallas_kernels_on_a_bf16_beta_doc_pass_the_phase_12_checks(bf16):
    _inputs, _inputs_b, inputs_r, want, aux = _beta_chunk(bf16)
    eta, _bd, c, mu, siginv = (jnp.asarray(t.numpy()) for t in inputs_r)
    bd = jnp.asarray(inputs_r[1].numpy()).astype(jnp.bfloat16)
    f, g, H = pallas_fgh_impl(eta, bd, c, mu, siginv, bf16=bf16, interpret=True)
    fs = pallas_linesearch_impl(eta, jnp.asarray(aux["p"].numpy()), jnp.asarray(aux["ts"].numpy()),
                                bd, c, mu, siginv, interpret=True)
    got = {k: torch.tensor(np.asarray(v)) for k, v in
           {"fgh.f": f, "fgh.g": g, "fgh.H": H, "ls": fs}.items()}
    worst = _worst(inputs_r, got, want, aux, bf16)
    assert set(worst) == set(got) and max(worst.values()) <= 1.0, worst


def _reads_the_float32_beta_doc(inputs, inputs_b, aux, bf16):
    return dict(aux["other_beta"])


def _outputs(inputs_b, aux, bf16, bd=None, c=None):
    eta, bd_b, c_b, mu, siginv = inputs_b
    bd, c = (bd_b if bd is None else bd), (c_b if c is None else c)
    f, g, H = stages.fgh_plain(eta, bd, c, mu, siginv, bf16=bf16)
    return {"fgh.f": f, "fgh.g": g, "fgh.H": H,
            "ls": stages.linesearch_plain(eta, aux["p"], aux["ts"], bd, c, mu, siginv)}


def _drops_the_ragged_tail(inputs, inputs_b, aux, bf16):
    # the slots past the last whole 16-byte chunk (L - L % 8) left out
    c = inputs_b[2].clone()
    c[:, c.shape[1] - c.shape[1] % 8:] = 0.0
    return _outputs(inputs_b, aux, bf16, c=c)


def _truncates_beta_to_bf16(inputs, inputs_b, aux, bf16):
    # the float32 beta_doc cut to bf16 by truncation instead of rounding
    # to nearest (a kernel that converted float32 itself)
    cut = (inputs[1].view(torch.int32) & ~0xFFFF).view(torch.float32)
    return _outputs(inputs_b, aux, bf16, bd=cut)


@pytest.mark.parametrize("mutant, bf16", [
    (_reads_the_float32_beta_doc, False),
    (_reads_the_float32_beta_doc, True),
    (_drops_the_ragged_tail, False),
    (_drops_the_ragged_tail, True),
    (_truncates_beta_to_bf16, True),
], ids=lambda v: v.__name__.strip("_") if callable(v) else f"bf16={v}")
def test_phase_12_checks_fail_a_wrong_bf16_beta_doc_kernel(mutant, bf16):
    inputs, inputs_b, inputs_r, want, aux = _beta_chunk(bf16)
    wrong = mutant(inputs, inputs_b, aux, bf16)
    worst = _worst(inputs_r, wrong, want, aux, bf16)
    assert all(worst[name] > 1.0 for name in wrong), worst


# Faults of the bf16 slabs' designs: 128-slot slabs (B3's plan), siginv
# read before it has landed, and a document's word slots summed in two
# halves (slots from 128 on apart: a split over two blocks, or two
# half-sums added at the end) with one half's partial sum left out or
# added twice.  The chunk has K=13 and L=256, every slot live.


def _upper_half_partials(inputs_r, bf16, lo=128):
    """The share of a document's word slots lo ..: its log-likelihood
    terms (B,), q (B, K-1) and B·Bᵀ (B, K-1, K-1)."""
    eta, bd, c, mu, siginv = inputs_r
    K = bd.shape[1]
    *_, phi = stages.f_g_H_batched(eta, bd, c, mu, siginv, torch.sum(c, dim=1), False)
    ch = c.clone()
    ch[:, :lo] = 0.0
    full = torch.cat([eta, eta.new_zeros(eta.shape[0], 1)], dim=1)
    m = torch.amax(full, dim=1, keepdim=True)
    s = torch.clamp_min(torch.bmm(torch.exp(full - m)[:, None, :], bd)[:, 0], 1e-35)
    ll = torch.sum(torch.where(ch > 0, ch * (torch.log(s) + m), 0.0), dim=1)
    Bm = phi * torch.sqrt(ch)[:, None, :]
    Bm = stages._bf16_round(Bm) if bf16 else Bm
    return ll, torch.sum(phi * ch[:, None, :], dim=2)[:, :K - 1], _gram(Bm[:, :K - 1])


def _sweep_upper_half_terms(inputs_r, aux, lo=128):
    eta, bd, c, mu, siginv = inputs_r
    cand = eta[:, None, :] + aux["ts"][None, :, None] * aux["p"][:, None, :]
    full = torch.cat([cand, cand.new_zeros(*cand.shape[:2], 1)], dim=2)
    m = torch.amax(full, dim=2, keepdim=True)
    s = torch.clamp_min(torch.bmm(torch.exp(full - m), bd), 1e-35)
    terms = torch.where(c[:, None, :] > 0, c[:, None, :] * (torch.log(s) + m), 0.0)
    return torch.sum(terms[:, :, lo:], dim=2)


def _sweep_drops_slots_128_to_255(inputs_r, want, aux, bf16):
    # a 128-slot slab that the sweep never reads
    return {"ls": want["ls"] + _sweep_upper_half_terms(inputs_r, aux)}


def _prior_term_from_a_siginv_not_landed(inputs_r, want, aux, bf16):
    # the prior terms read zeros where siginv's region had not landed; H's
    # epilogue reads it later, landed
    eta, bd, c, mu, siginv = inputs_r
    zero = torch.zeros_like(siginv)
    f, g, _H = stages.fgh_plain(eta, bd, c, mu, zero, bf16=bf16)
    return {"fgh.f": f, "fgh.g": g,
            "ls": stages.linesearch_plain(eta, aux["p"], aux["ts"], bd, c, mu, zero)}


def _half_partial(what, times):
    """the upper half of the slots' partial of ``what`` added ``times``
    times (0: left out, 2: added twice) in place of once"""
    def mutant(inputs_r, want, aux, bf16):
        ll, q, G = _upper_half_partials(inputs_r, bf16)
        k = times - 1
        if what == "BBt":  # B·Bᵀ
            return {"fgh.H": want["fgh.H"] + k * G}
        if what == "q":
            return {"fgh.g": want["fgh.g"] - k * q,
                    "fgh.H": want["fgh.H"] - k * torch.diag_embed(q)}
        if what == "f":
            return {"fgh.f": want["fgh.f"] - k * ll}
        return {"ls": want["ls"] - k * _sweep_upper_half_terms(inputs_r, aux)}
    mutant.__name__ = f"half-slots {what} partial {('left out', '', 'added twice')[times]}"
    return mutant


@pytest.mark.parametrize("mutant, bf16", [
    (_sweep_drops_slots_128_to_255, True),
    (_sweep_drops_slots_128_to_255, False),
    (_prior_term_from_a_siginv_not_landed, True),
    *[(_half_partial(what, times), True) for what in ("BBt", "q", "f", "sweep")
      for times in (0, 2)],
    (_half_partial("BBt", 0), False),
], ids=lambda v: v.__name__.strip("_") if callable(v) else f"bf16={v}")
def test_phase_12_checks_fail_the_bf16_slab_designs_faults(mutant, bf16):
    _inputs, _inputs_b, inputs_r, want, aux = _beta_chunk(bf16, L=256)
    wrong = mutant(inputs_r, want, aux, bf16)
    worst = _worst(inputs_r, wrong, want, aux, bf16)
    assert all(worst[name] > 1.0 for name in wrong), worst


def _beta_iter(bf16):
    inputs_loop = cs.dgp_chunk(torch, 9, 32, 3, device="cpu")
    return cs.beta_iter_parts(torch, stages, inputs_loop, bf16)


@pytest.mark.parametrize("bf16", [False, True])
def test_pallas_iter_kernel_on_a_bf16_beta_doc_passes_the_iter_check(bf16):
    (eta, bd_b, c, mu, siginv), inputs_r, parts = _beta_iter(bf16)
    bd = jnp.asarray(bd_b.float().numpy()).astype(jnp.bfloat16)
    e, d, a = pallas_iter_impl(*_jnp(eta), bd, *_jnp(c, mu, siginv, parts["ts"]),
                               jnp.asarray(parts["done"].numpy()), grad_tol=cs.GRAD_TOL,
                               cg_iters=parts["cg_iters"], bf16=bf16, interpret=True)
    got = tuple(torch.tensor(np.asarray(v)) for v in (e, d, a))
    worst, flags_ok, kept = _iter_verdict(inputs_r, parts, got, lean_other=True)
    assert flags_ok and kept and worst <= 1.0, worst


@pytest.mark.parametrize("wrong", ["other_beta", "other"])
@pytest.mark.parametrize("bf16", [False, True])
def test_iter_check_fails_an_iteration_on_the_wrong_beta_doc_or_hessian(wrong, bf16):
    """Phase 12's B4 check fails the step on the float32 beta_doc, and the
    step in the other bf16 Hessian mode (LEAN_MAX in place of
    DISCRIMINATE)."""
    _inputs_b, inputs_r, parts = _beta_iter(bf16)
    worst, flags_ok, kept = _iter_verdict(inputs_r, parts, parts[wrong], lean_other=True)
    assert worst > 1.0 or not flags_ok or not kept, worst


def _anchor_verdict(Q_card, Q_cpu, a_card, a_cpu):
    from strutopy_tpu_torch.ops import spectral

    fails = cs.Failures()
    cs.check_anchors(torch, spectral, fails, Q_card, Q_cpu, np.asarray(a_card),
                     np.asarray(a_cpu))
    return not fails


def test_anchor_check_admits_a_tie_and_refuses_a_wrong_choice():
    """Phase 6's anchor check: equal chains pass; chains that part where
    the two candidates' scores tie pass; a chain that takes a row whose
    score is clearly lower fails, on whichever device it ran."""
    from strutopy_tpu_torch.ops import spectral

    rng = np.random.default_rng(3)
    Vp, K = 60, 6
    Q = torch.tensor(rng.dirichlet(np.ones(Vp), size=Vp), dtype=torch.float32)
    chain = spectral.fast_anchor(Q, K).numpy()
    assert _anchor_verdict(Q, Q, chain, chain)

    first = int(chain[0])
    twin = (first + 7) % Vp
    tied = Q.clone()
    tied[:, twin] = tied[:, first]  # two columns with the same score, exactly
    a = spectral.fast_anchor(tied, K).numpy()
    assert a[0] == min(first, twin)
    b = a.copy()
    b[0] = max(first, twin)
    assert _anchor_verdict(tied, tied, a, b)

    rss = spectral.anchor_rss(Q, torch.zeros(Vp))
    low = int(torch.argsort(rss)[Vp // 2])
    assert cs.anchor_gap(torch, spectral, Q, chain, 0, first, low) > Vp * 2.0 ** -24
    wrong = chain.copy()
    wrong[0] = low
    assert not _anchor_verdict(Q, Q, chain, wrong)
    assert not _anchor_verdict(Q, Q, wrong, chain)


# ---------------------------------------------------------------------------
# phase 11: raw text to theta, the pipeline and the CLI
# ---------------------------------------------------------------------------


def _verdict(check, *args):
    fails = cs.Failures()
    check(fails, *args)
    return not fails


def _text_corpus(V=300, N=40, seed=3):
    from strutopy_tpu_torch.corpus.preprocess import build_corpus

    docs, X = cs.make_corpus(5, V, N, 50, seed=seed)
    names = cs.token_names(V)
    texts = cs.render_texts(docs, names, seed=21)
    return docs, X, names, {u: build_corpus(texts, use_native=u) for u in (True, False)}


def _change_one_count(out):
    bow = [list(d) for d in out[0]]
    w, c = bow[3][0]
    bow[3][0] = (w, c + 1)
    return bow, out[1]


def _drop_a_word(out):
    # both paths lose the vocabulary's last word (and its counts) alike
    last = len(out[1]) - 1
    return [[(w, c) for w, c in d if w != last] for d in out[0]], list(out[1])[:-1]


def test_token_names_sort_as_the_ids_and_survive_tokenize():
    from strutopy_tpu_torch.corpus.preprocess import DEFAULT_STOPWORDS, tokenize

    for V in (26, 300, cs.V_BENCH):
        names = cs.token_names(V)
        assert len(set(names)) == V and list(names) == sorted(names)
        assert tokenize(" ".join(names)) == list(names)
        assert not set(names) & DEFAULT_STOPWORDS


@pytest.mark.parametrize("fault", [None, "native count", "both paths drop a word"])
def test_text_corpus_check(fault):
    docs, _X, names, out = _text_corpus()
    native, python = out[True], out[False]
    if fault == "native count":
        native = _change_one_count(native)
    elif fault == "both paths drop a word":
        native, python = _drop_a_word(native), _drop_a_word(python)
    assert _verdict(cs.check_text_corpus, native, python, docs, names) == (fault is None)


@pytest.fixture(scope="module")
def text_model(tmp_path_factory):
    """The port's fit_model on a rendered corpus, saved, on the CPU."""
    import os

    from strutopy_tpu_torch.pipeline import fit_model

    docs, X, names, out = _text_corpus()
    bow, vocab = out[True]
    d = str(tmp_path_factory.mktemp("text_model"))
    model = fit_model(bow, K=3, X=X, dictionary=vocab, init_type="random", max_em_iter=2,
                      output_dir=d, device="cpu")
    return d, names, model, os.listdir(d)


def test_fit_artifacts_check(text_model):
    d, _names, model, files = text_model
    launches = {"fgh": 1, "cg": 1, "ls": 1}  # the plain versions count none on the CPU
    check = cs.check_fit_artifacts
    assert _verdict(check, files, model.last_bounds, launches, "fit")
    assert not _verdict(check, [f for f in files if f != "vocab.json"], model.last_bounds,
                        launches, "fit")
    assert not _verdict(check, files, model.last_bounds[:1] + [float("nan")], launches, "fit")
    assert not _verdict(check, files, model.last_bounds, dict(launches, cg=0), "fit")


@pytest.mark.parametrize("fault", [None, "report dropped", "counts off by one",
                                   "another encoding"])
def test_infer_text_check(text_model, fault):
    from strutopy_tpu_torch import ThetaServer
    from strutopy_tpu_torch.corpus.preprocess import align_corpus

    d, names, _model, _files = text_model
    srv = ThetaServer(d, device="cpu")
    new_docs, Xn = cs.make_corpus(5, 300, 24, 50, seed=11)
    texts, want_bow, want_report = cs.text_requests(new_docs, names, srv.vocab)
    got = srv.infer_text(texts, X=Xn)
    bow, _ = align_corpus(texts, srv.vocab)
    theta2, eta2 = srv.infer(bow, X=Xn)
    if fault == "report dropped":
        got = got[:2] + ({},)
    elif fault == "counts off by one":
        got = got[:2] + (dict(got[2], tokens_dropped=got[2]["tokens_dropped"] + 1),)
    elif fault == "another encoding":  # an encoder that loses each document's last term
        other = [doc[:-1] for doc in bow]
        got = srv.infer(other, X=Xn) + (dict(got[2], bow=other),)
    assert _verdict(cs.check_infer_text, got, (theta2, eta2, bow), want_bow, want_report,
                    3) == (fault is None)


def test_parking_check():
    state = 13.84e6
    assert _verdict(cs.check_parking, {2: 275.92e6, 4: 276.31e6}, state)
    # a select_model that keeps every run's stage-1 state on the device
    assert not _verdict(cs.check_parking, {2: 275.92e6 + 2 * state, 4: 275.92e6 + 4 * state},
                        state)


def test_eta_check_where_converged():
    rng = np.random.default_rng(0)
    eta = rng.normal(size=(40, 4))
    gm = np.full(40, 1e-6)
    gm_stalled = gm.copy()
    gm_stalled[3] = 1.0
    moved = eta.copy()
    moved[3] += 1.0  # a stalled document may end anywhere
    assert _verdict(cs.check_eta_where_converged, gm, gm_stalled, moved, eta, "eta")
    assert not _verdict(cs.check_eta_where_converged, gm, gm, moved, eta, "eta")
    assert not _verdict(cs.check_eta_where_converged, gm, gm, eta + 1e-2, eta, "eta")
    # the card stalls on many more documents than the reference
    many = gm.copy()
    many[:10] = 1.0
    assert not _verdict(cs.check_eta_where_converged, many, gm, eta, eta, "eta")


# ---------------------------------------------------------------------------
# phase 10: simulate_theta's draws on two devices, each document held to
# its own rounding bound
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sim_models(toy_corpus, toy_dictionary, toy_metadata):
    """One toy fit in the JAX package and the port holding its state."""
    from strutopy_tpu.models.stm import STM as JaxSTM
    from strutopy_tpu_torch import STM
    from strutopy_tpu_torch.utils.convert import state_from_numpy

    train = toy_corpus.train_docs
    kwargs = dict(documents=train, dictionary=toy_dictionary, K=3,
                  X=toy_metadata[: len(train)], max_em_iter=4, init_type="random",
                  model_type="STM", seed=123456)
    jm = JaxSTM(**kwargs)
    jm.expectation_maximization(saving=False)
    m = STM(**kwargs, device="cpu")
    m._state = state_from_numpy(
        {f: np.asarray(getattr(jm._state, f)) for f in jm._state._fields}, "cpu")
    return jm, m


def _sim_draws(sim_models, fault=None):
    """The JAX package's eta draws and the port's CPU draws of one seed,
    the port's with ``fault`` put in, and the documents' factors."""
    from strutopy_tpu.eval.effects import simulate_theta as jax_simulate_theta
    from strutopy_tpu_torch.eval.effects import simulate_theta

    jm, m = sim_models
    want = jax_simulate_theta(jm, n_draws=6, seed=2, chunk=16, return_eta=True)
    got = simulate_theta(m, n_draws=6, seed=2, chunk=16, return_eta=True)
    factors = cs.sim_factors(torch, stages, m, m._corpus.N, "cpu")
    eta = np.asarray(m.eta, np.float32)[None]
    if fault == "noise scaled by 1.01":
        got = eta + 1.01 * (got - eta)
    elif fault == "factor untransposed":  # x = L^-1 z in place of L^-T z
        Lf = factors.double()
        x = torch.as_tensor(got - eta, dtype=torch.float64).permute(1, 2, 0)  # (N, K-1, S)
        z = Lf.mT @ x
        got = eta + torch.linalg.solve_triangular(Lf, z, upper=False).permute(2, 0, 1).numpy()
    return want, got, factors, eta


@pytest.mark.parametrize("fault", [None, "noise scaled by 1.01", "factor untransposed"])
def test_sim_check_holds_each_document_to_its_rounding_bound(sim_models, fault):
    want, got, factors, eta = _sim_draws(sim_models, fault)
    kappa, size, bound = cs.sim_bounds(torch, factors, want - eta)
    diff = np.abs(got - want).max(axis=(0, 2))
    ok, _worst = cs.sim_verdict(kappa, bound, diff, np.ones(diff.shape, bool))
    assert ok == (fault is None), (diff.max(), bound.min())
    assert bound.max() <= cs.SIM_ETA_ATOL


def test_sim_bound_grows_with_the_condition_number():
    # two documents, one well and one badly conditioned, the same draws
    L = torch.stack([torch.eye(3, dtype=torch.float32),
                     torch.diag(torch.tensor([1.0, 1.0, 1e-2]))])
    x = np.ones((2, 2, 3), np.float32)
    kappa, size, bound = cs.sim_bounds(torch, L, x)
    np.testing.assert_allclose(kappa, [1.0, 1e4], rtol=1e-6)
    np.testing.assert_allclose(bound, cs.SIM_C * kappa * 2.0 ** -24, rtol=1e-6)
    # a rounding-sized gap passes on the badly conditioned document only
    diff = np.full(2, 1e-4)
    assert not cs.sim_verdict(kappa, bound, diff, np.array([True, True]))[0]
    assert cs.sim_verdict(kappa, bound, diff, np.array([False, True]))[0]
