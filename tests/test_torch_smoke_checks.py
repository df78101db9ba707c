"""The element-by-element checks that chip_smoke.py holds each CUDA
kernel to, run on the CPU: an independent implementation of the same
stages (the JAX Pallas kernels in interpret mode) passes them, and
kernels that are wrong in small ways fail them.  Each wrong kernel is
simulated by the plain versions with the fault put in."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import chip_smoke as cs
from strutopy_tpu.ops import estep as jax_estep
from strutopy_tpu.ops.pallas_stages import (
    pallas_cg_impl,
    pallas_fgh_impl,
    pallas_linesearch_impl,
)
from strutopy_tpu_torch.ops import stages


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


@pytest.mark.parametrize("mutant, bf16", [
    (_sweep_reads_8_step_sizes, False),
    (_fgh_drops_a_word, False),
    (_fgh_drops_a_word, True),
    (_hessian_in_the_other_rounding, False),
    (_hessian_in_the_other_rounding, True),
    (_cg_one_step_short, True),
    (_cg_rounds_p_too, True),
], ids=lambda v: v.__name__.strip("_") if callable(v) else f"bf16={v}")
def test_smoke_checks_fail_a_wrong_kernel(mutant, bf16):
    inputs, want, aux = _chunk(bf16)
    wrong = mutant(inputs, want, aux, bf16)
    worst = _worst(inputs, {**want, **wrong}, want, aux, bf16)
    assert all(worst[name] > 1.0 for name in wrong), worst
    assert all(worst[name] == 0.0 for name in worst if name not in wrong), worst
