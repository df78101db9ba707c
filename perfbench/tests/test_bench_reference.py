"""The batched reference against the frozen float64 oracle at toy sizes,
and the control's TF32 rounding."""

import numpy as np
import torch

from perfbench import corpus
from perfbench.reference import oracle_numpy as O
from perfbench.reference import stm_ref as R


def _toy(seed=3, K=6, V=300, N=48):
    docs, X, _ = corpus.bench_corpus(K, V, N, 40, seed)
    beta = corpus.random_beta(K, V, seed)
    return docs, X, beta, np.zeros((N, K - 1)), 20.0 * np.eye(K - 1)


def test_reference_e_step_and_m_step_match_the_oracle():
    docs, X, beta, zero, sigma = _toy()
    o = O.e_step(docs, beta, zero, zero, sigma)
    r = R.e_step(docs, beta, zero, zero, sigma, R.Prec("float64"))
    assert abs(r["bound"].sum().item() - o[2]) < 1e-6 * abs(o[2])
    assert np.abs(r["beta_ss"].numpy() - o[0]).max() < 1e-4
    assert np.abs(r["sigma_ss"].numpy() - o[1]).max() < 1e-3
    # the oracle's BFGS stops at its own tolerance; the reference's Newton
    # goes further down, never above
    f_o = R.objective_at(docs, beta, zero, sigma, o[3])
    gap = (f_o - r["f"]).numpy()
    assert gap.min() > -1e-9 and gap.max() < 1e-6
    D = np.c_[np.ones(len(docs)), X]
    m = R.m_step_lda_ols(r, D)
    ob, _mu, osig, og = O.m_step_stm_ols(o[0], o[1], o[3], D)
    assert np.abs(m["beta"].numpy() - ob).max() < 1e-6
    assert np.abs(m["sigma"].numpy() - osig).max() < 1e-4
    assert np.abs(m["gamma"].numpy() - og).max() < 1e-4


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.14159265])
    y = R.tf32_round(x)
    assert y[0] == 1.0 and y[1] == 1.0 + 2 ** -10
    assert y[2] == 1.0  # a tie goes to the even mantissa
    assert y[3] == 1.0 + 2 * 2 ** -10
    assert abs(y[4] + 3.14159265) <= 2 ** -10 * 4
    bits = y.view(torch.int32) & 0x1FFF
    assert (bits == 0).all()
