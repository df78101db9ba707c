"""``validate_state`` (strutopy_tpu_torch/utils/debug.py) against the JAX
package's: every check fires in both on the same broken state with the
same message, and ``debug_checks=True`` runs it each EM iteration."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from strutopy_tpu.models.state import init_state as jax_init_state
from strutopy_tpu.utils.debug import NumericalCheckError as JaxCheckError
from strutopy_tpu.utils.debug import validate_state as jax_validate_state
from strutopy_tpu_torch import STM, STMConfig
from strutopy_tpu_torch.models import stm as stm_module
from strutopy_tpu_torch.utils.convert import state_from_numpy
from strutopy_tpu_torch.utils.debug import NumericalCheckError, validate_state
from torch_world import one_thread


@pytest.fixture(autouse=True, scope="module")
def _torch_on_one_thread():
    """torch's CPU ops on one thread for every test of this file and its
    fixtures (tests/torch_world.py::one_thread): under parallel test
    workers a toy fit on torch's default pool waits on busy cores."""
    with one_thread():
        yield


K, V, N = 4, 12, 6


def _good():
    """A valid state as a dict of numpy arrays."""
    s = jax_init_state(jax.random.PRNGKey(0), K=K, V=V, N=N, P=2)
    d = {f: np.array(getattr(s, f)) for f in s._fields}
    d["bound"] = np.float32(-12.5)
    return s, d


def _break(d, what):
    d = {k: v.copy() for k, v in d.items()}
    if what == "beta_negative":
        d["beta"][1, 3] = -0.25
    elif what == "beta_nonfinite":
        d["beta"][0, 0] = np.inf
    elif what == "beta_rows":
        d["beta"][2] *= 1.5
    elif what == "theta_nonfinite":
        d["theta"][0, 0] = np.nan
    elif what == "theta_rows":
        d["theta"][3] = 0.1
    elif what == "sigma_nonfinite":
        d["sigma"][0, 0] = np.inf
    elif what == "sigma_asymmetric":
        d["sigma"][0, 1] += 0.5
    elif what == "sigma_negative_eig":
        d["sigma"] = -np.eye(K - 1, dtype=np.float32)
    elif what == "bound_nonfinite":
        d["bound"] = np.float32(np.nan)
    return d


CASES = {
    "beta_negative": "beta has negative entries",
    "beta_nonfinite": "beta has non-finite entries",
    "beta_rows": "beta rows do not sum to 1",
    "theta_nonfinite": "theta has non-finite entries",
    "theta_rows": "theta rows do not sum to 1",
    "sigma_nonfinite": "sigma has non-finite entries",
    "sigma_asymmetric": "sigma is not symmetric",
    "sigma_negative_eig": "sigma has negative eigenvalue",
    "bound_nonfinite": "bound is nan",
}


def test_valid_state_passes_in_both():
    jstate, d = _good()
    jax_validate_state(jstate._replace(bound=jnp.asarray(d["bound"])), 0)
    validate_state(state_from_numpy(d, "cpu"), 0)


@pytest.mark.parametrize("what", sorted(CASES))
def test_each_check_fires_in_both_with_one_message(what):
    jstate, d = _good()
    bad = _break(d, what)
    with pytest.raises(JaxCheckError, match=CASES[what]) as jerr:
        jax_validate_state(jstate._replace(**{k: jnp.asarray(v) for k, v in bad.items()}), 7)
    with pytest.raises(NumericalCheckError, match=CASES[what]) as err:
        validate_state(state_from_numpy(bad, "cpu"), 7)
    assert str(err.value) == str(jerr.value)
    assert str(err.value).startswith("iter 7: ")
    assert issubclass(NumericalCheckError, AssertionError)


def test_debug_checks_validates_every_iteration(monkeypatch, toy_corpus, toy_dictionary):
    seen = []
    monkeypatch.setattr(stm_module, "validate_state",
                        lambda state, it: (seen.append(it), validate_state(state, it)))
    cfg = STMConfig(K=3, init_type="random", max_em_iter=3, convergence_threshold=0.0,
                    debug_checks=True)
    m = STM(toy_corpus.train_docs, toy_dictionary, config=cfg, device="cpu")
    m.expectation_maximization()
    assert seen == [0, 1, 2]
    # off by default: nothing is validated
    seen.clear()
    STM(toy_corpus.train_docs, toy_dictionary, config=cfg.replace(debug_checks=False),
        device="cpu").expectation_maximization()
    assert seen == []


def test_debug_checks_stops_a_damaged_fit(toy_corpus, toy_dictionary):
    cfg = STMConfig(K=3, init_type="random", max_em_iter=2, debug_checks=True)
    m = STM(toy_corpus.train_docs, toy_dictionary, config=cfg, device="cpu")
    step = m._em_step

    def damaged(state, data):
        out = step(state, data)
        beta = out.beta.clone()
        beta[0, 0] = -1.0
        return dataclasses.replace(out, beta=beta)

    m._em_step = m._em_step_cold = damaged
    with pytest.raises(NumericalCheckError, match="iter 0: beta has negative entries"):
        m.expectation_maximization()
