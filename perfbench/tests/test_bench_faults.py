"""A whole run (``run.py --device cpu``: every step but the look for a
chip, at the configurations' toy sizes on the program's plain kernels)
comes out correct, and comes out not correct with the timed path broken
underneath in each way the cell can break: a step that returns its state
unchanged, half of the batch left out and the mean taken over the rest,
an answer altered where it is produced.  (One chip: no exchange between
chips to leave out.)"""

import json

import pytest
import torch

from perfbench import run
from strutopy_tpu_torch.models import em


def _run(capsys, cell, seed=5):
    assert run.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.5",
                     "--device", "cpu"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _after_warm_up(fault, warm=5):
    """Apply ``fault`` to every EM step after the warm-up's."""
    n = {"calls": 0}

    def step(orig):
        def wrapped(*a, **k):
            n["calls"] += 1
            return fault(orig, *a, **k) if n["calls"] > warm else orig(*a, **k)
        return wrapped
    return step


def _unchanged(orig, state, *a, **k):
    return state


def _half(orig, beta, mu, eta0, siginv, sigmaentropy, words, counts, aspects, doc_ok, *a, **k):
    keep = torch.arange(words.shape[0], device=words.device) < words.shape[0] // 2
    res = orig(beta, mu, eta0, siginv, sigmaentropy, words, counts, aspects, doc_ok & keep,
               *a, **k)
    return res._replace(beta_ss=2 * res.beta_ss, sigma_ss=2 * res.sigma_ss, bound=2 * res.bound,
                        eta=torch.where(keep[:, None], res.eta, eta0))


def _altered(orig, *a, **k):
    res = orig(*a, **k)
    eta = res.eta.clone()
    eta[0, 0] += 1.0
    return res._replace(eta=eta)


FIT_CELLS = ("k100_fit",)


@pytest.mark.parametrize("cell", FIT_CELLS)
def test_a_sound_run_is_correct(capsys, cell):
    out = _run(capsys, cell)
    assert out["correct"] is True, out["checks"]
    assert out["metrics"] == {} and out["device"]["platform"] == "cpu"
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", FIT_CELLS)
@pytest.mark.parametrize("where,fault", [("em_iteration", _unchanged), ("run_estep", _half),
                                         ("run_estep", _altered)])
def test_a_broken_fit_is_not_correct(capsys, monkeypatch, cell, where, fault):
    monkeypatch.setattr(em, where, _after_warm_up(fault)(getattr(em, where)))
    assert _run(capsys, cell)["correct"] is False
