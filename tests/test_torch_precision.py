"""TF32 is scoped to the port's entry points: importing the package
leaves ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` as it found them, every entry point
runs with both False and restores them."""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from strutopy_tpu_torch import STM, STMConfig, StreamedEM, ThetaServer, infer_theta, pipeline
from strutopy_tpu_torch.corpus.bow import pad_corpus
from strutopy_tpu_torch.eval.effects import simulate_theta
from strutopy_tpu_torch.eval.heldout import eval_heldout_torch
from strutopy_tpu_torch.ops import mstep
from strutopy_tpu_torch.ops.spectral import spectral_init
from strutopy_tpu_torch.pipeline import train_and_eval_heldout
from strutopy_tpu_torch.utils.precision import float32_matmul
from torch_world import one_thread


@pytest.fixture(autouse=True, scope="module")
def _torch_on_one_thread():
    """torch's CPU ops on one thread for every test of this file and its
    fixtures (tests/torch_world.py::one_thread): under parallel test
    workers a toy fit on torch's default pool waits on busy cores."""
    with one_thread():
        yield


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)


class _FlagSpy(TorchFunctionMode):
    """Records the TF32 flags at every torch call made while it is on."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.seen.add(_flags())
        return func(*args, **(kwargs or {}))


@pytest.fixture
def tf32_on():
    saved = _flags()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.fixture(scope="module")
def fitted(toy_corpus, toy_dictionary, toy_metadata, tmp_path_factory):
    train = toy_corpus.train_docs
    m = STM(train, toy_dictionary, K=3, X=toy_metadata[: len(train)], max_em_iter=2,
            init_type="random", device="cpu")
    m.expectation_maximization()
    out = str(tmp_path_factory.mktemp("model"))
    m.save_model(out)
    return m, out


def test_import_and_fit_leave_the_flags_alone():
    code = (
        "import torch\n"
        "m, c = torch.backends.cuda.matmul, torch.backends.cudnn\n"
        "m.allow_tf32 = True; c.allow_tf32 = True\n"
        "import numpy as np, strutopy_tpu_torch as S\n"
        "assert (m.allow_tf32, c.allow_tf32) == (True, True), 'import changed the flags'\n"
        "from strutopy_tpu_torch.models import stm\n"
        "inside = []\n"
        "stm.validate_state = lambda s, it: inside.append((m.allow_tf32, c.allow_tf32))\n"
        "rng = np.random.default_rng(0)\n"
        "docs = [[(int(w), 1) for w in rng.choice(30, 8, replace=False)] for _ in range(12)]\n"
        "cfg = S.STMConfig(K=3, init_type='random', max_em_iter=2, debug_checks=True)\n"
        "S.STM(docs, config=cfg, device='cpu').expectation_maximization()\n"
        "assert inside == [(False, False)] * 2, inside\n"
        "assert (m.allow_tf32, c.allow_tf32) == (True, True), 'the fit changed the flags'\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_context_manager_restores_on_error(tf32_on):
    with pytest.raises(RuntimeError):
        with float32_matmul():
            assert _flags() == (False, False)
            raise RuntimeError("boom")
    assert _flags() == (True, True)


def test_context_manager_overlapping_threads_restore_once(tf32_on):
    """Two threads inside at once: the first to leave must not turn TF32
    back on under the other, and the last to leave restores the flags."""
    import threading

    a_in, b_in, a_out = threading.Event(), threading.Event(), threading.Event()
    seen = {}

    def first():
        with float32_matmul():
            a_in.set()
            b_in.wait(10)
        a_out.set()

    def second():
        a_in.wait(10)
        with float32_matmul():
            b_in.set()
            a_out.wait(10)
            seen["after first left"] = _flags()
        seen["after both left"] = _flags()

    threads = [threading.Thread(target=f) for f in (first, second)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(20)
    assert seen == {"after first left": (False, False), "after both left": (True, True)}
    with float32_matmul():
        with float32_matmul():
            assert _flags() == (False, False)
        assert _flags() == (False, False)
    assert _flags() == (True, True)


def _stm_fit(fitted, toy_corpus, toy_dictionary):
    def run():
        m = STM(toy_corpus.train_docs, toy_dictionary, K=3, max_em_iter=1, init_type="random",
                device="cpu")
        m.expectation_maximization()
        m.transform(toy_corpus.train_docs[:4])

    return run


def _streamed(fitted, toy_corpus, toy_dictionary):
    c = pad_corpus(toy_corpus.train_docs[:32], V=len(toy_dictionary))
    n = 16
    D_np, design = mstep.make_prevalence_design(None, c.doc_ok, device="cpu")
    parts = [(c.words[i:i + n], c.counts[i:i + n], np.zeros(n, np.int32), c.doc_ok[i:i + n],
              D_np[i:i + n]) for i in (0, n)]
    cfg = STMConfig(K=3, batch_size=16, model_type="CTM")
    sem = StreamedEM(cfg, design, parts, device="cpu")
    states = sem.init_parts(None, K=3, V=c.V)
    return lambda: sem.em_iteration(states[0], states)


# name -> prepare(fitted, toy_corpus, toy_dictionary) -> the call to spy on
ENTRY_POINTS = {
    "STM": _stm_fit,
    "spectral_init": lambda f, tc, td: lambda: spectral_init(tc.train_docs, 3, len(td), device="cpu"),
    "infer_theta": lambda f, tc, td: functools.partial(
        infer_theta, f[0].beta, f[0].sigma, np.zeros((4, 2), np.float32), tc.train_docs[:4],
        f[0].config, device="cpu"),
    "ThetaServer.infer": lambda f, tc, td: functools.partial(
        ThetaServer(f[1], device="cpu").infer, tc.train_docs[:4], X=np.zeros(4)),
    "ThetaServer.infer_text": lambda f, tc, td: functools.partial(
        ThetaServer(f[1], device="cpu").infer_text, ["alpha beta", "gamma"], X=np.zeros(2)),
    "fit_model": lambda f, tc, td: lambda: pipeline.fit_model(
        tc.train_docs, 3, max_em_iter=1, model_type="CTM", device="cpu"),
    "select_model": lambda f, tc, td: lambda: pipeline.select_model(
        tc.train_docs, 3, runs=2, cast_iters=1, max_em_iter=2, model_type="CTM",
        return_models=False, device="cpu"),
    "train_and_eval_heldout": lambda f, tc, td: lambda: train_and_eval_heldout(
        tc.train_docs, tc.test_docs, 3, init_type="random", max_em_iter=1, fast=True,
        model_type="CTM", device="cpu"),
    "eval_heldout_torch": lambda f, tc, td: functools.partial(
        eval_heldout_torch, f[0]._corpus.words, f[0]._corpus.counts, f[0]._corpus.doc_ok,
        f[0].theta, f[0].beta, device="cpu"),
    "StreamedEM.em_iteration": _streamed,
    "simulate_theta": lambda f, tc, td: lambda: simulate_theta(f[0], n_draws=2, chunk=16),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_runs_in_true_float32_and_restores(name, tf32_on, fitted, toy_corpus,
                                                       toy_dictionary):
    call = ENTRY_POINTS[name](fitted, toy_corpus, toy_dictionary)
    with _FlagSpy() as spy:
        call()
    assert spy.seen == {(False, False)}, spy.seen
    assert _flags() == (True, True)
