"""The port's checkpoints (utils/checkpoint.py) and the fit options that
lean on them: a resumed fit is the uninterrupted fit bit for bit, either
package resumes the other's checkpoint, ``reinitialize`` and
``start_iter``."""

import numpy as np
import pytest
import torch

from strutopy_tpu.models.stm import STM as JaxSTM
from strutopy_tpu.utils import checkpoint as jax_checkpoint
from strutopy_tpu_torch import STM
from strutopy_tpu_torch.dgp import CorpusCreation
from strutopy_tpu_torch.utils import checkpoint
from strutopy_tpu_torch.utils.convert import state_to_numpy
from torch_world import one_thread


@pytest.fixture(autouse=True, scope="module")
def _torch_on_one_thread():
    """torch's CPU ops on one thread for every test of this file and its
    fixtures (tests/torch_world.py::one_thread): under parallel test
    workers a toy fit on torch's default pool waits on busy cores."""
    with one_thread():
        yield


K = 3


@pytest.fixture(scope="module")
def corpus():
    return CorpusCreation(K, 40, 50, 150, seed=11).generate_documents()


def _kw(corpus, **extra):
    kw = dict(documents=corpus.documents, dictionary=corpus.dictionary, K=K,
              X=corpus.metadata[:, 0].astype(np.float64), init_type="random",
              batch_size=16, convergence_threshold=0.0)
    kw.update(extra)
    return kw


def _same_state(a, b):
    for f, x in state_to_numpy(a).items():
        y = state_to_numpy(b)[f]
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("extra", [
    dict(),
    dict(model_type="CTM", max_em_iter_full=12),  # the default two-pass schedule
    dict(content=True, content_fit=True),
])
def test_resume_is_bit_identical(tmp_path, corpus, extra):
    extra = dict(extra)
    n = extra.pop("max_em_iter_full", 4)
    if extra.pop("content_fit", False):
        extra["beta_index"] = corpus.metadata[:, 0].astype(np.int32)
    ckpt = str(tmp_path / "state.npz")
    full = STM(max_em_iter=n, device="cpu", **_kw(corpus, **extra))
    full.expectation_maximization()
    first = STM(max_em_iter=n // 2, device="cpu", **_kw(corpus, **extra))
    first.expectation_maximization(checkpoint_path=ckpt, checkpoint_every=1)
    rest = STM(max_em_iter=n, device="cpu", **_kw(corpus, **extra))
    rest.expectation_maximization(checkpoint_path=ckpt, resume=True)
    assert rest.last_bounds == full.last_bounds and len(full.last_bounds) == n
    _same_state(rest._state, full._state)
    # the final checkpoint holds the final state
    state, bounds, it, cfg = checkpoint.load_checkpoint(ckpt, device="cpu")
    assert it == n and bounds == full.last_bounds and cfg == full.config.to_json()
    _same_state(state, full._state)


def test_checkpoint_round_trips_every_field_in_its_dtype(tmp_path, corpus):
    m = STM(max_em_iter=1, device="cpu", **_kw(corpus))
    m.expectation_maximization()
    path = str(tmp_path / "sub" / "c.npz")
    checkpoint.save_checkpoint(path, m._state, m.last_bounds, 1)
    state, bounds, it, cfg = checkpoint.load_checkpoint(path, device="cpu")
    assert cfg is None and it == 1 and bounds == m.last_bounds
    assert state.opt_iters.dtype == torch.int32 and state.opt_iters.any()
    assert state.straggler_overflow.dtype == torch.int32
    _same_state(state, m._state)
    # checkpoints from before a field existed
    with np.load(path) as z:
        old = {k: z[k] for k in z.files if k not in ("opt_iters", "straggler_overflow")}
    np.savez(str(tmp_path / "old.npz"), **old)
    state, *_ = checkpoint.load_checkpoint(str(tmp_path / "old.npz"), device="cpu")
    assert not state.opt_iters.any() and state.opt_iters.shape == (m._state.eta.shape[0],)
    old.pop("sigma")
    np.savez(str(tmp_path / "bad.npz"), **old)
    with pytest.raises(ValueError, match="lacks state fields"):
        checkpoint.load_checkpoint(str(tmp_path / "bad.npz"), device="cpu")


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_package_resumes_the_other_checkpoint(tmp_path, corpus, writer):
    """Two iterations in one package, checkpointed; two more in the other
    from that file: the bounds follow the uninterrupted fit of the
    resuming package (the packages agree to 1e-4 an iteration)."""
    ckpt = str(tmp_path / "state.npz")
    kw = _kw(corpus)
    First, Rest = (JaxSTM, STM) if writer == "jax" else (STM, JaxSTM)
    dev = lambda cls: dict(device="cpu") if cls is STM else {}  # noqa: E731
    first = First(max_em_iter=2, **kw, **dev(First))
    first.expectation_maximization(checkpoint_path=ckpt)
    rest = Rest(max_em_iter=4, **kw, **dev(Rest))
    rest.expectation_maximization(checkpoint_path=ckpt, resume=True)
    full = Rest(max_em_iter=4, **kw, **dev(Rest))
    full.expectation_maximization()
    assert len(rest.last_bounds) == 4
    np.testing.assert_array_equal(rest.last_bounds[:2], first.last_bounds)
    np.testing.assert_allclose(rest.last_bounds, full.last_bounds, rtol=1e-4)
    np.testing.assert_allclose(rest.beta, full.beta, rtol=1e-3, atol=1e-6)
    # the file has one layout, whoever wrote it
    a = checkpoint.load_checkpoint(ckpt, device="cpu")
    b = jax_checkpoint.load_checkpoint(ckpt)
    assert a[1:] == b[1:]
    for f, x in state_to_numpy(a[0]).items():
        y = np.asarray(getattr(b[0], f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y)


def test_reinitialize_and_start_iter(corpus):
    m = STM(max_em_iter=2, seed=5, device="cpu", **_kw(corpus))
    m.expectation_maximization()
    first = list(m.last_bounds)
    # a restart under another seed is the fit constructed with that seed
    m.reinitialize(9)
    assert m.last_bounds == [] and float(m._state.bound) == -np.inf
    m.expectation_maximization()
    fresh = STM(max_em_iter=2, seed=9, device="cpu", **_kw(corpus))
    fresh.expectation_maximization()
    assert m.last_bounds == fresh.last_bounds != first
    _same_state(m._state, fresh._state)
    jm = JaxSTM(max_em_iter=2, seed=5, **_kw(corpus))
    jm.reinitialize(9).expectation_maximization(saving=False)
    np.testing.assert_allclose(m.last_bounds, jm.last_bounds, rtol=1e-4)
    # start_iter continues the partial fit in place
    m.config = m.config.replace(max_em_iter=4)
    m.expectation_maximization(start_iter=2)
    full = STM(max_em_iter=4, seed=9, device="cpu", **_kw(corpus))
    full.expectation_maximization()
    assert m.last_bounds == full.last_bounds
    with pytest.raises(ValueError, match="init_type='random'"):
        STM(**{**_kw(corpus), "init_type": "spectral"}, device="cpu").reinitialize(1)


def test_saving_writes_the_artifacts(tmp_path, corpus):
    out = str(tmp_path / "fit")
    m = STM(max_em_iter=1, device="cpu", **_kw(corpus))
    m.expectation_maximization(saving=True, output_dir=out)
    np.testing.assert_array_equal(np.load(out + "/beta_hat.npy"), m.beta)
    assert not (tmp_path / "fit" / "kappa_hat.npy").exists()
