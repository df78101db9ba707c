"""bench_torch.py, the port's headline benchmark, on the CPU at toy size:
its corpus against bench.py's bit for bit, its warm state against the
JAX package's run of bench.py's sequence from one injected beta (the
bound contract of tests/test_torch_em.py), the timed E-step, the
baseline cache, no fallback without a card, no jax; and chip_smoke.py
phase 15's checks on a good and on wrong runs of the entry point."""

import contextlib
import functools
import importlib.util
import io
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_torch as bt
import chip_smoke as cs
from strutopy_tpu.corpus.bow import pad_corpus as jax_pad_corpus
from strutopy_tpu.models import em as jax_em
from strutopy_tpu.models.config import STMConfig as JaxConfig
from strutopy_tpu.models.state import init_state as jax_init_state
from strutopy_tpu.ops import mstep as jax_mstep
from strutopy_tpu_torch.utils import reference_numpy as ref
from strutopy_tpu_torch.utils.convert import state_to_numpy
from torch_world import one_thread


@pytest.fixture(autouse=True, scope="module")
def _torch_on_one_thread():
    """torch's CPU ops on one thread for every test of this file and its
    fixtures (tests/torch_world.py::one_thread): under parallel test
    workers a toy fit on torch's default pool waits on busy cores."""
    with one_thread():
        yield


ROOT = Path(__file__).resolve().parents[1]
TOY = dict(K=8, V=300, N=48, n_words=50)
SIZES = dict(K=TOY["K"], V=TOY["V"])


def _beta0(K, V, seed=7):
    g = np.random.RandomState(seed).gamma(0.1, 1.0, (K, V))
    return g / g.sum(axis=1, keepdims=True)


def _load_bench_py(monkeypatch):
    """bench.py imported by path; the two JAX_* variables its import sets
    are put back as they were when the test ends."""
    for var in ("JAX_COMPILATION_CACHE_DIR", "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"):
        if var in os.environ:
            monkeypatch.setenv(var, os.environ[var])
        else:
            monkeypatch.delenv(var, raising=False)
    spec = importlib.util.spec_from_file_location("bench_py", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", [0, 5])
def test_make_corpus_is_bench_py_bit_for_bit(seed, monkeypatch):
    bench = _load_bench_py(monkeypatch)
    assert (bt.K, bt.V, bt.N, bt.N_WORDS, bt.BASELINE_DOCS) == (
        bench.K, bench.V, bench.N, bench.N_WORDS, bench.BASELINE_DOCS) == (
        100, 10_000, 8_192, 300, 512)
    for name, value in (("K", TOY["K"]), ("V", TOY["V"]), ("N", TOY["N"]),
                        ("N_WORDS", TOY["n_words"])):
        monkeypatch.setattr(bench, name, value)
    docs, X = bt.make_corpus(**TOY, seed=seed)
    want_docs, want_X = bench.make_corpus(seed)
    assert docs == want_docs
    np.testing.assert_array_equal(X, want_X)


@pytest.fixture(scope="module")
def warm():
    """bench.py's sequence (bench.py:62-96) in both packages from one
    injected beta at toy size: the port's warm_up, and the JAX package's
    make_em_step x 5 then local_estep_stats(...)[0].bound."""
    docs, X = bt.make_corpus(**TOY)
    beta0 = _beta0(TOY["K"], TOY["V"])
    port = bt.warm_up(docs, X, **SIZES, beta_init=beta0, device="cpu")

    corpus = jax_pad_corpus(docs, V=TOY["V"])
    cfg = JaxConfig(K=TOY["K"], model_type="STM", mode="ols", init_type="random",
                    batch_size=256, newton_pass1_iters=6, newton_straggler_frac=0.25)
    D_np, design = jax_mstep.make_prevalence_design(X, corpus.doc_ok)
    data = jax_em.CorpusData.single(
        words=jnp.asarray(corpus.words), counts=jnp.asarray(corpus.counts),
        aspects=jnp.zeros(corpus.N, jnp.int32), doc_ok=jnp.asarray(corpus.doc_ok),
        D=jnp.asarray(D_np, jnp.float32))
    state = jax_init_state(jax.random.PRNGKey(123456), K=TOY["K"], V=TOY["V"], N=corpus.N,
                           P=D_np.shape[1], beta_init=jnp.asarray(beta0, jnp.float32))
    em = jax_em.make_em_step(cfg, design, None, corpus.word_counts())
    bounds = []
    for _ in range(bt.WARM_ITERS):
        state = em(state, data)
        bounds.append(float(state.bound))
    final = float(jax_em.local_estep_stats(state, data, cfg)[0].bound)
    return port, (state, bounds, int(state.straggler_overflow), final)


def test_warm_state_matches_the_jax_package(warm):
    (cfg, state, data, bounds, overflow), (jstate, jbounds, joverflow, jfinal) = warm
    assert cfg.newton_pass1_iters == 6 and cfg.newton_straggler_frac == 0.25
    assert len(bounds) == bt.WARM_ITERS
    # the bound contract of tests/test_torch_em.py (tests/test_pallas_stages.py:185-189)
    np.testing.assert_allclose(bounds, jbounds, rtol=1e-5)
    assert overflow == joverflow
    got = state_to_numpy(state)
    for name, tol in (("beta", 1e-4), ("sigma", 5e-3), ("mu", 5e-3), ("eta", 5e-3),
                      ("theta", 1e-3), ("gamma", 5e-3)):
        np.testing.assert_allclose(got[name], np.asarray(getattr(jstate, name)), atol=tol,
                                   err_msg=name)
    res = bt.time_estep(state, data, cfg, repeats=1)
    np.testing.assert_allclose(res["bounds"][0], jfinal, rtol=1e-5)


def test_time_estep_gives_a_finite_rate_and_equal_bounds(warm):
    cfg, state, data, _bounds, _overflow = warm[0]
    res = bt.time_estep(state, data, cfg)
    assert len(res["walls"]) == len(res["bounds"]) == bt.REPEATS == 5
    assert math.isfinite(res["docs_per_sec"]) and res["docs_per_sec"] > 0
    assert res["docs_per_sec"] == pytest.approx(TOY["N"] / np.median(res["walls"]))
    assert all(math.isfinite(b) for b in res["bounds"])
    assert res["bound_gap"] <= 1e-6
    np.testing.assert_allclose(res["bounds"], res["bounds"][0], rtol=1e-6)
    # the wrappers launch nothing on CPU tensors (their plain versions run)
    assert res["launches"] == {k: 0 for k in bt.NEWTON_KERNELS}


BASE = dict(K=5, V=100, n_words=30, n_docs=8)


@pytest.fixture()
def base_docs():
    return bt.make_corpus(K=BASE["K"], V=BASE["V"], N=12, n_words=BASE["n_words"])


def _count_e_steps(monkeypatch):
    calls = []
    real = ref.e_step

    def e_step(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(ref, "e_step", e_step)
    return calls


def test_baseline_is_measured_and_cached(tmp_path, base_docs, monkeypatch):
    path = tmp_path / "baseline.json"
    calls = _count_e_steps(monkeypatch)
    dps, cpu, cached = bt.measure_baseline(*base_docs, path, **BASE)
    assert not cached and cpu == bt.cpu_name() and len(calls) == 4  # 1 warm + 3 timed
    saved = json.loads(path.read_text())
    assert saved["config"] == [BASE["K"], BASE["V"], BASE["n_words"]]
    assert saved["cpu"] == cpu and saved["docs_per_sec"] == dps > 0
    assert saved["measured_docs"] == BASE["n_docs"]
    assert len(saved["seconds_per_repeat"]) == 3
    assert dps == BASE["n_docs"] / min(saved["seconds_per_repeat"])

    def no_e_step(*args, **kw):
        raise AssertionError("the cached baseline was measured again")

    monkeypatch.setattr(ref, "e_step", no_e_step)
    assert bt.measure_baseline(*base_docs, path, **BASE) == (dps, cpu, True)


@pytest.mark.parametrize("differs", ["config", "cpu"])
def test_baseline_is_measured_again_for_another_config_or_cpu(differs, tmp_path, base_docs,
                                                               monkeypatch):
    path = tmp_path / "baseline.json"
    bt.measure_baseline(*base_docs, path, **BASE)
    calls = _count_e_steps(monkeypatch)
    kw = dict(BASE)
    if differs == "config":
        kw["n_words"] += 1
    else:
        monkeypatch.setattr(bt, "cpu_name", lambda: "another CPU, 2 processors")
    _dps, cpu, cached = bt.measure_baseline(*base_docs, path, **kw)
    assert not cached and len(calls) == 4
    saved = json.loads(path.read_text())
    assert saved["config"] == [kw["K"], kw["V"], kw["n_words"]] and saved["cpu"] == cpu


@pytest.mark.parametrize("argv", [[], ["--device", "cuda"]])
def test_no_card_exits_non_zero_naming_the_device(argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as e:
        bt.main(argv)
    assert e.value.code not in (0, None)
    assert "--device cuda" in str(e.value.code) and "no CUDA device" in str(e.value.code)


NO_JAX = """
import sys


class Refuse:
    \"\"\"Every import of jax or of the JAX package fails.  (Setting
    sys.modules["jax"] to None, as tests/test_torch_cli.py does, breaks
    scipy.optimize, whose array-API helpers look jax up in sys.modules.)\"\"\"

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "strutopy_tpu"):
            raise ImportError(f"{name} refused")


sys.meta_path.insert(0, Refuse())
import bench_torch as bt
docs, X = bt.make_corpus(K=5, V=100, N=12, n_words=30)
res = bt.measure_card(docs, X, "cpu", K=5, V=100)
base = bt.measure_baseline(docs, X, sys.argv[1], K=5, V=100, n_words=30, n_docs=4)
print("RATE", res["docs_per_sec"] > 0, base[0] > 0)
loaded = sorted(m for m, v in sys.modules.items()
                if v is not None and (m.split(".")[0] in ("jax", "jaxlib", "strutopy_tpu")))
print("JAX MODULES", loaded)
"""


def test_bench_torch_imports_no_jax(tmp_path):
    out = subprocess.run([sys.executable, "-c", NO_JAX, str(tmp_path / "b.json")], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "RATE True True" in out.stdout and "JAX MODULES []" in out.stdout


# ---------------------------------------------------------------------------
# chip_smoke.py phase 15's checks
# ---------------------------------------------------------------------------

CARD_LAUNCHES = {"fgh": 80, "cg": 80, "ls": 80, "direction": 80, "accept": 80}


@pytest.fixture(scope="module")
def bench_run(tmp_path_factory):
    """bench_torch.main(["--device", "cpu"]) at toy size: (standard output,
    standard error with the launches a card run prints, the cache)."""
    path = tmp_path_factory.mktemp("bench") / "baseline.json"
    docs, X = bt.make_corpus(**TOY)
    out, err = io.StringIO(), io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bt, "make_corpus", lambda: (docs, X))
        mp.setattr(bt, "measure_card", functools.partial(bt.measure_card, **SIZES))
        mp.setattr(bt, "measure_baseline", functools.partial(
            bt.measure_baseline, path=path, **SIZES, n_words=TOY["n_words"], n_docs=8))
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            assert bt.main(["--device", "cpu"]) == 0
    zero = json.dumps({k: 0 for k in bt.NEWTON_KERNELS})
    assert zero in err.getvalue()
    return out.getvalue(), err.getvalue().replace(zero, json.dumps(CARD_LAUNCHES)), \
        json.loads(path.read_text())


def _with_line(out, **change):
    head = json.loads(out)
    for k, v in change.items():
        if v is None:
            del head[k]
        else:
            head[k] = v
    return json.dumps(head) + "\n"


def _bad(case, rc, out, err, cache):
    head = json.loads(out)
    if case == "missing key":
        out = _with_line(out, unit=None)
    elif case == "extra key":
        out = _with_line(out, device="cuda")
    elif case == "NaN value":
        out = _with_line(out, value=float("nan"))
    elif case == "two stdout lines":
        out = "warming up\n" + out
    elif case == "vs_baseline off":
        out = _with_line(out, vs_baseline=round(head["vs_baseline"] * 1.1 + 0.1, 2))
    elif case == "zero launches":
        err = err.replace(json.dumps(CARD_LAUNCHES),
                          json.dumps(dict(CARD_LAUNCHES, cg=0)))
    elif case == "non-zero rc":
        rc = 1
    elif case == "cache of another CPU":
        cache = dict(cache, cpu="another CPU, 2 processors")
    return rc, out, err, cache


@pytest.fixture()
def toy_config(monkeypatch):
    """The checks read bench_torch's configuration: the toy run's here."""
    for name, value in (("K", TOY["K"]), ("V", TOY["V"]), ("N_WORDS", TOY["n_words"])):
        monkeypatch.setattr(bt, name, value)


def test_phase_15_checks_pass_a_good_run(bench_run, toy_config):
    out, err, cache = bench_run
    fails = cs.Failures()
    head = cs.check_bench(fails, 0, out, err, cache, cs.cpu_name())
    assert fails == []
    assert head == json.loads(out) and list(head) == ["metric", "value", "unit", "vs_baseline"]
    fig = cs.bench_figures(err)
    assert fig["launches"] == CARD_LAUNCHES and fig["cached"] is False
    assert fig["baseline"] == cache["docs_per_sec"] and fig["cpu"] == cache["cpu"]


@pytest.mark.parametrize("case", ["missing key", "extra key", "NaN value", "two stdout lines",
                                  "vs_baseline off", "zero launches", "non-zero rc",
                                  "cache of another CPU"])
def test_phase_15_checks_fail_a_wrong_run(case, bench_run, toy_config):
    fails = cs.Failures()
    cs.check_bench(fails, *_bad(case, 0, *bench_run), cs.cpu_name())
    assert len(fails) >= 1, case
