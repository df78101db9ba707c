"""The port's experiment pipeline (strutopy_tpu_torch/pipeline.py) and
utils/chunk_it.py against the JAX package on the same inputs, on the CPU.

Tolerances are tests/test_torch_heldout.py's: heldout likelihoods within
1e-3 nats, bounds within 1e-4 relative; the synthetic corpus grid is
byte-equal.  ``select_model``'s kept and selected runs are compared with
JAX's only where the bounds that decide them differ by more than 1e-3
relative (closer runs may swap on float32 rounding).
"""

import inspect
import json
import os

import numpy as np
import pytest

from strutopy_tpu import pipeline as jax_pipeline
from strutopy_tpu.utils.chunk_it import chunk_it as jax_chunk_it
from strutopy_tpu_torch import STM, STMConfig, StreamedEM, pipeline
from strutopy_tpu_torch.corpus.bow import pad_corpus
from strutopy_tpu_torch.ops import mstep
from strutopy_tpu_torch.utils.chunk_it import chunkIt, chunk_it
from torch_world import one_thread


@pytest.fixture(autouse=True, scope="module")
def _torch_on_one_thread():
    """torch's CPU ops on one thread for every test of this file and its
    fixtures (tests/torch_world.py::one_thread): under parallel test
    workers a toy fit on torch's default pool waits on busy cores."""
    with one_thread():
        yield


ARTIFACTS = {"beta_hat.npy", "theta_hat.npy", "sigma_hat.npy", "eta_hat.npy", "mu_hat.npy",
             "gamma_hat.npy", "X.npy", "lower_bound.pickle", "fit_health.json",
             "stm_config.json", "vocab.json", "fit_config.json"}


def _X(toy_corpus, n=None):
    return toy_corpus.metadata[:n, 0].astype(np.float64)


def test_fit_model_artifacts_match_jax(toy_corpus, tmp_path):
    docs, X = toy_corpus.train_docs, _X(toy_corpus, len(toy_corpus.train_docs))
    kw = dict(K=3, X=X, max_em_iter=2, init_type="random", batch_size=16)
    m = pipeline.fit_model(docs, output_dir=str(tmp_path / "port"), device="cpu", **kw)
    jm = jax_pipeline.fit_model(docs, output_dir=str(tmp_path / "jax"), **kw)
    assert set(os.listdir(tmp_path / "port")) == set(os.listdir(tmp_path / "jax")) == ARTIFACTS
    cfg, jcfg = (json.load(open(tmp_path / d / "fit_config.json")) for d in ("port", "jax"))
    assert cfg.keys() == jcfg.keys()
    for k in ("num_topics", "length_dictionary", "number_of_docs", "init_type",
              "model_type", "mode", "max_em_iter"):
        assert cfg[k] == jcfg[k], k
    np.testing.assert_allclose(m.last_bounds, jm.last_bounds, rtol=1e-4)
    assert cfg["final_bound"] == m.last_bounds[-1]
    # a PaddedCorpus counts its real documents
    m2 = pipeline.fit_model(pad_corpus(docs), output_dir=str(tmp_path / "padded"),
                            device="cpu", **kw)
    assert json.load(open(tmp_path / "padded" / "fit_config.json"))["number_of_docs"] == len(docs)
    np.testing.assert_allclose(m2.last_bounds, m.last_bounds, rtol=1e-5)


@pytest.mark.parametrize("seeded", [False, True])
def test_create_synthetic_corpora_writes_what_jax_writes(tmp_path, seeded):
    rng = np.random.default_rng(5)
    kw = dict(K=3, gamma_factors=(1, 5), n_corpora=2, n_docs=30, n_words=40, V=120)
    if seeded:
        kw.update(beta=rng.dirichlet(np.full(100, 0.2), size=3), gamma=rng.normal(size=(2, 1)))
    out = pipeline.create_synthetic_corpora(output_dir=str(tmp_path / "port"), **kw)
    jout = jax_pipeline.create_synthetic_corpora(output_dir=str(tmp_path / "jax"), **kw)
    assert out.keys() == jout.keys() == {1, 5}
    assert [len(c.train_docs) for c in out[1]] == [len(c.train_docs) for c in jout[1]] == [24, 24]
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "port")
                   for d, _, fs in os.walk(tmp_path / "port") for f in fs)
    assert len(files) == 2 * 2 * 8
    for rel in files:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes(), rel


def test_find_k_matches_jax(toy_corpus):
    # one K here (tests/test_torch_cli.py sweeps two through the CLI)
    kw = dict(K_candidates=[3], X=_X(toy_corpus), init_type="random", max_em_iter=2,
              fast=True, batch_size=16)
    got = pipeline.find_k(toy_corpus.documents, device="cpu", **kw)
    want = jax_pipeline.find_k(toy_corpus.documents, **kw)
    assert got.keys() == want.keys() == {"STM"} and got["STM"].keys() == {3}
    assert np.isfinite(got["STM"][3]) and abs(got["STM"][3] - want["STM"][3]) < 1e-3


def test_search_k_matches_jax(toy_corpus):
    kw = dict(K_candidates=[3], init_type="random", max_em_iter=2, model_type="CTM",
              batch_size=16)
    got = pipeline.search_k(toy_corpus.documents, device="cpu", **kw)[3]
    want = jax_pipeline.search_k(toy_corpus.documents, **kw)[3]
    assert got.keys() == want.keys() == {"heldout", "bound", "coherence", "exclusivity",
                                         "dispersion", "fit_seconds"}
    assert abs(got["heldout"] - want["heldout"]) < 1e-3
    for k in ("bound", "coherence", "exclusivity", "dispersion"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, err_msg=k)
    assert got["fit_seconds"] > 0


def _decided(values, n_top):
    """True where the top ``n_top`` of ``values`` are separated from the rest
    by more than 1e-3 relative (then no rounding can change them)."""
    v = np.sort(np.asarray(values))[::-1]
    if n_top >= len(v):
        return True
    return abs(v[n_top - 1] - v[n_top]) > 1e-3 * abs(v[n_top])


SELECT = dict(K=3, runs=4, cast_iters=1, keep=2, max_em_iter=2, seed=11, batch_size=16)


@pytest.fixture(scope="module")
def selected(toy_corpus):
    X = _X(toy_corpus)
    return {
        "jax": jax_pipeline.select_model(toy_corpus.documents, X=X, return_models=False,
                                         **SELECT),
        "list": pipeline.select_model(toy_corpus.documents, X=X, device="cpu", **SELECT),
        "padded": pipeline.select_model(pad_corpus(toy_corpus.documents), X=X, device="cpu",
                                        return_models=False, **SELECT),
    }


@pytest.mark.parametrize("source", ["list", "padded"])
def test_select_model_matches_jax(selected, source):
    got, want = selected[source], selected["jax"]
    assert [r["seed"] for r in got["runs"]] == [r["seed"] for r in want["runs"]]
    cast = [r["cast_bound"] for r in want["runs"]]
    np.testing.assert_allclose([r["cast_bound"] for r in got["runs"]], cast, rtol=1e-4)
    if _decided(cast, SELECT["keep"]):
        assert got["kept"] == want["kept"]
    for i, (a, b) in enumerate(zip(got["runs"], want["runs"])):
        assert a["kept"] == (i in got["kept"])
        if "bound" in a and "bound" in b:
            np.testing.assert_allclose(a["bound"], b["bound"], rtol=1e-4)
            assert len(a["semcoh_topics"]) == len(a["exclusivity_topics"]) == 3
    finals = [got["runs"][i]["bound"] for i in got["kept"]]
    if got["kept"] == want["kept"] and _decided(finals, 1):
        assert got["selected"] == want["selected"]
    assert got["selected"] in got["kept"]


def test_select_model_continues_each_run_as_one_fit(selected, toy_corpus):
    """Stage 2 continues a parked stage-1 state: the selected run's final
    bound is that of one uninterrupted fit from its seed; the returned
    models are independent snapshots."""
    res = selected["list"]
    sel = res["selected"]
    direct = STM(toy_corpus.documents, K=3, X=_X(toy_corpus), init_type="random",
                 max_em_iter=2, seed=res["runs"][sel]["seed"], batch_size=16, device="cpu")
    direct.expectation_maximization()
    assert direct.last_bounds[-1] == res["runs"][sel]["bound"]
    m0, m1 = res["models"]
    assert not np.allclose(m0.beta, m1.beta)
    assert m0.last_bounds[-1] == res["runs"][res["kept"][0]]["bound"]
    assert len(m0.last_bounds) == 2
    assert selected["padded"]["models"] == []

    import matplotlib

    matplotlib.use("Agg")
    from strutopy_tpu_torch.eval.plots import plot_select_model

    assert plot_select_model(res) is not None


def test_select_model_guards(toy_corpus):
    for bad in (dict(runs=0), dict(cast_iters=0), dict(cast_iters=2, max_em_iter=2)):
        kw = dict(SELECT, **bad)
        with pytest.raises(ValueError):
            pipeline.select_model(toy_corpus.documents, device="cpu", **kw)


def test_many_topics_selects_per_K_best(toy_corpus):
    out = pipeline.many_topics(toy_corpus.documents, K_candidates=[3, 4], runs=2,
                               cast_iters=1, keep=1, max_em_iter=2, seed=3, batch_size=16,
                               device="cpu")
    assert set(out) == {3, 4}
    for K, row in out.items():
        assert row["model"].beta.shape[0] == K and row["selected_run"] in (0, 1)
        assert np.isfinite(row["bound"]) and row["coherence"] < 0
        assert row["bound"] == row["model"].last_bounds[-1]


def test_chunk_it_matches_jax():
    for seq, num in ((list(range(10)), 3), (list(range(7)), 7), ("abcdefgh", 3), ([], 2),
                     (list(range(5)), 8)):
        assert chunk_it(seq, num) == chunkIt(seq, num) == jax_chunk_it(seq, num)
    with pytest.raises(ValueError):
        chunk_it([1, 2], 0)


def _numbers(out):
    """The numbers of a pipeline function's result, models read through
    their bounds and beta."""
    if isinstance(out, STM):
        return [list(out.last_bounds), out.beta]
    if isinstance(out, dict):
        return [_numbers(out[k]) for k in sorted(out, key=str)]
    if isinstance(out, (list, tuple)):
        return [_numbers(x) for x in out]
    return out


@pytest.mark.parametrize("name", ["fit_model", "train_and_eval_heldout", "find_k",
                                  "search_k", "select_model", "many_topics"])
def test_mesh_is_refused(name, toy_corpus, tmp_path):
    """Every pipeline function takes ``mesh`` (no longer refused): on a
    gloo world of one, mesh=make_mesh(1) gives exactly the unmeshed
    result, artifacts included."""
    from strutopy_tpu_torch.parallel.mesh import make_mesh
    from torch_world import one_thread, world_of_one

    fn = getattr(pipeline, name)
    docs = toy_corpus.documents
    fast = dict(max_em_iter=2, init_type="random")
    args, kw = {
        "fit_model": ((docs, 3), fast),
        "train_and_eval_heldout": ((docs[:40], docs[40:], 3), fast),
        "find_k": ((docs, [3]), dict(fast, fast=True)),
        "search_k": ((docs, [3]), fast),
        "select_model": ((docs, 3), dict(runs=2, cast_iters=1, max_em_iter=2)),
        "many_topics": ((docs, [3]), dict(runs=2, cast_iters=1, max_em_iter=2)),
    }[name]
    assert "mesh" in inspect.signature(getattr(jax_pipeline, name)).parameters

    def run(mesh, out):
        extra = {"output_dir": str(tmp_path / out)} if name == "fit_model" else {}
        res = fn(*args, mesh=mesh, device="cpu", **kw, **extra)
        if name == "search_k":
            for row in res.values():
                row.pop("fit_seconds")
        return _numbers(res)

    with one_thread():
        want = run(None, "one")
        with world_of_one(tmp_path):
            got = run(make_mesh(1), "mesh")
    np.testing.assert_equal(got, want)
    if name == "fit_model":
        for f in ("beta_hat.npy", "theta_hat.npy"):
            np.testing.assert_array_equal(np.load(tmp_path / "mesh" / f),
                                          np.load(tmp_path / "one" / f))


def test_prevalence_design_defaults_to_the_card_and_streamed_em_checks_it(toy_corpus):
    assert inspect.signature(mstep.make_prevalence_design).parameters["device"].default == "cuda"
    X, ok = _X(toy_corpus), np.ones(len(toy_corpus.documents), bool)
    _D, on_cpu = mstep.make_prevalence_design(X, ok, device="cpu")
    _D, on_meta = mstep.make_prevalence_design(X, ok, device="meta")
    cfg = STMConfig(K=3)
    with pytest.raises(ValueError, match="design is on cpu but StreamedEM runs on cuda"):
        StreamedEM(cfg, on_cpu, [], n_parts=1, device="cuda")
    with pytest.raises(ValueError, match="design is on meta but StreamedEM runs on cpu"):
        StreamedEM(cfg, on_meta, [], n_parts=1, device="cpu")
    assert StreamedEM(cfg, on_cpu, [], device="cpu").n_parts == 0
