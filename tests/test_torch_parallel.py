"""The port's multi-device fits (strutopy_tpu_torch/parallel/) on the CPU.

One gloo world of four processes (tests/torch_parallel_worker.py, which
imports torch, numpy and the port only) runs the multichip gates of the
JAX package's ``__graft_entry__.py`` at toy size on a 1-D mesh of 4 and
a 2-D mesh of 2 x 2, each rank saving what it got; the tests here hold
those results against the port's one-device fits, and gates A, B, E2 and
G against the JAX package's fits on the same mesh shapes (its 8 virtual
CPU devices, tests/conftest.py).  The world meets through a file store
in a temporary directory and is ended after ``WORLD_TIMEOUT`` seconds
or at the first rank that fails.

Tolerances against the one-device fit are those of the JAX package's own
mesh tests (tests/test_sharding.py): bound rtol 2e-4, beta atol 2e-4,
sigma rtol 2e-3 / atol 2e-4, theta atol 2e-3; served theta within 1e-5;
resumed fits bit for bit.  Against JAX they are the single-device parity
tests' (tests/test_torch_em.py, _content.py, _serving.py): bounds rtol
1e-5 (1e-4 for the content model), beta atol 1e-4, theta atol 1e-3,
served eta atol 5e-3.
"""

import os
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist

from strutopy_tpu.models.config import STMConfig as JaxConfig
from strutopy_tpu.models.serving import infer_theta as jax_infer_theta
from strutopy_tpu.models.stm import STM as JaxSTM
from strutopy_tpu.parallel.mesh import make_mesh as jax_make_mesh
from strutopy_tpu.parallel.mesh import make_mesh_2d as jax_make_mesh_2d
from strutopy_tpu_torch import STM, STMConfig
from strutopy_tpu_torch.corpus.bow import pad_corpus
from strutopy_tpu_torch.models.serving import infer_theta
from strutopy_tpu_torch.ops.spectral import spectral_init
from strutopy_tpu_torch.parallel import default_mesh, make_mesh
from strutopy_tpu_torch.parallel.mesh import make_mesh_2d
from torch_world import join_world, one_thread, start_world, world_of_one

WORLD = 4
WORLD_TIMEOUT = 120
CPU = dict(device="cpu")


def _padded_dictionary(toy_dictionary):
    """V padded to a multiple of 8 so that every vocab axis divides it."""
    words = [str(w) for w in toy_dictionary]
    while len(words) % 8:
        words.append(f"__pad_{len(words)}")
    return words


def _two_bucket_corpus(n=32, V=320):
    """__graft_entry__'s gate-C corpus at toy size: short documents in
    the L=128 bucket, documents of 140 distinct words in the L=256 one."""
    rng = np.random.default_rng(1)
    docs = []
    for _ in range(n):
        ids = rng.choice(120, 10, replace=False)
        docs.append([(int(i), int(rng.integers(1, 4))) for i in sorted(ids)])
    for _ in range(n):
        ids = rng.choice(V, 140, replace=False)
        docs.append([(int(i), int(rng.integers(1, 3))) for i in sorted(ids)])
    return docs, [f"w{i}" for i in range(V)], rng.integers(0, 2, len(docs)).astype(np.float64)


def _fit(**kw):
    m = STM(**kw, **CPU)
    m.expectation_maximization()
    return m


def _jax_fits(inputs):
    """The JAX package's fits and request on the mesh shapes of gates A,
    B, G and E2 (its virtual CPU devices)."""
    out = {}
    for gate, key, mesh in (("A", "toy_kw", jax_make_mesh(4)), ("B", "toy_kw", jax_make_mesh_2d(2, 2)),
                            ("G", "content_kw", jax_make_mesh_2d(2, 2))):
        jm = JaxSTM(**inputs[key], mesh=mesh)
        jm.expectation_maximization(saving=False)
        out[gate] = dict(bounds=np.asarray(jm.last_bounds), beta=np.asarray(jm.beta),
                         theta=np.asarray(jm.theta))
    s = inputs["serve"]
    theta, eta = jax_infer_theta(s["beta"], s["sigma"], s["mu"], inputs["docs2"],
                                 JaxConfig(**inputs["cfg_c"]), mesh=jax_make_mesh_2d(2, 2))
    out["E2"] = dict(theta=np.asarray(theta), eta=np.asarray(eta))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory, toy_corpus, toy_dictionary, toy_metadata):
    """The world's per-rank results, its inputs, and the one-device and
    JAX references (computed here while the world runs, on one torch
    thread as each rank runs)."""
    with one_thread():
        return _run_world(tmp_path_factory, toy_corpus, toy_dictionary, toy_metadata)


def _run_world(tmp_path_factory, toy_corpus, toy_dictionary, toy_metadata):
    d = tmp_path_factory.mktemp("world")
    train = [[(int(w), int(c)) for w, c in doc] for doc in toy_corpus.train_docs]
    n = len(train)
    words = _padded_dictionary(toy_dictionary)
    toy_kw = dict(documents=train, dictionary=words, K=3, X=np.asarray(toy_metadata[:n]),
                  max_em_iter=3, init_type="random", model_type="STM", seed=123456)
    docs2, words2, X2 = _two_bucket_corpus()
    cfg_c = dict(K=5, model_type="STM", init_type="random", max_em_iter=3,
                 newton_pass1_iters=4, newton_straggler_frac=1.0, newton_warmup_iters=0,
                 batch_size=16)
    bi = np.random.default_rng(0).integers(0, 2, n)
    content_kw = dict(documents=train, dictionary=words, K=3, X=bi.astype(np.float64),
                      content=True, A=2, beta_index=bi, lda_beta=False,
                      kappa_interactions=True, max_em_iter=2, init_type="random",
                      model_type="CTM", seed=123456)
    ref = {"C": _fit(documents=docs2, dictionary=words2, X=X2, config=STMConfig(**cfg_c))}
    serve = dict(beta=ref["C"].beta, sigma=ref["C"].sigma,
                 mu=(np.c_[np.ones(len(docs2)), X2] @ ref["C"].gamma.T).astype(np.float32))
    toy_path = str(d / "toy.pickle")
    with open(toy_path, "wb") as f:
        pickle.dump(train, f)
    inputs = dict(toy_kw=toy_kw, docs2=docs2, words2=words2, X2=X2, cfg_c=cfg_c,
                  content_kw=content_kw, serve=serve, padded2=pad_corpus(docs2, V=320),
                  toy_path=toy_path)
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    procs = start_world(d, WORLD)
    try:
        from strutopy_tpu_torch import cli, pipeline

        # the one-device and JAX references run while the world does
        ref["A"] = ref["B"] = _fit(**toy_kw)
        ref["D"] = ref["F"] = _fit(**dict(toy_kw, max_em_iter=2))
        ref["G"] = _fit(**content_kw)
        ref["spectral"] = STM(**dict(toy_kw, init_type="spectral"), **CPU)
        ref["serve"] = infer_theta(serve["beta"], serve["sigma"], serve["mu"], docs2,
                                   STMConfig(**cfg_c), **CPU)
        ref["select"] = pipeline.select_model(train, K=3, runs=2, cast_iters=1, max_em_iter=3,
                                              X=toy_kw["X"], return_models=False, **CPU)
        cli.main(["--device", "cpu", "fit", "--corpus", toy_path, "--K", "3", "--init",
                  "random", "--max-em-iter", "2", "--out", str(d / "cli_one")])
        ref["jax"] = _jax_fits(inputs)
    finally:
        ranks = join_world(procs, d, WORLD_TIMEOUT)
    return dict(ranks=ranks, inputs=inputs, ref=ref, dir=d)


def _assert_fit_close(got, m):
    np.testing.assert_allclose(got["bounds"], m.last_bounds, rtol=2e-4)
    np.testing.assert_allclose(got["beta"], m.beta, atol=2e-4)
    np.testing.assert_allclose(got["sigma"], m.sigma, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(got["theta"], m.theta, atol=2e-3)


def _assert_same_on_every_rank(ranks, gate):
    for r in ranks[1:]:
        for k, v in ranks[0][gate].items():
            np.testing.assert_array_equal(r[gate][k], v, err_msg=f"{gate}.{k}")


@pytest.mark.parametrize("gate", ["A", "B", "C", "D", "F", "G"])
def test_gate_matches_one_device(world, gate):
    """A: 1-D mesh of 4; B: 2-D mesh of 2 x 2; C: two length buckets and
    the two-pass schedule on the 1-D mesh; D: stream_parts=2 on the 1-D
    mesh; F: stream_parts=2 on the 2-D mesh; G: the content model with
    interactions on the 2-D mesh.  Every rank holds the same fit."""
    ranks = world["ranks"]
    _assert_fit_close(ranks[0][gate], world["ref"][gate])
    _assert_same_on_every_rank(ranks, gate)


def test_shards_are_what_the_mesh_says(world):
    ranks = world["ranks"]
    n_docs = len(world["inputs"]["toy_kw"]["documents"])
    assert [4 * r["A"]["local_rows"] for r in ranks] == [ranks[0]["A"]["n_storage"]] * 4
    assert ranks[0]["A"]["n_storage"] >= n_docs
    assert ranks[0]["B"]["local_cols"] == len(world["inputs"]["toy_kw"]["dictionary"]) // 2
    assert ranks[0]["C"]["n_buckets"] == 2
    assert not ranks[0]["D"]["resident"]
    np.testing.assert_allclose(ranks[0]["G"]["beta"].sum(-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("gate", ["E", "E2"])
def test_serving_matches_one_device(world, gate):
    """E: infer_theta on the 1-D mesh; E2: on the 2-D mesh (beta's
    vocabulary sharded): the request's documents in request order on
    every rank, within 1e-5 of one device."""
    theta1, eta1 = world["ref"]["serve"]
    for r in world["ranks"]:
        assert r[gate]["theta"].shape == theta1.shape
        np.testing.assert_allclose(r[gate]["theta"], theta1, atol=1e-5)
        np.testing.assert_allclose(r[gate]["eta"], eta1, atol=1e-4)


@pytest.mark.parametrize("gate", ["H", "H2"])
def test_resume_is_bit_identical(world, gate):
    """H: a fit on the 1-D mesh checkpointed at iteration 2 and resumed
    (every rank reads the checkpoint rank 0 wrote) replays the
    uninterrupted fit bit for bit; H2 the same with stream_parts=2."""
    x = world["ranks"][0][gate]
    np.testing.assert_array_equal(x["resumed_bounds"], x["full_bounds"])
    np.testing.assert_array_equal(x["resumed_beta"], x["full_beta"])
    np.testing.assert_array_equal(x["resumed_theta"], x["full_theta"])
    assert len(x["full_bounds"]) == 4


def test_every_rank_starts_from_the_same_bits(world):
    """Spectral init (sharded Gram on the 1-D mesh, unsharded on each rank
    of the 2-D one, then the first rank's bits by the exact sum) and
    random init: every rank's whole initial state hashes the same."""
    bits = [{k: v for k, v in r["init_bits"].items() if k != "spectral_beta"}
            for r in world["ranks"]]
    assert all(b == bits[0] for b in bits)


def test_sharded_spectral_init_matches_one_device(world):
    got = world["ranks"][0]["init_bits"]["spectral_beta"]
    np.testing.assert_allclose(got, world["ref"]["spectral"].beta, rtol=1e-4, atol=1e-7)


def test_gram_scan_sharded_equals_gram_scan(world):
    g = world["ranks"][0]["gram"]
    np.testing.assert_allclose(g["Q_sharded"], g["Q"], rtol=1e-5, atol=1e-6 * np.abs(g["Q"]).max())


def test_vocab_sharded_beta_updates_equal_unsharded(world):
    """update_beta_lda(row_psum=) and update_beta_content(vocab_psum=,
    vocab_pmax=, wcounts_total=) on blocks of the vocabulary, gathered,
    against the unsharded updates (the offsets' row totals are summed in
    another order, so the content model agrees to float32 rounding
    carried through its Newton solves)."""
    v = world["ranks"][0]["mstep_vocab"]
    np.testing.assert_allclose(v["lda_v"], v["lda"], rtol=1e-6)
    np.testing.assert_allclose(v["beta_v"], v["beta"], rtol=1e-4, atol=1e-8)
    np.testing.assert_allclose(v["kappa_v"], v["kappa"], atol=1e-5)


def test_select_model_on_the_2d_mesh(world):
    """select_model shards the parked stage-1 states again for stage 2."""
    res = world["ref"]["select"]
    got = world["ranks"][0]["select"]
    assert got["kept"] == res["kept"]
    np.testing.assert_allclose(got["bounds"], [r["bound"] for r in res["runs"] if r["kept"]],
                               rtol=2e-4)


def test_cli_n_devices_under_a_world(world):
    """``--n-devices 4`` in a world of 4: rank 0 writes the artifact set
    once, the fit equals the one-device CLI fit, and the CLI leaves the
    caller's process group alone."""
    want = world["dir"] / "cli_one"
    got = world["dir"] / "cli_fit"
    assert sorted(os.listdir(got)) == sorted(os.listdir(want))
    np.testing.assert_allclose(np.load(got / "beta_hat.npy"), np.load(want / "beta_hat.npy"),
                               atol=2e-4)
    assert all(r["cli_fit"]["group_alive"] for r in world["ranks"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sharded_spectral_init_casts_to_dtype(toy_corpus, toy_dictionary, tmp_path, dtype):
    """spectral_init(mesh=) scans the counts in ``dtype`` as the unsharded
    scan does: on a world of one both give the same bits."""
    docs = [[(int(w), int(c)) for w, c in doc] for doc in toy_corpus.train_docs]
    V = len(toy_dictionary)
    with one_thread():
        want = spectral_init(docs, 3, V, dtype=dtype, device="cpu")
        with world_of_one(tmp_path):
            got = spectral_init(docs, 3, V, dtype=dtype, mesh=make_mesh(1), device="cpu")
    np.testing.assert_array_equal(got, want)


def test_mesh_needs_the_whole_world(world, tmp_path):
    """More ranks than the world raises "needs N devices", as JAX does;
    fewer raises too (a rank outside the mesh has no part in a fit); no
    process group: no default mesh."""
    err = world["ranks"][0]["mesh_errors"]
    assert "needs 8 devices" in err["make_mesh_8"] and "world has 4" in err["make_mesh_8"]
    assert "needs 8 devices" in err["make_mesh_2d_4x2"]
    assert "whole world" in err["make_mesh_2"]
    assert default_mesh() is None
    with pytest.raises(ValueError, match="needs 2 devices"):
        make_mesh(2)
    with world_of_one(tmp_path):
        assert default_mesh() is None
        with pytest.raises(ValueError, match="needs 4 devices"):
            make_mesh_2d(2, 2)
        assert make_mesh(1).size() == 1
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# against the JAX package's fits on the same mesh shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gate,rtol", [("A", 1e-5), ("B", 1e-5), ("G", 1e-4)])
def test_gate_matches_jax_on_the_same_mesh(world, gate, rtol):
    """A on a mesh of 4, B and G on 2 x 2, in both packages."""
    jm = world["ref"]["jax"][gate]
    got = world["ranks"][0][gate]
    np.testing.assert_allclose(got["bounds"], jm["bounds"], rtol=rtol)
    np.testing.assert_allclose(got["beta"], jm["beta"], atol=1e-4)
    np.testing.assert_allclose(got["theta"], jm["theta"], atol=1e-3)


def test_serving_2d_matches_jax_on_the_same_mesh(world):
    """E2: the same request served on a 2 x 2 mesh by both packages."""
    want = world["ref"]["jax"]["E2"]
    got = world["ranks"][0]["E2"]
    np.testing.assert_allclose(got["theta"], want["theta"], atol=1e-3)
    np.testing.assert_allclose(got["eta"], want["eta"], atol=5e-3)
