"""The generators are functions of the seed, and the frozen DGP is
bench_torch.make_corpus bit for bit."""

import numpy as np

from perfbench import corpus, spec


def test_frozen_dgp_matches_bench_torch():
    import bench_torch

    for seed in (0, 5):
        want = bench_torch.make_corpus(K=7, V=200, N=40, n_words=50, seed=seed,
                                       return_beta=True)
        got = corpus.bench_corpus(7, 200, 40, 50, seed)
        assert got[0] == want[0]
        assert np.array_equal(got[1], want[1]) and np.array_equal(got[2], want[2])


def test_generators_are_functions_of_the_seed():
    cfg = spec.load_cell("k100_fit").config
    for seed in (3, 2**31 + 7, -11):
        a, b = corpus.fit_corpus(cfg, seed, toy=True), corpus.fit_corpus(cfg, seed, toy=True)
        assert a[0] == b[0] and np.array_equal(a[1], b[1])
        assert np.array_equal(corpus.random_beta(6, 30, seed), corpus.random_beta(6, 30, seed))
    assert corpus.fit_corpus(cfg, 3, True)[0] != corpus.fit_corpus(cfg, 4, True)[0]


def test_every_seed_gets_the_same_sizes():
    cfg = spec.load_cell("k100_fit").config
    sizes = corpus.sizes(cfg, toy=True)
    for seed in (1, 2, 2**40 + 3):
        docs, X = corpus.fit_corpus(cfg, seed, toy=True)
        assert len(docs) == sizes["N"] and X.shape == (sizes["N"],)
        assert all(sum(c for _w, c in d) == sizes["doc_tokens"] for d in docs)
