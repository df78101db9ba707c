"""The port's corpus readers and ingest (strutopy_tpu_torch/corpus/io.py,
acquire.py, native.py) against the JAX package: files written by one
package are byte-equal to the other's and read back the same by both, the
native library gives what the Python path and the JAX binding give, and
building the port's library writes nothing under ``native/``."""

import csv
import json
import os
import pickle
import shutil
import subprocess
import sys
import types
import urllib.parse
from pathlib import Path

import numpy as np
import pytest

from strutopy_tpu.corpus import acquire as jax_acquire
from strutopy_tpu.corpus import io as jax_io
from strutopy_tpu.corpus import native as jax_native
from strutopy_tpu_torch.corpus import acquire, io, native
from strutopy_tpu.corpus.bow import PaddedCorpus as JaxPaddedCorpus
from strutopy_tpu_torch.corpus.bow import PaddedCorpus, pad_corpus, to_bow

ROOT = Path(__file__).resolve().parents[1]


def _docs(seed=0, n=30, V=60):
    rng = np.random.default_rng(seed)
    docs = []
    for d in range(n):
        ids = np.sort(rng.choice(V - 5, int(rng.integers(0, 12)), replace=False))
        docs.append([(int(w), int(c)) for w, c in zip(ids, rng.integers(1, 6, len(ids)))])
    return docs


def _for_jax(corpus):
    """The same corpus as the JAX package's type (its writers test for it)."""
    if isinstance(corpus, PaddedCorpus):
        return JaxPaddedCorpus(corpus.words, corpus.counts, corpus.doc_ok, corpus.V)
    return corpus


CORPORA = {
    "bow": lambda: (_docs(), None),
    "bow_declared_V": lambda: (_docs(1), 64),
    "padded": lambda: (pad_corpus(_docs(2), V=70), None),
}


@pytest.mark.parametrize("kind", sorted(CORPORA))
def test_matrix_market_written_by_either_package(kind, tmp_path):
    corpus, n_terms = CORPORA[kind]()
    mine, theirs = tmp_path / "port.mm", tmp_path / "jax.mm"
    io.write_mm(str(mine), corpus, n_terms=n_terms)
    jax_io.write_mm(str(theirs), _for_jax(corpus), n_terms=n_terms)
    assert mine.read_bytes() == theirs.read_bytes()
    bow = to_bow(corpus) if kind == "padded" else corpus
    for path in (mine, theirs):
        got = io.read_mm(str(path), return_V=True)
        assert got == jax_io.read_mm(str(path), return_V=True)
        assert got[0] == bow
        assert io.read_mm(str(path)) == bow


def test_matrix_market_refuses_corrupt_files(tmp_path):
    bad = {
        "range": "%%MatrixMarket matrix coordinate real general\n3 5 2\n1 2 1\n9 1 4\n",
        "truncated": "%%MatrixMarket matrix coordinate real general\n2 5 3\n1 2 1\n2 1 4\n",
        "banner": "not a matrix\n1 1 1\n1 1 1\n",
    }
    for name, text in bad.items():
        p = tmp_path / f"{name}.mm"
        p.write_text(text)
        for read in (io.read_mm, jax_io.read_mm):
            with pytest.raises(ValueError):
                read(str(p))
    with pytest.raises(ValueError, match="outside the declared"):
        native.read_mm_padded(str(tmp_path / "range.mm"))
    with pytest.raises(ValueError, match="n_terms"):
        io.write_mm(str(tmp_path / "x.mm"), _docs(), n_terms=3)


@pytest.mark.parametrize("kind", sorted(CORPORA))
def test_ldac_written_by_either_package(kind, tmp_path):
    corpus, _ = CORPORA[kind]()
    vocab = [f"tok{i}" for i in range(70)]
    mine, theirs = tmp_path / "port.ldac", tmp_path / "jax.ldac"
    io.write_ldac(str(mine), corpus, vocab=vocab)
    jax_io.write_ldac(str(theirs), _for_jax(corpus), vocab=vocab)
    assert mine.read_bytes() == theirs.read_bytes()
    assert Path(f"{mine}.vocab").read_bytes() == Path(f"{theirs}.vocab").read_bytes()
    bow = to_bow(corpus) if kind == "padded" else corpus
    for path in (mine, theirs):
        assert io.read_ldac(str(path)) == jax_io.read_ldac(str(path)) == bow
        assert io.read_ldac(str(path), vocab_path=f"{path}.vocab") == (bow, vocab)


def test_ldac_refuses_malformed_lines(tmp_path):
    for text in ("2 1:3\n", "1 1:x\n", "1 -1:2\n"):
        p = tmp_path / "bad.ldac"
        p.write_text(text)
        with pytest.raises(ValueError):
            io.read_ldac(str(p))
    with pytest.raises(ValueError, match="integer counts"):
        io.write_ldac(str(tmp_path / "f.ldac"), [[(0, 1.5)]])


def _gensim_pickle(path, token2id):
    """A ``Dictionary.save`` file, made with stand-in gensim modules (the
    pickle names gensim's classes; gensim itself is not needed)."""
    names = ("gensim", "gensim.corpora", "gensim.corpora.dictionary", "gensim.utils")
    saved = {n: sys.modules.get(n) for n in names}
    mods = {n: types.ModuleType(n) for n in names}

    class Dictionary:
        pass

    Dictionary.__module__ = "gensim.corpora.dictionary"
    Dictionary.__qualname__ = "Dictionary"
    mods["gensim.corpora.dictionary"].Dictionary = Dictionary
    try:
        sys.modules.update(mods)
        d = Dictionary()
        d.token2id = dict(token2id)
        d.id2token = {}
        with open(path, "wb") as f:
            pickle.dump(d, f, protocol=2)
    finally:
        for n, m in saved.items():
            if m is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = m


def test_read_gensim_dictionary_matches_jax(tmp_path):
    p = tmp_path / "dictionary.mm"
    _gensim_pickle(p, {"beta": 1, "alpha": 0, "delta": 3})  # id 2 missing
    vocab = io.read_gensim_dictionary(str(p))
    assert list(vocab) == ["alpha", "beta", "__missing_2", "delta"]
    assert list(vocab) == list(jax_io.read_gensim_dictionary(str(p)))
    evil = tmp_path / "evil.mm"
    evil.write_bytes(pickle.dumps(os.getcwd))
    for read in (io.read_gensim_dictionary, jax_io.read_gensim_dictionary):
        with pytest.raises(pickle.UnpicklingError, match="refusing"):
            read(str(evil))


def _fetch(url):
    """A stub of the MediaWiki API: two seed pages whose links overlap."""
    pages = {"Statistics": ["Mean", "List of statistics articles", "Bayes"],
             "Machine learning": ["Bayes", "Perceptron", "Missing page"]}
    summaries = {"Mean": (11, "Mean", "The mean is an average."),
                 "Bayes": (12, "Bayes", "Bayes was a statistician, \"quoted\"."),
                 "Perceptron": (13, "Perceptron", "A perceptron is a model.\nTwo lines.")}
    q = dict(urllib.parse.parse_qsl(urllib.parse.urlsplit(url).query))
    title = q["titles"]
    if q.get("prop") == "links":
        return json.dumps({"query": {"pages": [
            {"links": [{"title": t} for t in pages[title]]}]}}).encode()
    if title in summaries:
        pid, t, text = summaries[title]
        return json.dumps({"query": {"pages": [
            {"pageid": pid, "title": t, "extract": text}]}}).encode()
    return json.dumps({"query": {"pages": [{"missing": True}]}}).encode()


def test_acquire_matches_jax(tmp_path):
    rows = acquire.get_wiki_docs(output_dir=str(tmp_path / "port"), fetch=_fetch)
    jrows = jax_acquire.get_wiki_docs(output_dir=str(tmp_path / "jax"), fetch=_fetch)
    assert rows == jrows
    assert {r["title"] for r in rows} == {"Mean", "Bayes", "Perceptron"}
    csv_path = tmp_path / "port" / "wiki_corpus.csv"
    assert csv_path.read_bytes() == (tmp_path / "jax" / "wiki_corpus.csv").read_bytes()
    with open(csv_path, newline="") as f:
        assert next(csv.reader(f)) == ["", "pageid", "text", "title", "statistics", "machine"]

    labels = ("statistics", "machine")
    got = acquire.load_texts_csv(str(csv_path), label_columns=labels)
    assert got == jax_acquire.load_texts_csv(str(csv_path), label_columns=labels)
    bow, vocab, lab = acquire.corpus_from_csv(str(csv_path), label_columns=labels,
                                              min_doc_freq=1, max_doc_frac=1.0)
    jbow, jvocab, jlab = jax_acquire.corpus_from_csv(str(csv_path), label_columns=labels,
                                                     min_doc_freq=1, max_doc_frac=1.0)
    assert (bow, list(vocab), lab) == (jbow, list(jvocab), jlab)

    recs = [{"text": "alpha beta", "y": 1}, {"text": "gamma", "y": 0}]
    (tmp_path / "a.json").write_text("\n  " + json.dumps(recs))
    (tmp_path / "b.jsonl").write_text("\n".join(json.dumps(r) for r in recs) + "\n\n")
    for name in ("a.json", "b.jsonl"):
        path = str(tmp_path / name)
        got = acquire.load_texts_json(path, label_fields=("y",))
        assert got == jax_acquire.load_texts_json(path, label_fields=("y",))
        assert got == (["alpha beta", "gamma"], [{"y": 1}, {"y": 0}])


def test_native_readers_match_jax_and_python(tmp_path):
    assert native.available() and jax_native.available()
    docs = _docs(3, n=40, V=300) + [[(w, 1) for w in range(200)]]  # L beyond one lane
    p = tmp_path / "c.mm"
    io.write_mm(str(p), docs, n_terms=310)
    got, want = native.read_mm_padded(str(p)), jax_native.read_mm_padded(str(p))
    bow, V = io.read_mm(str(p), return_V=True)
    ref = pad_corpus(bow, V=V)
    for a in (want, ref):
        assert got.V == a.V == 310 and got.L == a.L == 256
        assert np.array_equal(got.doc_ok, a.doc_ok)
    assert np.array_equal(got.words, want.words) and np.array_equal(got.counts, want.counts)
    assert to_bow(got) == to_bow(ref) == docs

    rng = np.random.default_rng(4)
    cells = rng.choice(9 * 50, 300, replace=False)  # distinct (doc, word) pairs
    doc_idx = (cells // 50).astype(np.int64)
    word_idx = (cells % 50).astype(np.int32)
    count = rng.integers(1, 4, 300).astype(np.float32)
    got = native.pack_coo_padded(doc_idx, word_idx, count, n_docs=10, V=50)
    want = jax_native.pack_coo_padded(doc_idx, word_idx, count, n_docs=10, V=50)
    for f in ("words", "counts", "doc_ok"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    # the Python path: the same documents, entry order aside
    bows = [[] for _ in range(10)]
    for d, w, c in zip(doc_idx, word_idx, count):
        bows[d].append((int(w), int(c)))
    assert [sorted(d) for d in to_bow(got)] == [sorted(b) for b in bows]
    with pytest.raises(ValueError, match="outside"):
        native.pack_coo_padded(doc_idx, word_idx, count, n_docs=10, V=20)

    texts = ["Alpha beta, beta! 12 gamma", "", "the and", "naïve café CAFÉ"]
    assert native.build_bow(texts, None) == jax_native.build_bow(texts, None)
    assert native.build_bow(texts, {"bad\nstop"}) is None


def test_building_the_native_library_writes_nothing_under_native(tmp_path):
    """A copy of the port and of ``native/``'s sources: importing the port's
    binding and building the library puts it under ``build/native/`` and
    leaves ``native/`` as it was."""
    shutil.copytree(ROOT / "strutopy_tpu_torch", tmp_path / "strutopy_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "native").mkdir()
    for name in ("ingest.cpp", "bow.cpp", "Makefile"):
        shutil.copy2(ROOT / "native" / name, tmp_path / "native" / name)

    def listing():
        return sorted((p.name, p.stat().st_size, p.stat().st_mtime_ns)
                      for p in (tmp_path / "native").iterdir())

    before = listing()
    code = ("from strutopy_tpu_torch.corpus import native; import sys; "
            "print(native.available(), native.LIB_PATH); "
            "sys.exit(0 if native.build_bow(['ab cd'], None) else 1)")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", str(tmp_path / "build" / "native" / "libstm_ingest.so")]
    assert listing() == before
    assert sorted(p.name for p in (tmp_path / "build" / "native").iterdir()) == [
        ".build.lock", "libstm_ingest.so"]
