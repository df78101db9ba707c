"""Corpus and artifact I/O (a numpy copy of ``strutopy_tpu/corpus/io.py``).

  * Matrix Market BoW corpora (``.mm``, gensim's MmCorpus convention)
    and LDA-C corpora, read and written without gensim;
  * gensim ``Dictionary.save`` files, read through a restricted
    unpickler with a stub class (no gensim needed);
  * the ``*_hat.npy`` model artifact set that either package's
    ``STM.save_model`` writes (and the reference's committed artifacts).

Every file is treated as pure data: ``allow_pickle=False`` for the
arrays and restricted unpicklers for the bound trace and the
dictionary, so opening a foreign file can never execute code embedded
in it.
"""

from __future__ import annotations

import importlib
import os
import pickle

import numpy as np

from strutopy_tpu_torch.corpus.bow import PaddedCorpus, Vocabulary, to_bow


def read_mm(path: str, return_V: bool = False):
    """Read a Matrix Market coordinate file as a BoW corpus.

    Returns the reference's list-of-(idx, count) document format
    (``return_V=True`` additionally returns the header's declared term
    count, so callers can honor a dictionary whose highest ids never
    occur in any document instead of inferring V = max id + 1).
    1-based indices per the MM convention (gensim writes docs as rows).
    """
    docs: dict = {}
    n_docs = 0
    n_entries = 0
    with open(path) as f:
        header = f.readline()
        if not header.startswith("%%MatrixMarket"):
            raise ValueError(f"{path} is not a MatrixMarket file")
        line = f.readline()
        n_comments = 0
        while line.startswith("%"):
            line = f.readline()
            n_comments += 1
        n_docs, n_terms, nnz = (int(x) for x in line.split())
        if n_docs < 0 or n_terms < 0 or nnz < 0:
            raise ValueError(
                f"{path}: negative size header {n_docs} x {n_terms}, "
                f"nnz {nnz}"
            )
        # data starts after the banner (1), any comment lines, and the
        # size line — keep reported line numbers physical
        for lineno, line in enumerate(f, start=3 + n_comments):
            if not line.strip():
                continue
            i, j, v = line.split()
            d = int(i) - 1
            t = int(j) - 1
            # a truncated/corrupt file must error, not silently yield a
            # smaller corpus or out-of-vocabulary word ids
            if not (0 <= d < n_docs) or not (0 <= t < n_terms):
                raise ValueError(
                    f"{path}:{lineno}: entry ({i}, {j}) outside the "
                    f"declared {n_docs} x {n_terms} matrix"
                )
            val = float(v)
            n_entries += 1
            # keep integral counts as ints (BoW convention) but do not
            # truncate genuine fractional weights
            docs.setdefault(d, []).append(
                (t, int(val) if val.is_integer() else val)
            )
    if n_entries != nnz:
        # whole trailing lines lost (truncation at a line boundary)
        # pass every per-entry check — the declared count is the only
        # witness
        raise ValueError(
            f"{path}: header declares {nnz} entries but the file "
            f"contains {n_entries} (truncated or corrupt)"
        )
    bow = [sorted(docs.get(d, [])) for d in range(n_docs)]
    return (bow, n_terms) if return_V else bow


def write_mm(path: str, corpus, n_terms: int | None = None) -> None:
    """Write a BoW corpus (or PaddedCorpus) as Matrix Market.

    ``n_terms`` declares the vocabulary size in the header; it defaults
    to a PaddedCorpus's ``V`` (so a round-trip through
    ``read_mm(return_V=True)`` preserves trailing dictionary ids that
    never occur in any document) or, for plain BoW lists, to the
    largest occurring id + 1.
    """
    if isinstance(corpus, PaddedCorpus):
        if n_terms is None:
            n_terms = corpus.V
        corpus = to_bow(corpus)
    n_docs = len(corpus)
    max_used = 1 + max((w for doc in corpus for (w, _) in doc), default=0)
    if n_terms is None:
        n_terms = max_used
    elif max_used > n_terms:
        raise ValueError(
            f"corpus contains word id {max_used - 1} but n_terms={n_terms}"
        )
    nnz = sum(len(doc) for doc in corpus)
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{n_docs} {n_terms} {nnz}\n")
        for d, doc in enumerate(corpus):
            for w, c in doc:
                f.write(f"{d + 1} {w + 1} {c}\n")


class _BoundUnpickler(pickle.Unpickler):
    """Restricted unpickler for ``lower_bound.pickle`` (a list of plain
    floats from this package; the reference may store numpy scalars).
    Only numpy's scalar-reconstruction globals are admitted."""

    _ALLOWED = {
        ("numpy.core.multiarray", "scalar"),
        ("numpy._core.multiarray", "scalar"),
        ("numpy", "dtype"),
        ("numpy", "float64"),
        ("numpy", "float32"),
    }

    def find_class(self, module, name):
        if (module, name) in self._ALLOWED:
            return getattr(importlib.import_module(module), name)
        raise pickle.UnpicklingError(
            f"refusing to unpickle {module}.{name} from lower_bound.pickle: "
            "model artifacts must not contain arbitrary objects"
        )


def load_model_artifacts(model_dir: str) -> dict:
    """Load a ``*_hat.npy`` artifact directory.

    Returns a dict with whatever of beta/theta/sigma/eta/mu/gamma/X/
    kappa/lower_bound exists.
    """
    out = {}
    for name in ("beta", "theta", "sigma", "eta", "mu", "gamma", "kappa"):
        p = os.path.join(model_dir, f"{name}_hat.npy")
        if os.path.exists(p):
            out[name] = _load_plain_array(p)
    xp = os.path.join(model_dir, "X.npy")
    if os.path.exists(xp):
        out["X"] = _load_plain_array(xp)
    lb = os.path.join(model_dir, "lower_bound.pickle")
    if os.path.exists(lb):
        with open(lb, "rb") as f:
            out["lower_bound"] = _BoundUnpickler(f).load()
    return out


def _load_plain_array(path: str) -> np.ndarray:
    try:
        return np.load(path, allow_pickle=False)
    except ValueError as e:
        raise ValueError(
            f"{path} contains pickled Python objects; model artifacts are "
            "plain numeric arrays (save_model writes them that way) — "
            "refusing to unpickle"
        ) from e


class _GensimDictStub:
    """Attribute bag standing in for gensim.corpora.dictionary.Dictionary
    during unpickling (pickle restores instance state into __dict__)."""

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:  # (dict_state, slots_state) protocol-2 tuple form
            d, s = state
            if d:
                self.__dict__.update(d)
            if s:
                self.__dict__.update(s)


class _GensimDictUnpickler(pickle.Unpickler):
    """Restricted unpickler for gensim Dictionary files.

    ``Dictionary.save`` pickles a gensim class this package does not
    depend on.  Only the gensim Dictionary/SaveLoad classes map to a
    local stub; every other global is refused (never unpickle arbitrary
    classes from data files).
    """

    _ALLOWED = {
        ("gensim.corpora.dictionary", "Dictionary"),
        ("gensim.utils", "SaveLoad"),
    }

    def find_class(self, module, name):
        if (module, name) in self._ALLOWED:
            return _GensimDictStub
        if module == "collections" and name == "OrderedDict":
            import collections

            return collections.OrderedDict
        raise pickle.UnpicklingError(
            f"refusing to unpickle {module}.{name}: not a gensim "
            "Dictionary component"
        )


def read_gensim_dictionary(path: str):
    """Read a gensim ``Dictionary.save`` file -> :class:`Vocabulary`.

    Tokens are ordered by their integer id (missing ids become
    placeholder strings so downstream indexing never KeyErrors).
    """
    with open(path, "rb") as f:
        obj = _GensimDictUnpickler(f).load()
    token2id = getattr(obj, "token2id", None)
    if not token2id:
        id2token = getattr(obj, "id2token", None)
        if not id2token:
            raise ValueError(f"{path} has neither token2id nor id2token")
        token2id = {t: i for i, t in id2token.items()}
    n = max(token2id.values()) + 1 if token2id else 0
    tokens = [f"__missing_{i}" for i in range(n)]
    for tok, i in token2id.items():
        tokens[int(i)] = str(tok)
    return Vocabulary(tokens)


def read_ldac(path: str, vocab_path: str | None = None):
    """Read an LDA-C corpus (Blei's lda-c / R-stm ``readCorpus(...,
    type="ldac")``): one document per line, ``M id:count id:count ...``
    with 0-based term ids.

    Returns the list-of-(idx, count) document format; with
    ``vocab_path`` (one token per line, the standard companion file)
    returns ``(docs, vocab)``.
    """
    docs = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            parts = line.split()
            if not parts:
                continue
            try:
                m = int(parts[0])
                pairs = [(int(w), int(c)) for w, c in
                         (p.split(":") for p in parts[1:])]
            except ValueError as e:
                raise ValueError(
                    f"{path}:{lineno}: malformed LDA-C line ({e})") from e
            if m != len(pairs):
                raise ValueError(
                    f"{path}:{lineno}: declared {m} unique terms but "
                    f"line has {len(pairs)}")
            if any(w < 0 or c <= 0 for w, c in pairs):
                raise ValueError(
                    f"{path}:{lineno}: term ids must be >= 0 and "
                    "counts positive")
            docs.append(pairs)
    if vocab_path is None:
        return docs
    with open(vocab_path) as f:
        vocab = [ln.strip() for ln in f if ln.strip()]
    return docs, vocab


def write_ldac(path: str, corpus, vocab=None, vocab_path: str | None = None) -> None:
    """Write a BoW corpus (or PaddedCorpus) in LDA-C format; with
    ``vocab`` also writes the one-token-per-line companion file
    (default ``<path>.vocab``)."""
    if isinstance(corpus, PaddedCorpus):
        corpus = to_bow(corpus)
    with open(path, "w") as f:
        for d, doc in enumerate(corpus):
            # LDA-C is an integer-count format; PaddedCorpus counts are
            # float32, so round — but refuse genuinely fractional counts
            # rather than silently corrupting them
            pairs = []
            for w, c in doc:
                ci = int(round(float(c)))
                if abs(float(c) - ci) > 1e-6:
                    raise ValueError(
                        f"doc {d}: LDA-C requires integer counts, got "
                        f"{c!r} for term {w}")
                pairs.append(f"{int(w)}:{ci}")
            f.write(f"{len(pairs)} {' '.join(pairs)}\n" if pairs else "0\n")
    if vocab is not None:
        with open(vocab_path or path + ".vocab", "w") as f:
            for tok in vocab:
                f.write(f"{tok}\n")
