"""ctypes bindings for the native C++ ingest library (``native/ingest.cpp``,
``native/bow.cpp``), with the signatures of ``strutopy_tpu/corpus/native.py``.

The library is compiled with ``g++`` at first use (the flags of
``native/Makefile``) into ``build/native/libstm_ingest.so`` at the root
of the checkout (``build/`` is listed in ``.gitignore``), under a lock
file of its own in the same directory, and rebuilt when a ``native/*.cpp``
is newer than it.  Nothing is written under ``native/``, so this loader
and the JAX package's (which builds in ``native/``) never race.  Without a
compiler every entry point returns None and callers take their
pure-Python path (``corpus/preprocess.py``, ``corpus/io.py``).
"""

from __future__ import annotations

import ctypes
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from strutopy_tpu_torch.corpus.bow import PaddedCorpus, _round_up

logger = logging.getLogger(__name__)

_ROOT = Path(__file__).resolve().parents[2]
SRC_DIR = _ROOT / "native"
SOURCES = (SRC_DIR / "ingest.cpp", SRC_DIR / "bow.cpp")
BUILD_DIR = _ROOT / "build" / "native"
LIB_PATH = BUILD_DIR / "libstm_ingest.so"
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_load_lock = threading.Lock()
_lib = None
_tried = False


def _stale() -> bool:
    """Rebuild when the library is missing or a ``native/*.cpp`` is newer."""
    if not LIB_PATH.exists():
        return True
    lib_mtime = LIB_PATH.stat().st_mtime
    return any(src.stat().st_mtime > lib_mtime for src in SRC_DIR.glob("*.cpp"))


def _build() -> None:
    """Compile the library into ``build/native/`` unless it is current.

    Concurrent builders (test workers) serialize on ``build/native/.build.lock``;
    the library is written to a temporary name and renamed into place, so a
    process that opens it never reads a half-written file.
    """
    import fcntl

    cxx = shutil.which("g++")
    if cxx is None:
        raise FileNotFoundError("g++ not found on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _stale():  # another process built it while this one waited
            return
        tmp = LIB_PATH.with_name(f"{LIB_PATH.name}.tmp{os.getpid()}")
        try:
            subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), *map(str, SOURCES)],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, LIB_PATH)
        finally:
            tmp.unlink(missing_ok=True)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _load_lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if _stale():
            try:
                _build()
            except (OSError, subprocess.SubprocessError) as e:  # no toolchain
                logger.debug("native ingest build failed: %s", e)
                return None
        lib = ctypes.CDLL(str(LIB_PATH))
        _declare(lib)
        _lib = lib
        return _lib


def _declare(lib: ctypes.CDLL) -> None:
    """``argtypes``/``restype`` of every entry point of the library."""
    P = ctypes.POINTER
    vp, i32, i64, f32, u8 = (ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
                             ctypes.c_float, ctypes.c_uint8)
    sigs = {
        # MatrixMarket reader and COO packer (native/ingest.cpp)
        "stm_mm_open": (vp, [ctypes.c_char_p]),
        "stm_corpus_n_docs": (i64, [vp]),
        "stm_corpus_n_terms": (i64, [vp]),
        "stm_corpus_max_len": (i64, [vp]),
        "stm_corpus_error": (ctypes.c_char_p, [vp]),
        "stm_corpus_pad": (i32, [vp, i64, P(i32), P(f32), P(u8)]),
        "stm_corpus_free": (None, [vp]),
        "stm_pack_coo": (i64, [P(i64), P(i32), P(f32), i64, i64, i64, i64,
                               P(i32), P(f32), P(u8)]),
        # BoW builder (native/bow.cpp)
        "stm_bow_build": (vp, [ctypes.c_char_p, P(i64), i64, ctypes.c_char_p, i32, i64,
                               ctypes.c_double]),
        "stm_bow_error": (ctypes.c_char_p, [vp]),
        "stm_bow_vocab_size": (i64, [vp]),
        "stm_bow_vocab_blob_len": (i64, [vp]),
        "stm_bow_vocab_copy": (None, [vp, ctypes.c_char_p]),
        "stm_bow_nnz": (i64, [vp]),
        "stm_bow_doc_offsets": (None, [vp, P(i64)]),
        "stm_bow_entries": (None, [vp, P(i32), P(f32)]),
        "stm_bow_free": (None, [vp]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def read_mm_padded(path: str, lane: int = 128):
    """Parse a MatrixMarket corpus directly into a PaddedCorpus.  Returns
    None if the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    h = lib.stm_mm_open(path.encode())
    if not h:
        raise FileNotFoundError(path)
    try:
        err = lib.stm_corpus_error(h)
        if err:
            raise ValueError(f"{path}: {err.decode()}")
        n_docs = lib.stm_corpus_n_docs(h)
        n_terms = lib.stm_corpus_n_terms(h)
        max_len = lib.stm_corpus_max_len(h)
        L = _round_up(max(int(max_len), lane), lane)
        words = np.zeros((n_docs, L), np.int32)
        counts = np.zeros((n_docs, L), np.float32)
        doc_ok = np.zeros(n_docs, np.uint8)
        rc = lib.stm_corpus_pad(h, L, _ptr(words, ctypes.c_int32),
                                _ptr(counts, ctypes.c_float), _ptr(doc_ok, ctypes.c_uint8))
        if rc != 0:
            raise RuntimeError("native pad failed")
    finally:
        lib.stm_corpus_free(h)
    return PaddedCorpus(words=words, counts=counts, doc_ok=doc_ok.astype(bool),
                        V=int(n_terms))


def pack_coo_padded(doc_idx, word_idx, count, n_docs: int, V: int, lane: int = 128):
    """Pack COO triples into a PaddedCorpus.  Returns None if the library
    is unavailable."""
    lib = _load()
    if lib is None:
        return None
    doc_idx = np.ascontiguousarray(doc_idx, np.int64)
    word_idx = np.ascontiguousarray(word_idx, np.int32)
    count = np.ascontiguousarray(count, np.float32)
    nnz = len(doc_idx)
    if len(word_idx) != nnz or len(count) != nnz:
        raise ValueError("doc_idx, word_idx and count must have one length")
    # first pass with one lane; the library returns the L it needs if larger
    L = lane
    while True:
        words = np.zeros((n_docs, L), np.int32)
        counts = np.zeros((n_docs, L), np.float32)
        doc_ok = np.zeros(n_docs, np.uint8)
        rc = lib.stm_pack_coo(
            _ptr(doc_idx, ctypes.c_int64), _ptr(word_idx, ctypes.c_int32),
            _ptr(count, ctypes.c_float), nnz, n_docs, V, L,
            _ptr(words, ctypes.c_int32), _ptr(counts, ctypes.c_float),
            _ptr(doc_ok, ctypes.c_uint8),
        )
        if rc == -2:
            raise ValueError(f"COO word ids outside [0, V={V})")
        if rc < 0:
            raise ValueError("bad doc indices in COO input")
        if rc <= L:
            break
        L = _round_up(int(rc), lane)
    return PaddedCorpus(words=words, counts=counts, doc_ok=doc_ok.astype(bool), V=V)


_WS_RE = None


def build_bow(texts, stopwords, min_len: int = 2, min_doc_freq: int = 1,
              max_doc_frac: float = 1.0):
    """Native BoW construction, the hot loop of
    ``corpus/preprocess.py::build_corpus``.  Returns (bow, vocab_tokens) or
    None if the library is unavailable.

    Python lowercases and maps unicode whitespace to ' ' (case tables stay
    out of C++); the library strips ASCII punctuation and digits (Python's
    regex is ASCII-only too), splits, filters stopwords and ``min_len``
    (in codepoints) and counts.  Both paths give the same vocabulary and
    the same documents (tests/test_torch_text.py).
    """
    lib = _load()
    if lib is None:
        return None
    global _WS_RE
    if _WS_RE is None:
        import re

        _WS_RE = re.compile(r"\s")
    if stopwords and any("\n" in w for w in stopwords):
        # the stopword blob is newline-delimited; an embedded newline would
        # split one stopword into two: the Python path matches whole tokens
        return None
    encs = [_WS_RE.sub(" ", t.lower()).encode("utf-8") for t in texts]
    n = len(encs)
    offs = np.zeros(n + 1, np.int64)
    if n:
        np.cumsum([len(e) for e in encs], out=offs[1:])
    blob = b"".join(encs)
    stop_blob = ("\n".join(sorted(stopwords)) if stopwords else "").encode("utf-8")

    h = lib.stm_bow_build(blob, _ptr(offs, ctypes.c_int64), n, stop_blob, min_len,
                          min_doc_freq, float(max_doc_frac))
    try:
        err = lib.stm_bow_error(h)
        if err:
            raise ValueError(f"native bow: {err.decode()}")
        blob_len = int(lib.stm_bow_vocab_blob_len(h))
        buf = ctypes.create_string_buffer(blob_len)
        lib.stm_bow_vocab_copy(h, buf)
        vocab_tokens = buf.raw[:blob_len].decode("utf-8").split("\n") if blob_len else []
        doc_offs = np.zeros(n + 1, np.int64)
        lib.stm_bow_doc_offsets(h, _ptr(doc_offs, ctypes.c_int64))
        nnz = int(lib.stm_bow_nnz(h))
        idx = np.zeros(nnz, np.int32)
        cnt = np.zeros(nnz, np.float32)
        if nnz:
            lib.stm_bow_entries(h, _ptr(idx, ctypes.c_int32), _ptr(cnt, ctypes.c_float))
    finally:
        lib.stm_bow_free(h)

    cnt_i = cnt.astype(np.int64)
    bow = [
        list(zip(idx[a:b].tolist(), cnt_i[a:b].tolist()))
        for a, b in zip(doc_offs[:-1].tolist(), doc_offs[1:].tolist())
    ]
    return bow, vocab_tokens
