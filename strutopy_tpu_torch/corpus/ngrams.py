"""Bigram collocation detection (a copy of ``strutopy_tpu/corpus/ngrams.py``).

Standard PMI-with-count-threshold phrase detection (the gensim
``Phrases`` scheme): bigrams whose score
``(count(a,b) - min_count) * N / (count(a) * count(b))`` exceeds a
threshold are merged into single ``a_b`` tokens, applied greedily
left-to-right.  Dependency-free.
"""

from __future__ import annotations

from collections import Counter
from typing import Iterable, List, Tuple


def learn_bigrams(
    token_docs: Iterable[List[str]],
    min_count: int = 5,
    threshold: float = 10.0,
) -> set:
    """Return the set of (a, b) pairs to merge."""
    unigrams: Counter = Counter()
    bigrams: Counter = Counter()
    for toks in token_docs:
        unigrams.update(toks)
        bigrams.update(zip(toks, toks[1:]))
    total = max(sum(unigrams.values()), 1)
    out = set()
    for (a, b), c_ab in bigrams.items():
        if c_ab < min_count:
            continue
        score = (c_ab - min_count) * total / (unigrams[a] * unigrams[b])
        if score > threshold:
            out.add((a, b))
    return out


def apply_bigrams(tokens: List[str], merges: set, sep: str = "_") -> List[str]:
    """Greedy left-to-right merge of learned bigrams."""
    out = []
    i = 0
    n = len(tokens)
    while i < n:
        if i + 1 < n and (tokens[i], tokens[i + 1]) in merges:
            out.append(tokens[i] + sep + tokens[i + 1])
            i += 2
        else:
            out.append(tokens[i])
            i += 1
    return out


def ngram_docs(
    token_docs: List[List[str]],
    min_count: int = 5,
    threshold: float = 10.0,
    passes: int = 1,
) -> Tuple[List[List[str]], set]:
    """Learn + apply bigrams; ``passes=2`` yields up to 4-grams."""
    merges_all = set()
    for _ in range(passes):
        merges = learn_bigrams(token_docs, min_count, threshold)
        if not merges:
            break
        token_docs = [apply_bigrams(t, merges) for t in token_docs]
        merges_all |= merges
    return token_docs, merges_all
