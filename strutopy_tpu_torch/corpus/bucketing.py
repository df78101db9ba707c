"""Length bucketing for ragged corpora.

A numpy copy of ``strutopy_tpu/corpus/bucketing.py`` (see
``corpus/bow.py`` for why the port keeps copies of the host layers).

Buckets partition documents by unique-term count into a few
lane-aligned length classes; the E-step runs per bucket at its own L.
Storage layout: bucket-contiguous.  Each bucket is padded to a multiple
of its batch, and ``storage_index[i]`` maps user document i to its row
in the concatenated per-document state.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from strutopy_tpu_torch.corpus.bow import LANE, PaddedCorpus, _round_up


def plan_bounds(
    lens: np.ndarray,
    lane: int = LANE,
    max_buckets: int = 4,
    min_frac: float = 0.04,
) -> List[int]:
    """Choose bucket length bounds (multiples of ``lane``): start from
    all lane multiples covering the data, merge under-filled buckets
    upward, keep at most ``max_buckets``."""
    lens = np.asarray(lens)
    max_len = max(int(lens.max()), 1)
    bounds = [lane * i for i in range(1, _round_up(max_len, lane) // lane + 1)]
    n = len(lens)
    while len(bounds) > 1:
        counts = []
        lo = 0
        for b in bounds:
            counts.append(int(((lens > lo) & (lens <= b)).sum()))
            lo = b
        mergeable = [(c, i) for i, c in enumerate(counts[:-1]) if c < min_frac * n]
        if not mergeable and len(bounds) <= max_buckets:
            break
        if mergeable:
            _, i = min(mergeable)
        else:
            _, i = min((c, i) for i, c in enumerate(counts[:-1]))
        bounds.pop(i)
    return bounds


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Assignment of documents to length buckets.

    Per (non-empty) bucket: its max length ``Ls[b]``, the user doc ids
    ``doc_ids[b]``, the padded size ``sizes[b]`` (a multiple of
    ``n_devices * batch_sizes[b]``) and the scan batch.
    """

    Ls: Tuple[int, ...]
    doc_ids: Tuple[np.ndarray, ...]
    sizes: Tuple[int, ...]
    batch_sizes: Tuple[int, ...]
    storage_index: np.ndarray
    n_storage: int
    n_devices: int

    @property
    def n_buckets(self) -> int:
        return len(self.Ls)

    def padded_area(self) -> int:
        """Total word slots the bucketed E-step processes."""
        return sum(s * L for s, L in zip(self.sizes, self.Ls))


def make_bucket_plan(
    corpus: PaddedCorpus,
    batch_size: int,
    n_devices: int = 1,
    lane: int = LANE,
    max_buckets: int = 4,
) -> BucketPlan:
    # bucket by the LAST nonzero column + 1 (not the nonzero count), so
    # trimming a bucket to its L is safe for rows that are not
    # front-packed; doc_ok=False rows count as empty
    L = corpus.L
    nz = (corpus.counts > 0) & corpus.doc_ok[:, None]
    last_nz = np.where(nz.any(axis=1), L - np.argmax(nz[:, ::-1], axis=1), 0)
    lens = np.maximum(last_nz, 1)
    bounds = plan_bounds(lens[corpus.doc_ok] if corpus.doc_ok.any() else lens,
                         lane=lane, max_buckets=max_buckets)

    Ls, doc_ids, sizes, batches = [], [], [], []
    lo = 0
    for b in bounds:
        ids = np.nonzero((lens > lo) & (lens <= b))[0]
        lo = b
        if len(ids) == 0:
            continue
        per_dev = -(-len(ids) // n_devices)
        B = min(batch_size, _round_up(per_dev, 8))
        per_dev_pad = _round_up(per_dev, B)
        Ls.append(min(b, corpus.L))
        doc_ids.append(ids)
        sizes.append(per_dev_pad * n_devices)
        batches.append(B)

    n_storage = sum(sizes)
    shard = n_storage // n_devices
    storage_index = np.zeros(corpus.N, np.int64)
    off_local = 0
    for ids, size in zip(doc_ids, sizes):
        per_dev = size // n_devices
        r = np.arange(len(ids))
        d = r // per_dev
        j = r % per_dev
        storage_index[ids] = d * shard + off_local + j
        off_local += per_dev
    return BucketPlan(
        Ls=tuple(Ls),
        doc_ids=tuple(doc_ids),
        sizes=tuple(sizes),
        batch_sizes=tuple(batches),
        storage_index=storage_index,
        n_storage=n_storage,
        n_devices=n_devices,
    )


def split_corpus_by_plan(corpus: PaddedCorpus, plan: BucketPlan) -> List[PaddedCorpus]:
    """Per-bucket PaddedCorpus, trimmed to the bucket's L and padded to
    the planned size with dummy docs.  doc_ok=False rows get their
    counts zeroed so masked documents behave exactly like padding."""
    out = []
    for ids, L, size in zip(plan.doc_ids, plan.Ls, plan.sizes):
        ok = corpus.doc_ok[ids]
        sub = PaddedCorpus(
            words=np.ascontiguousarray(corpus.words[ids][:, :L]),
            counts=np.ascontiguousarray(corpus.counts[ids][:, :L])
            * ok[:, None].astype(corpus.counts.dtype),
            doc_ok=ok,
            V=corpus.V,
        ).pad_docs_to(size)
        out.append(sub)
    return out


def gather_per_bucket(values: np.ndarray, plan: BucketPlan, fill=0):
    """Split a user-ordered per-doc array into padded per-bucket arrays."""
    out = []
    for ids, size in zip(plan.doc_ids, plan.sizes):
        shape = (size,) + values.shape[1:]
        arr = np.full(shape, fill, dtype=values.dtype)
        arr[: len(ids)] = values[ids]
        out.append(arr)
    return out
