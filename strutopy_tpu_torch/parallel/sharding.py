"""Document- and vocabulary-sharded EM (twin of
``strutopy_tpu/parallel/sharding.py``).

Under the SPMD contract of :mod:`~strutopy_tpu_torch.parallel.mesh`
every rank holds the whole corpus on the host and keeps its own shard on
its device:

  * per-document arrays (the corpus buckets, ``mu``, ``eta``, ``theta``,
    ``opt_iters``) are row shards over the ``docs`` axis, in the
    device-major storage order of ``corpus/bucketing.py`` (rank r holds
    rows ``[r·n/size, (r+1)·n/size)`` of each bucket and of the state);
  * under a 2-D mesh ``beta`` and ``kappa`` are column shards of the
    vocabulary over the ``vocab`` axis (rank v holds words
    ``[v·V/nv, (v+1)·V/nv)``);
  * everything else is replicated.

Each rank runs the E-step on its shard; the sufficient statistics are
summed over the ``docs`` axis once an iteration and the M-step runs
replicated.  Per-document arrays come back whole by an exact sum: each
rank writes its rows into zeros and one SUM assembles them (adding zeros
changes no bit), as the JAX package assembles ``beta_doc``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from strutopy_tpu_torch.models.config import STMConfig
from strutopy_tpu_torch.models.state import STMState
from strutopy_tpu_torch.ops import mstep
from strutopy_tpu_torch.parallel.mesh import (
    DOC_AXIS,
    VOCAB_AXIS,
    MeshAxis,
    all_sum,
    doc_axis,
    is_first,
    mesh_axis,
    vocab_axis,
)

PER_DOC_FIELDS = ("mu", "eta", "theta", "opt_iters")


def _state_specs(content: bool, vocab_sharded: bool = False) -> dict:
    """The axis each :class:`STMState` field shards over: ``DOC_AXIS``
    for the per-document rows, ``VOCAB_AXIS`` for the vocabulary columns
    of beta (``(K, V)`` or a content model's ``(A, K, V)``) and kappa
    under a 2-D mesh, None for a replicated field.  ``content`` is taken
    for the JAX signature: beta's vocabulary is its last dimension
    either way."""
    del content
    vocab = VOCAB_AXIS if vocab_sharded else None
    return {f.name: (DOC_AXIS if f.name in PER_DOC_FIELDS
                     else vocab if f.name in ("beta", "kappa") else None)
            for f in dataclasses.fields(STMState)}


def shard_rows(x: torch.Tensor, axis: MeshAxis, n_blocks: int = 1) -> torch.Tensor:
    """This rank's rows of ``x``: ``x`` is ``n_blocks`` blocks of rows
    (the parts of a streamed fit; 1 otherwise), each split evenly over
    the axis, and the rank's rows of every block, in block order, come
    back as a copy."""
    n = x.shape[0]
    if n % (n_blocks * axis.size):
        raise ValueError(f"{n} rows do not split into {n_blocks} block(s) of "
                         f"{axis.size} shards")
    m = n // (n_blocks * axis.size)
    return x.reshape(n_blocks, axis.size, m, *x.shape[1:])[:, axis.rank].reshape(
        n_blocks * m, *x.shape[1:]).clone()


def gather_rows(x: torch.Tensor, axis: MeshAxis, n_blocks: int = 1) -> torch.Tensor:
    """The inverse of :func:`shard_rows` on every rank of the axis: each
    rank writes its rows into zeros and one SUM assembles the whole,
    exactly."""
    m = x.shape[0] // n_blocks
    full = torch.zeros((n_blocks, axis.size, m) + tuple(x.shape[1:]), dtype=x.dtype,
                       device=x.device)
    full[:, axis.rank] = x.reshape(n_blocks, m, *x.shape[1:])
    return all_sum(full, axis).reshape(n_blocks * axis.size * m, *x.shape[1:])


def shard_cols(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """This rank's contiguous block of the last (vocabulary) dimension."""
    V = x.shape[-1]
    if V % axis.size:
        raise ValueError(
            f"V={V} is not divisible by the {axis.size}-way vocab mesh axis; "
            "pad the vocabulary (PaddedCorpus(..., V=...)) to a multiple")
    Vl = V // axis.size
    return x[..., axis.rank * Vl:(axis.rank + 1) * Vl].clone()


def gather_cols(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """The inverse of :func:`shard_cols` on every rank of the axis, by
    the exact sum."""
    Vl = x.shape[-1]
    full = torch.zeros(tuple(x.shape[:-1]) + (Vl * axis.size,), dtype=x.dtype,
                       device=x.device)
    full[..., axis.rank * Vl:(axis.rank + 1) * Vl] = x
    return all_sum(full, axis)


def shard_corpus(mesh, data):
    """This rank's rows of every bucket of every field of a
    :class:`~strutopy_tpu_torch.models.em.CorpusData`."""
    ax = doc_axis(mesh)
    return dataclasses.replace(data, **{
        f.name: tuple(shard_rows(x, ax) for x in getattr(data, f.name))
        for f in dataclasses.fields(data)})


def shard_state(mesh, state: STMState, content: bool = False, n_blocks: int = 1) -> STMState:
    """This rank's shard of a whole state (see :func:`_state_specs`).
    Raises when the vocabulary does not split over the vocab axis."""
    axes = {DOC_AXIS: doc_axis(mesh), VOCAB_AXIS: vocab_axis(mesh)}
    out = {}
    for name, spec in _state_specs(content, axes[VOCAB_AXIS] is not None).items():
        x = getattr(state, name)
        out[name] = (x if spec is None
                     else shard_rows(x, axes[spec], n_blocks) if spec == DOC_AXIS
                     else shard_cols(x, axes[spec]))
    return STMState(**out)


def gather_state(mesh, state: STMState, content: bool = False, n_blocks: int = 1) -> STMState:
    """The whole state from this rank's shard, on every rank (a
    collective: every rank of the mesh must call it)."""
    axes = {DOC_AXIS: doc_axis(mesh), VOCAB_AXIS: vocab_axis(mesh)}
    out = {}
    for name, spec in _state_specs(content, axes[VOCAB_AXIS] is not None).items():
        x = getattr(state, name)
        out[name] = (x if spec is None
                     else gather_rows(x, axes[spec], n_blocks) if spec == DOC_AXIS
                     else gather_cols(x, axes[spec]))
    return STMState(**out)


def replicate_from_first(mesh, x: np.ndarray, device) -> np.ndarray:
    """The first rank's ``x`` on every rank of ``mesh``, bit for bit:
    the other ranks contribute zeros to one SUM along each axis.  For
    host results each rank computes on its own (a spectral init), so
    every rank starts from the same bits whatever its rounding."""
    t = torch.as_tensor(np.asarray(x), device=device)
    t = t.clone() if is_first(mesh) else torch.zeros_like(t)
    for name in mesh.mesh_dim_names:
        all_sum(t, mesh_axis(mesh, name))
    return t.cpu().numpy()


def psum_over(axis: Optional[MeshAxis]):
    """``psum(x)`` for :func:`~strutopy_tpu_torch.models.em.em_iteration`:
    a tensor, or a tuple of them, summed over ``axis`` (the identity on
    ``None``)."""
    def psum(x):
        if isinstance(x, tuple):
            return tuple(psum(t) for t in x)
        return all_sum(x, axis)

    return psum


def make_sharded_em_step(mesh, cfg: STMConfig, design: mstep.PrevalenceDesign,
                         kappa_design, wcounts, n_buckets: int = 1, bucket_batches=None):
    """The sharded EM step: (state, data) -> state, on this rank's shards
    (:func:`shard_state`, :func:`shard_corpus`).  The statistics are
    summed over the docs axis; under a 2-D mesh the E-step assembles each
    chunk's beta_doc with one vocab all-reduce and scatters phi into the
    local columns, and the M-step's row sums reduce over the vocab axis.
    ``n_buckets`` is the number of length buckets ``data`` carries."""
    from strutopy_tpu_torch.models.em import em_iteration  # em imports the mesh helpers

    vocab = vocab_axis(mesh)
    step = functools.partial(em_iteration, design=design, kappa_design=kappa_design,
                             wcounts=wcounts, cfg=cfg, bucket_batches=bucket_batches,
                             psum=psum_over(doc_axis(mesh)), vocab=vocab)

    def em_step(state: STMState, data) -> STMState:
        if data.n_buckets != n_buckets:
            raise ValueError(f"the step was built for {n_buckets} bucket(s), "
                             f"the data has {data.n_buckets}")
        return step(state, data)

    return em_step
