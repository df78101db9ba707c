"""The ordered phi scatter (strutopy_tpu_torch/ops/stages.py::scatter_plan,
scatter_phi_plain; estep._scatter_phi) against the JAX package's
``_scatter_phi`` (an XLA scatter) and against a serial loop in the
contract's order: each key's entries added into beta_ss one at a time,
in ascending flat position, in float32."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from strutopy_tpu.ops import estep as jax_estep
from strutopy_tpu_torch.ops import estep, stages
from strutopy_tpu_torch.parallel.mesh import MeshAxis
from torch_world import one_thread

K, V, A, B, L = 13, 40, 2, 16, 24


@pytest.fixture(autouse=True, scope="module")
def _torch_on_one_thread():
    """torch's CPU ops on one thread for every test of this file
    (tests/torch_world.py::one_thread)."""
    with one_thread():
        yield


def _chunk(seed=0, every=None):
    """A chunk as the finalize hands it over: unique words a document,
    padding slots at word 0 with count 0 and phi +0, and a padding
    document whose phi is +0; ``every`` puts that word in every document."""
    rng = np.random.default_rng(seed)
    words = np.zeros((B, L), np.int32)
    counts = np.zeros((B, L), np.float32)
    for b in range(B):
        n = int(rng.integers(L // 2, L + 1))
        words[b, :n] = rng.choice(V, n, replace=False)
        if every is not None and every not in words[b, :n]:
            words[b, int(rng.integers(n))] = every
        counts[b, :n] = rng.integers(1, 5, n)
    aspects = rng.integers(0, A, B).astype(np.int32)
    doc_w = np.ones(B, np.float32)
    doc_w[-1] = 0.0
    phi = rng.random((B, K, L)).astype(np.float32) * counts[:, None, :] * doc_w[:, None, None]
    return dict(words=words, counts=counts, aspects=aspects, phi=phi,
                ss0=rng.random((A, K, V)).astype(np.float32))


def _serial(ss0, phi, keys):
    """The contract as a loop: every entry, padding included (+0), in flat
    order added into its key's column of a float32 copy of ``ss0``; keys
    out of range (a word another rank owns) dropped."""
    ss = ss0.copy()
    Vb = ss.shape[-1]
    flat = ss.reshape(-1, K, Vb)
    rows = phi.transpose(0, 2, 1).reshape(-1, K)
    for e, key in enumerate(keys.reshape(-1)):
        if 0 <= key < flat.shape[0] * Vb:
            flat[key // Vb, :, key % Vb] += rows[e]
    return ss


def _port(x, kind, rank=None):
    """estep._scatter_phi on CPU tensors (the plain version) for one kind
    of key: "kv" (K, V), "aspect" (A, K, V), "vocab" (rank's block of
    V / 2 words)."""
    T = torch.tensor
    if kind == "kv":
        ss = T(x["ss0"][0])
        return estep._scatter_phi(ss, T(x["phi"]), T(x["words"]), counts=T(x["counts"])).numpy()
    if kind == "aspect":
        return estep._scatter_phi(T(x["ss0"]), T(x["phi"]), T(x["words"]), T(x["aspects"]),
                                  counts=T(x["counts"])).numpy()
    half = V // 2
    ss = T(x["ss0"][0, :, rank * half:(rank + 1) * half].copy())
    return estep._scatter_phi(ss, T(x["phi"]), T(x["words"]), vocab=MeshAxis(None, rank, 2),
                              counts=T(x["counts"])).numpy()


def _keys(x, kind, rank=None):
    """The contract's key of every slot; a foreign word's slot gets a key
    of its own beyond the block (its phi counts +0 there, out of range)."""
    w = x["words"].astype(np.int64)
    if kind == "aspect":
        return x["aspects"][:, None].astype(np.int64) * V + w
    if kind == "vocab":
        half = V // 2
        wl = w - rank * half
        return np.where((wl >= 0) & (wl < half), wl, -1)
    return w


def _jax(x, kind):
    """The JAX package's _scatter_phi; for "vocab" both ranks' shards, each
    computed under a vmapped axis named like the mesh's vocab axis."""
    phi, words = jnp.asarray(x["phi"]), jnp.asarray(x["words"])
    aspects = jnp.asarray(x["aspects"])
    if kind == "kv":
        return np.asarray(jax_estep._scatter_phi(jnp.asarray(x["ss0"][0]), phi, words, None))
    if kind == "aspect":
        return np.asarray(jax_estep._scatter_phi(jnp.asarray(x["ss0"]), phi, words, aspects))
    half = V // 2
    shards = jnp.asarray(np.stack([x["ss0"][0, :, r * half:(r + 1) * half] for r in range(2)]))
    return np.asarray(jax.vmap(
        lambda ss: jax_estep._scatter_phi(ss, phi, words, aspects, vocab_axis="vocab"),
        axis_name="vocab")(shards))


def _ss0(x, kind, rank=None):
    if kind == "kv":
        return x["ss0"][0]
    if kind == "aspect":
        return x["ss0"]
    half = V // 2
    return x["ss0"][0, :, rank * half:(rank + 1) * half].copy()


KINDS = ["kv", "aspect", "vocab"]


@pytest.mark.parametrize("every", [None, 7], ids=["words", "a_word_in_every_document"])
@pytest.mark.parametrize("kind", KINDS)
def test_ordered_scatter_matches_jax(kind, every):
    """Tolerance 0: the XLA scatter on the CPU adds in the contract's order."""
    x = _chunk(seed=1, every=every)
    want = _jax(x, kind)
    if kind == "vocab":
        for r in range(2):
            np.testing.assert_array_equal(_port(x, kind, r), want[r], err_msg=f"vocab rank {r}")
    else:
        np.testing.assert_array_equal(_port(x, kind), want)


@pytest.mark.parametrize("every", [None, 7], ids=["words", "a_word_in_every_document"])
@pytest.mark.parametrize("kind", KINDS)
def test_ordered_scatter_is_the_serial_loop_bit_for_bit(kind, every):
    x = _chunk(seed=2, every=every)
    for r in (0, 1) if kind == "vocab" else (None,):
        want = _serial(_ss0(x, kind, r), x["phi"], _keys(x, kind, r))
        np.testing.assert_array_equal(_port(x, kind, r), want)


def test_a_word_in_every_document_sums_b_entries_in_document_order():
    x = _chunk(seed=3, every=7)
    plan = stages.scatter_plan(torch.tensor(x["words"]), torch.tensor(x["counts"] > 0), V)
    perm, off = plan.perm.numpy(), plan.offsets.numpy()
    seg = perm[off[7]:off[8]]
    assert len(seg) == B  # the padding document's slot counts too (its phi is +0)
    np.testing.assert_array_equal(seg // L, np.arange(B))


@pytest.mark.parametrize("kind", KINDS)
def test_plan_invariants(kind):
    x = _chunk(seed=4, every=3)
    keys = _keys(x, kind, 1)
    n_keys = {"kv": V, "aspect": A * V, "vocab": V // 2}[kind]
    live = x["counts"] > 0
    plan = stages.scatter_plan(torch.tensor(np.where(keys < 0, 0, keys).astype(np.int32)),
                               torch.tensor(live & (keys >= 0)), n_keys)
    perm, off = plan.perm.numpy(), plan.offsets.numpy()
    assert plan.perm.dtype == plan.offsets.dtype == torch.int32
    # every flat position once; offsets monotone from 0 to the live count
    np.testing.assert_array_equal(np.sort(perm), np.arange(B * L))
    assert off.shape == (n_keys + 1,) and off[0] == 0 and (np.diff(off) >= 0).all()
    n_live = int((live & (keys >= 0)).sum())
    assert off[-1] == n_live
    flat_keys, flat_live = keys.reshape(-1), (live & (keys >= 0)).reshape(-1)
    for k in range(n_keys):
        seg = perm[off[k]:off[k + 1]]
        assert (flat_keys[seg] == k).all() and flat_live[seg].all()
        assert (np.diff(seg) > 0).all()  # ascending flat position
    # the entries left out: padding slots, whose phi is +0, and words
    # another rank owns (the JAX package adds them as +0)
    out = perm[n_live:]
    assert not flat_live[out].any()
    pad = out[x["counts"].reshape(-1)[out] == 0]
    rows = x["phi"].transpose(0, 2, 1).reshape(-1, K)
    assert len(pad) and (rows[pad] == 0).all() and not np.signbit(rows[pad]).any()
    assert (flat_keys[np.setdiff1d(out, pad)] < 0).all()


def test_finalize_phi_is_plus_zero_where_it_is_left_out():
    """The finalize's phi is +0 (not -0) at count-0 slots and in documents
    of weight 0, so leaving them out of the sums changes no bit; and it is
    laid out entry-major, the rows the scatter reads without a copy."""
    rng = np.random.default_rng(5)
    Kf, Bf, Lf = 6, 8, 20
    bd = torch.tensor(rng.dirichlet(np.ones(Lf), size=(Bf, Kf)).astype(np.float32))
    c = rng.integers(1, 5, (Bf, Lf)).astype(np.float32)
    c[:, -5:] = 0
    c = torch.tensor(c)
    eta = torch.tensor(rng.normal(0, 0.5, (Bf, Kf - 1)).astype(np.float32))
    w = torch.ones(Bf)
    w[-2:] = 0
    _, _, _, phi = estep._finalize_chunk(eta, bd, c, torch.zeros(Bf, Kf - 1), w,
                                         torch.eye(Kf - 1), torch.zeros(()), c.sum(1))
    assert phi.shape == (Bf, Kf, Lf) and phi.transpose(1, 2).is_contiguous()
    dead = ((c == 0) | (w[:, None] == 0))[:, None, :].expand_as(phi)
    assert (phi[dead] == 0).all() and not torch.signbit(phi[dead]).any()
    assert (phi[~dead] > 0).all()


def test_scatter_phi_takes_any_phi_layout():
    """A (B, K, L)-contiguous phi (copied to rows) and an entry-major one
    give the same bits."""
    x = _chunk(seed=6)
    T = torch.tensor
    phi_rows = T(np.ascontiguousarray(x["phi"].transpose(0, 2, 1))).transpose(1, 2)
    a = estep._scatter_phi(T(x["ss0"][0]), T(x["phi"]), T(x["words"]), counts=T(x["counts"]))
    b = estep._scatter_phi(T(x["ss0"][0]), phi_rows, T(x["words"]), counts=T(x["counts"]))
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_cuda_scatter_kernel_matches_plain(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py runs this check on the card)")
    x = _chunk(seed=7, every=3)
    keys = _keys(x, kind, 1)
    n_keys = {"kv": V, "aspect": A * V, "vocab": V // 2}[kind]
    ss0 = _ss0(x, kind, 1)
    plan = stages.scatter_plan(torch.tensor(np.where(keys < 0, 0, keys).astype(np.int32)).cuda(),
                               torch.tensor((x["counts"] > 0) & (keys >= 0)).cuda(), n_keys)
    rows = torch.tensor(np.ascontiguousarray(x["phi"].transpose(0, 2, 1).reshape(-1, K))).cuda()
    n0 = stages.LAUNCHES["scatter"]
    got = stages.scatter_phi(torch.tensor(ss0).cuda(), rows, plan, V if kind != "vocab" else V // 2)
    want = stages.scatter_phi_plain(torch.tensor(ss0).cuda(), rows, plan,
                                    V if kind != "vocab" else V // 2)
    torch.cuda.synchronize()
    assert stages.LAUNCHES["scatter"] == n0 + 1
    assert torch.equal(got, want)
