"""One rank of the gloo worlds that tests/test_torch_parallel.py starts.

    python tests/torch_parallel_worker.py RANK WORLD DIR

Joins a world of WORLD processes through the file store ``DIR/store``,
reads the inputs ``DIR/inputs.pkl`` (plain lists and numpy arrays), runs
every scenario of this file in order on its rank and pickles what they
return to ``DIR/rank{RANK}.pkl``.  A scenario that raises ends the
process with a non-zero code (the test then fails and ends the world).
It imports torch, numpy and the port only: jax and ``strutopy_tpu`` are
blocked.
"""

import datetime
import hashlib
import os
import pickle
import sys

sys.modules["jax"] = None
sys.modules["strutopy_tpu"] = None
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from strutopy_tpu_torch import STM, STMConfig  # noqa: E402
from strutopy_tpu_torch.models.serving import infer_theta  # noqa: E402
from strutopy_tpu_torch.ops import mstep, spectral  # noqa: E402
from strutopy_tpu_torch.parallel.mesh import (  # noqa: E402
    all_max,
    all_sum,
    doc_axis,
    make_mesh,
    make_mesh_2d,
    vocab_axis,
)
from strutopy_tpu_torch.parallel.sharding import (  # noqa: E402
    gather_cols,
    shard_cols,
)

CPU = dict(device="cpu")


def fit_out(m):
    return dict(bounds=np.asarray(m.last_bounds), beta=m.beta, sigma=m.sigma,
                theta=m.theta)


def digest(state) -> str:
    h = hashlib.sha256()
    for name in ("beta", "mu", "sigma", "eta", "theta", "gamma", "kappa"):
        h.update(getattr(state, name).cpu().numpy().tobytes())
    return h.hexdigest()


def resume_case(ctx, tag, **extra):
    ckpt = os.path.join(ctx["dir"], f"{tag}.npz")
    kw = dict(ctx["toy_kw"], mesh=ctx["mesh1"], **CPU, **extra)
    full = STM(**dict(kw, max_em_iter=4))
    full.expectation_maximization()
    part1 = STM(**dict(kw, max_em_iter=2))
    part1.expectation_maximization(checkpoint_path=ckpt)
    part2 = STM(**dict(kw, max_em_iter=4))
    part2.expectation_maximization(checkpoint_path=ckpt, resume=True)
    return dict(full_bounds=np.asarray(full.last_bounds), full_beta=full.beta,
                full_theta=full.theta, resumed_bounds=np.asarray(part2.last_bounds),
                resumed_beta=part2.beta, resumed_theta=part2.theta)


def scenarios(ctx):
    """(name, fn(ctx) -> result), in the order every rank runs them."""
    inp = ctx["inputs"]
    toy, m1, m2 = ctx["toy_kw"], ctx["mesh1"], ctx["mesh2"]

    def mesh_errors(_):
        out = {}
        for name, fn in (("make_mesh_8", lambda: make_mesh(8)),
                         ("make_mesh_2", lambda: make_mesh(2)),
                         ("make_mesh_2d_4x2", lambda: make_mesh_2d(4, 2))):
            try:
                fn()
                out[name] = ""
            except ValueError as e:
                out[name] = str(e)
        return out

    def gate_A(_):
        m = STM(**toy, mesh=m1, **CPU)
        m.expectation_maximization()
        return dict(fit_out(m), local_rows=m._state.eta.shape[0], n_storage=m._plan.n_storage)

    def gate_B(_):
        m = STM(**toy, mesh=m2, **CPU)
        m.expectation_maximization()
        return dict(fit_out(m), local_cols=m._state.beta.shape[-1])

    def gate_C(_):
        m = STM(inp["docs2"], inp["words2"], X=inp["X2"],
                config=STMConfig(**inp["cfg_c"]), mesh=m1, **CPU)
        m.expectation_maximization()
        return dict(fit_out(m), n_buckets=m._plan.n_buckets)

    def gate_D(_):
        m = STM(**dict(toy, max_em_iter=2), stream_parts=2, mesh=m1, **CPU)
        m.expectation_maximization()
        return dict(fit_out(m), resident=m._data is not None)

    def serve(mesh):
        s = inp["serve"]
        theta, eta = infer_theta(s["beta"], s["sigma"], s["mu"], inp["docs2"],
                                 STMConfig(**inp["cfg_c"]), mesh=mesh, **CPU)
        return dict(theta=theta, eta=eta)

    def gate_F(_):
        m = STM(**dict(toy, max_em_iter=2), stream_parts=2, mesh=m2, **CPU)
        m.expectation_maximization()
        return fit_out(m)

    def gate_G(_):
        m = STM(**inp["content_kw"], mesh=m2, **CPU)
        m.expectation_maximization()
        return dict(fit_out(m), kappa=m.kappa)

    def init_bits(_):
        # spectral init: sharded Gram on the 1-D mesh, unsharded on every
        # rank of the 2-D mesh; random init; every rank's whole state
        kw = dict(toy, init_type="spectral")
        out = {}
        for tag, mesh, extra in (("spectral_1d", m1, kw), ("spectral_2d", m2, kw),
                                 ("random_2d", m2, toy)):
            m = STM(**extra, mesh=mesh, **CPU)
            out[tag] = digest(m._whole())
            if tag == "spectral_1d":
                out["spectral_beta"] = m.beta
        return out

    def mstep_vocab(_):
        va = vocab_axis(m2)
        rng = np.random.default_rng(3)
        K, V, A = 3, 16, 2
        bss = torch.tensor(rng.gamma(1.0, 1.0, (K, V)), dtype=torch.float32)
        bss3 = torch.tensor(rng.gamma(1.0, 1.0, (A, K, V)), dtype=torch.float32)
        wc = torch.tensor(rng.integers(1, 50, V), dtype=torch.float32)
        kd = mstep.build_kappa_design(K, A, True)
        k0 = torch.tensor(rng.normal(0, 0.1, (kd.shape[1], V)), dtype=torch.float32)
        psum = lambda x: all_sum(x, va)  # noqa: E731
        pmax = lambda x: all_max(x, va)  # noqa: E731
        lda = mstep.update_beta_lda(bss, 0.05)
        lda_v = gather_cols(mstep.update_beta_lda(shard_cols(bss, va), 0.05, psum), va)
        b, k = mstep.update_beta_content(bss3, wc, kd, kappa0=k0, iters=20)
        bv, kv = mstep.update_beta_content(
            shard_cols(bss3, va), shard_cols(wc, va), kd, kappa0=shard_cols(k0, va),
            iters=20, vocab_psum=psum, vocab_pmax=pmax, wcounts_total=torch.sum(wc))
        return dict(lda=lda.numpy(), lda_v=lda_v.numpy(), beta=b.numpy(),
                    beta_v=gather_cols(bv, va).numpy(), kappa=k.numpy(),
                    kappa_v=gather_cols(kv, va).numpy())

    def gram(_):
        w, c, keep, _wp, n_chunks = spectral.filter_corpus(inp["padded2"], 320, 5000)
        B = w.shape[0] // n_chunks
        Q, _ = spectral._gram_scan(torch.as_tensor(w), torch.as_tensor(c), n_chunks,
                                   len(keep))
        Qs, _ = spectral._gram_scan_sharded(m1, w, c, 8, len(keep), device="cpu")
        return dict(Q=Q.numpy(), Q_sharded=Qs.numpy(), B=B)

    def select(_):
        from strutopy_tpu_torch import pipeline

        res = pipeline.select_model(toy["documents"], K=3, runs=2, cast_iters=1,
                                    max_em_iter=3, X=toy["X"], mesh=m2, return_models=False,
                                    **CPU)
        return dict(bounds=np.asarray([r["bound"] for r in res["runs"] if r["kept"]]),
                    kept=res["kept"])

    def cli_fit(_):
        from strutopy_tpu_torch import cli

        os.environ.update(RANK=str(ctx["rank"]), WORLD_SIZE=str(ctx["world"]),
                          LOCAL_RANK=str(ctx["rank"]), MASTER_ADDR="localhost",
                          MASTER_PORT="0")
        cli.main(["--device", "cpu", "fit", "--corpus", inp["toy_path"], "--K", "3",
                  "--init", "random", "--max-em-iter", "2", "--out",
                  os.path.join(ctx["dir"], "cli_fit"), "--n-devices", str(ctx["world"])])
        return dict(group_alive=dist.is_initialized())

    return [("mesh_errors", mesh_errors), ("A", gate_A), ("B", gate_B), ("C", gate_C),
            ("D", gate_D), ("E", lambda _: serve(m1)), ("E2", lambda _: serve(m2)),
            ("F", gate_F), ("G", gate_G), ("H", lambda c: resume_case(c, "H")),
            ("H2", lambda c: resume_case(c, "H2", stream_parts=2)),
            ("init_bits", init_bits), ("mstep_vocab", mstep_vocab), ("gram", gram),
            ("select", select), ("cli_fit", cli_fit)]


def main(rank: int, world: int, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
        inputs = pickle.load(f)
    ctx = dict(rank=rank, world=world, dir=out_dir, inputs=inputs,
               toy_kw=inputs["toy_kw"], mesh1=make_mesh(world),
               mesh2=make_mesh_2d(world // 2, 2))
    assert doc_axis(ctx["mesh2"]).size == world // 2
    results = {}
    for name, fn in scenarios(ctx):
        results[name] = fn(ctx)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
