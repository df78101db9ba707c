"""The port's command line (python -m strutopy_tpu_torch.cli) on the CPU
against the JAX package's CLI: the walk synth -> train-eval -> fit ->
find-k, then search-k, select --plot and infer --corpus/--text.  The
synthetic corpora are byte-equal, the artifact sets equal, heldout values
within 1e-3 nats and bounds within 1e-4 relative (tests/test_torch_heldout.py's
tolerances).  The CLI runs in a process where jax cannot be imported.
"""

import contextlib
import io
import json
import os
import pickle
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from strutopy_tpu import cli as jax_cli
from strutopy_tpu_torch import cli
from strutopy_tpu_torch.corpus.io import write_mm
from torch_world import one_thread


@pytest.fixture(autouse=True, scope="module")
def _torch_on_one_thread():
    """torch's CPU ops on one thread for every test of this file and its
    fixtures (tests/torch_world.py::one_thread): under parallel test
    workers a toy fit on torch's default pool waits on busy cores."""
    with one_thread():
        yield


ROOT = Path(__file__).resolve().parents[1]
SYNTH = ["synth", "--K", "3", "--n-corpora", "1", "--n-docs", "40", "--n-words", "50",
         "--V", "150", "--gamma-factors", "1"]


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def _json_tail(text):
    return json.loads(text[text.index("{"):])


@pytest.fixture(scope="module")
def walk(tmp_path_factory):
    """The walk in both packages; each side's outputs by step."""
    root = tmp_path_factory.mktemp("walk")
    res = {}
    for side, main, dev in (("port", cli.main, ["--device", "cpu"]),
                            ("jax", jax_cli.main, ["--platform", "cpu"])):
        d = root / side
        r = res[side] = {"dir": d}
        _run(main, dev + SYNTH + ["--out", str(d / "synth")])
        corpus_dir = d / "synth" / "K3_gf1.0" / "0"
        r["train_eval"] = _run(main, dev + ["train-eval", "--corpus-dir", str(corpus_dir),
                                            "--K", "3", "--max-em-iter", "2", "--fast"])
        with open(corpus_dir / "train_docs.pickle", "rb") as f:
            docs = pickle.load(f)
        with open(d / "corpus.pickle", "wb") as f:
            pickle.dump(docs, f)
        r["docs"] = docs
        r["fit"] = _run(main, dev + ["fit", "--corpus", str(d / "corpus.pickle"), "--K", "3",
                                     "--init", "random", "--model", "CTM", "--max-em-iter", "2",
                                     "--out", str(d / "fit")])
        r["find_k"] = _json_tail(_run(main, dev + [
            "find-k", "--corpus", str(d / "corpus.pickle"), "--K", "3", "4", "--models", "CTM",
            "--max-em-iter", "2", "--fast"]))
    return res


def test_synth_writes_what_the_jax_cli_writes(walk):
    port, jax = walk["port"]["dir"] / "synth", walk["jax"]["dir"] / "synth"
    files = sorted(p.relative_to(port) for p in port.rglob("*") if p.is_file())
    assert len(files) == 8
    assert files == sorted(p.relative_to(jax) for p in jax.rglob("*") if p.is_file())
    for rel in files:
        assert (port / rel).read_bytes() == (jax / rel).read_bytes(), rel


def test_train_eval_heldout_matches_the_jax_cli(walk):
    ll = [float(re.search(r"heldout log-likelihood: (\S+)", walk[s]["train_eval"]).group(1))
          for s in ("port", "jax")]
    assert np.isfinite(ll[0]) and abs(ll[0] - ll[1]) < 1e-3


def test_fit_artifact_set_matches_the_jax_cli(walk):
    port, jax = walk["port"]["dir"] / "fit", walk["jax"]["dir"] / "fit"
    assert sorted(os.listdir(port)) == sorted(os.listdir(jax))
    assert {"beta_hat.npy", "vocab.json", "fit_config.json", "lower_bound.pickle"} <= set(
        os.listdir(port))
    bounds = [pickle.load(open(d / "lower_bound.pickle", "rb")) for d in (port, jax)]
    np.testing.assert_allclose(bounds[0], bounds[1], rtol=1e-4)
    assert f"final bound: {bounds[0][-1]:.2f}" in walk["port"]["fit"]
    cfgs = [json.load(open(d / "fit_config.json")) for d in (port, jax)]
    assert cfgs[0].keys() == cfgs[1].keys()


def test_find_k_matches_the_jax_cli(walk):
    got, want = walk["port"]["find_k"], walk["jax"]["find_k"]
    assert got.keys() == want.keys() == {"CTM"} and got["CTM"].keys() == {"3", "4"}
    for K in ("3", "4"):
        assert abs(got["CTM"][K] - want["CTM"][K]) < 1e-3


def test_search_k_and_select_with_plot(walk, tmp_path):
    corpus = str(walk["port"]["dir"] / "corpus.pickle")
    table = _json_tail(_run(cli.main, ["--device", "cpu", "search-k", "--corpus", corpus,
                                       "--K", "3", "--max-em-iter", "1"]))
    assert set(table["3"]) == {"heldout", "bound", "coherence", "exclusivity", "dispersion",
                               "fit_seconds"}
    plot = tmp_path / "frontier.png"
    out = _json_tail(_run(cli.main, ["--device", "cpu", "select", "--corpus", corpus, "--K", "3",
                                     "--runs", "2", "--cast-iters", "1", "--keep", "1",
                                     "--max-em-iter", "2", "--plot", str(plot)]))
    assert len(out["runs"]) == 2 and len(out["kept"]) == 1 and out["selected"] in out["kept"]
    assert plot.stat().st_size > 0


@pytest.mark.parametrize("source", ["corpus", "mm", "text"])
def test_infer_matches_the_jax_cli(walk, tmp_path, source):
    """infer from the port's saved fit: BoW from a pickle or (native reader)
    a .mm file, or raw text encoded against vocab.json."""
    model_dir = str(walk["port"]["dir"] / "fit")
    docs = walk["port"]["docs"][:6]
    if source == "text":
        vocab = json.load(open(f"{model_dir}/vocab.json"))
        path = tmp_path / "reqs.txt"
        # the fit's vocabulary is numeric ids, which tokenize strips: every
        # request is empty and gets the prior theta, as in the JAX package
        path.write_text(" ".join(vocab[:5]) + "\nword 12 zebra\n")
        args = ["--text", str(path)]
    elif source == "mm":
        path = tmp_path / "docs.mm"
        write_mm(str(path), docs, n_terms=len(json.load(open(f"{model_dir}/vocab.json"))))
        args = ["--corpus", str(path)]
    else:
        path = tmp_path / "docs.pickle"
        path.write_bytes(pickle.dumps(docs))
        args = ["--corpus", str(path)]
    thetas = []
    for main, dev in ((cli.main, ["--device", "cpu"]), (jax_cli.main, ["--platform", "cpu"])):
        out = tmp_path / f"theta_{len(thetas)}.npy"
        printed = _run(main, dev + ["infer", "--model-dir", model_dir, *args, "--out", str(out)])
        thetas.append(np.load(out))
        if source == "text":
            assert json.loads(printed.splitlines()[0]) == {
                "tokens_dropped": 2, "oov_types": 2, "docs_emptied": 1}
    theta, want = thetas
    n = 2 if source == "text" else len(docs)
    assert theta.shape == want.shape == (n, 3)
    np.testing.assert_allclose(theta.sum(1), 1.0, atol=1e-5)
    np.testing.assert_allclose(theta, want, atol=1e-3)


@pytest.mark.parametrize("argv", [["bench"], ["fit", "--corpus", "c.pickle", "--K", "3",
                                              "--out", "x", "--n-devices", "2"]])
def test_bench_and_several_devices_exit_non_zero(argv, monkeypatch):
    """``bench`` runs bench_torch.py by its absolute path with the CLI's
    ``--device`` and exits with the script's code, so a failing script
    gives a non-zero exit, and ``bench --n-devices 2`` exits non-zero
    (bench runs on one device); ``--n-devices 2`` without torchrun's
    environment exits naming torchrun and both counts (the mesh runs
    under torchrun: tests/test_torch_parallel.py)."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    calls = []

    def call(cmd):
        calls.append(cmd)
        return 3

    monkeypatch.setattr(subprocess, "call", call)
    with pytest.raises(SystemExit) as e:
        cli.main(["--device", "cpu"] + argv)
    assert e.value.code not in (0, None)
    if argv[0] == "bench":
        assert e.value.code == 3
        assert calls == [[sys.executable, str(ROOT / "bench_torch.py"), "--device", "cpu"]]
        assert os.path.isabs(calls[0][1])
        with pytest.raises(SystemExit) as e:
            cli.main(["--device", "cpu", "bench", "--n-devices", "2"])
        assert e.value.code not in (0, None) and "one device" in str(e.value.code)
        assert len(calls) == 1
    else:
        msg = str(e.value.code)
        assert "torchrun" in msg and "--n-devices 2" in msg and "world of 1" in msg, msg


NO_JAX = """
import sys
sys.modules["jax"] = None
sys.modules["strutopy_tpu"] = None
from strutopy_tpu_torch.cli import main
d = sys.argv[1]
cpu = ["--device", "cpu"]
main(cpu + {synth} + ["--out", d + "/synth"])
c = d + "/synth/K3_gf1.0/0"
main(cpu + ["train-eval", "--corpus-dir", c, "--K", "3", "--max-em-iter", "1", "--fast"])
corpus = c + "/train_docs.pickle"
main(cpu + ["fit", "--corpus", corpus, "--K", "3", "--init", "random", "--max-em-iter", "1",
            "--out", d + "/fit"])
main(cpu + ["find-k", "--corpus", corpus, "--K", "3", "--max-em-iter", "1", "--fast"])
main(cpu + ["search-k", "--corpus", corpus, "--K", "3", "--max-em-iter", "1"])
main(cpu + ["select", "--corpus", corpus, "--K", "3", "--runs", "2", "--cast-iters", "1",
            "--max-em-iter", "2"])
open(d + "/reqs.txt", "w").write("alpha beta\\n")
main(cpu + ["infer", "--model-dir", d + "/fit", "--text", d + "/reqs.txt", "--out",
            d + "/theta_text.npy"])
main(cpu + ["infer", "--model-dir", d + "/fit", "--corpus", corpus, "--out",
            d + "/theta.npy"])
loaded = sorted(m for m, v in sys.modules.items()
                if v is not None and (m.split(".")[0] in ("jax", "jaxlib", "strutopy_tpu")))
print("JAX MODULES", loaded)
"""


def test_every_subcommand_runs_where_jax_cannot_be_imported(tmp_path):
    code = NO_JAX.format(synth=SYNTH)
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "JAX MODULES []" in out.stdout
    assert np.load(tmp_path / "theta.npy").shape == (32, 3)
    assert np.load(tmp_path / "theta_text.npy").shape == (1, 3)


def test_the_port_imports_nothing_of_jax():
    pattern = re.compile(r"^\s*(import|from) (jax|strutopy_tpu)\b", re.M)
    files = sorted((ROOT / "strutopy_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                                   ROOT / "bench_torch.py"]
    assert len(files) > 40
    assert [str(f) for f in files if pattern.search(f.read_text())] == []
