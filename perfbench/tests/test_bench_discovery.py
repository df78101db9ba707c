"""Cells, configurations, traffic mixes, limits, drivers and per-layer
metrics are found by name; a new one is a new file."""

import json
import shutil

from perfbench import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())


def test_every_cell_loads_with_its_parts():
    for w in BENCH["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.chips == w["chips"]
        assert callable(cell.driver().run)
        readers = cell.readers()
        assert set(readers) == {m["name"] for m in cell.per_layer}
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer
        for m in cell.per_layer:  # each per-layer metric moves one the cell reports
            assert m["moves"] in names


def test_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert (spec.ROOT / "BENCHMARK.json").stat().st_size < 64 * 1024


def test_run_py_names_no_cell_config_or_metric():
    text = (spec.HERE / "run.py").read_text()
    names = [w["name"] for w in BENCH["workloads"]] + [c["name"] for c in BENCH["configs"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"] if m["name"] != "setup_s"]
    names += [w["traffic"] for w in BENCH["workloads"]]
    assert not [n for n in names if n in text]


def test_a_cell_added_as_files_only_is_found(tmp_path):
    here = tmp_path / "perfbench"
    shutil.copytree(spec.HERE, here, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    (here / "configs" / "new_cfg.json").write_text(
        (spec.HERE / "configs" / "stm_k100_v10k.json").read_text())
    bench["configs"].append({"name": "new_cfg", "source": "https://example.org/x",
                             "file": "perfbench/configs/new_cfg.json", "reduced": [],
                             "why": "a copy"})
    (here / "traffic" / "new_mix.json").write_text(
        json.dumps(dict(json.loads((spec.HERE / "traffic" / "em_steady.json").read_text()),
                        warm_iters=7)))
    bench["workloads"].append({"name": "new_cell", "config": "new_cfg", "traffic": "new_mix",
                               "chips": 1, "why": "a copy"})
    (here / "limits" / "new_cell.json").write_text('{"gap_p50": 1e-6}')
    (here / "metrics" / "new_metric.x.py").write_text("def read(ctx):\n    return 42.0\n")
    bench["end_to_end"].append({"name": "new_rate", "unit": "docs/s", "better": "higher",
                                "bound": 0.25, "source": "host_clock", "workloads": ["new_cell"]})
    bench["per_layer"].append({"name": "new_metric.x", "unit": "%", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "new_rate", "workloads": ["new_cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("new_cell", root=tmp_path, here=here)
    assert cell.traffic["warm_iters"] == 7
    assert cell.readers()["new_metric.x"]({}) == 42.0
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "new_rate"}
    assert {m["name"] for m in cell.per_layer} == {"new_metric.x"}
    assert cell.limits == {"gap_p50": 1e-6}
    assert callable(cell.driver().run)
